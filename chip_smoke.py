"""Smoke run of the SMC++ main path on one NVIDIA GPU.

    python chip_smoke.py           # the phases below, on one card
    python chip_smoke.py --four    # only the 4-card mesh phase

Phases, in order, in one process (a failing phase fails the script):

device       JAX's first device must be a GPU; prints its kind, the device
             count, JAX's version, the memory JAX may allocate, and the
             card's name and power limit from nvidia-smi.
cli_small    a seeded 1 Mbp VCF (10 diploids, two populations) through the
             CLI: vcf2smc for each population and jointly, estimate
             --em-iterations 2 for each, posterior, split
             --em-iterations 1.  Outputs must exist and be finite, and
             every E-step must run on the GPU.
estimate_c3  the C3 deployment: n = 50 undistinguished haplotypes,
             --knots 8 (M = 17: 2k quantile states + 1), w = 100, through
             estimate --em-iterations 2: the log-likelihood must be finite
             and must not decrease; then posterior (default M = 32) on one
             contig, whose per-position posterior masses must sum to
             1 +- 1e-3.  Prints E-step and EM-iteration smoke timings.
parity       the manager's E-step on the card at every precision rung
             against f64 references on the host CPU (estep_windows and the
             span kernel of ops/hmm.py) on the same f32-valued pi, T, E:
             one population at M = 16 with the n = 50 key table on a
             25 Mbp slice of the C3 data, two populations at M = 32 on a
             10 Mbp joint slice, both binned as estimate bins them.
             Tolerances in PARITY_TOL.
sweeps       the Pallas statistic-sweep kernel against stats_pass's XLA
             sweeps at C3 widths (22 x 250 Mbp of synthetic binned rows:
             S = 6732 segments of L = 8192 windows, 128 keys) at M = 16
             and M = 17: 'highest' parity at rtol 1e-5, the 'default'
             envelope, then the median of 5 timed calls after warm-up of
             the sweeps and of estep_direct through each.

--four runs the manager's ('data',) mesh E-step on 4 cards against 1 card
on the same data at 'highest' (LL rtol 1e-6, statistics 1e-5), then
`estimate --devices 4 --em-iterations 1`.

Cuts from the C3 deployment (22 contigs x 250 Mbp): estimate_c3 runs
4 x 250 Mbp (1 Gbp) of data simulated from the model's own generative HMM
(data/simulate.py; msprime is not a dependency), and its posterior decodes
the first 100 Mbp of one contig.  --four runs 4 x 25 Mbp.

Times printed are smoke timings, with the card's name and power limit
beside them, not a benchmark.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

C3_N = 50
C3_KNOTS = 8
C3_W = 100
C3_CONTIGS = 4
C3_LENGTH = 250_000_000
POSTERIOR_END = 100_000_000
TWOPOP_LENGTH = 10_000_000


def log(*a):
    print("chip_smoke:", *a, flush=True)


def card_line():
    "nvidia-smi's name and power limit, read by a child that stays off JAX."
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


class EStepProbe:
    """Records (platform, hidden states, seconds) for every manager E-step
    (each ends in a blocking device->host fetch of its statistics)."""

    def __init__(self):
        from smcpp_jax.inference import manager

        self._classes = (manager.OnePopInferenceManager,
                         manager.TwoPopInferenceManager)
        self.calls = []

    def __enter__(self):
        self._orig = [c.E_step for c in self._classes]
        probe = self

        def wrap(orig):
            def E_step(im):
                t0 = time.perf_counter()
                out = orig(im)
                probe.calls.append((im._device.platform,
                                    len(im.hidden_states) - 1,
                                    getattr(im, "sweep", None),
                                    time.perf_counter() - t0))
                return out
            return E_step

        for c, f in zip(self._classes, self._orig):
            c.E_step = wrap(f)
        return self

    def __exit__(self, *exc):
        for c, f in zip(self._classes, self._orig):
            c.E_step = f

    def check_gpu(self):
        plats = {c[0] for c in self.calls}
        if plats != {"gpu"}:
            raise AssertionError(f"E-steps ran on {plats}, not the GPU")


class LoglikRecords(logging.Handler):
    "Collects the optimizer's per-iteration log-likelihood records."

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(("Loglik:", "New loglik:")):
            ll = float(msg.split(":")[1].split()[0])
            self.records.append((record.created, msg.startswith("Loglik"), ll))

    def last_fit(self):
        "(timestamps, logliks) of the last optimizer run."
        start = max(i for i, r in enumerate(self.records) if r[1])
        rs = self.records[start:]
        return [r[0] for r in rs], [r[2] for r in rs]


def finite_model(path):
    with open(path) as f:
        d = json.load(f)
    m = d["model"]
    vals = [np.asarray(m[k], float) for k in ("y",) if k in m]
    for sub in ("model1", "model2"):
        if sub in m:
            vals.append(np.asarray(m[sub]["y"], float))
    if not vals or not all(np.all(np.isfinite(v)) for v in vals):
        raise AssertionError(f"{path}: non-finite or missing model values")
    return d


def check_posterior(npz, key, tol):
    z = np.load(npz)
    g = z[key]
    if not np.all(np.isfinite(g)):
        raise AssertionError(f"{npz}: non-finite gammas")
    err = float(np.abs(g.sum(axis=0) - 1.0).max())
    if err > tol:
        raise AssertionError(f"{npz}: posterior mass off by {err:g}")
    return g.shape, err


# ---------------------------------------------------------------- phases

def phase_device():
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX's first device is "
            f"{d.platform} ({d.device_kind})"
        )
    stats = d.memory_stats() or {}
    log(f"device kind={d.device_kind} count={len(devs)} "
        f"jax={jax.__version__} bytes_limit={stats.get('bytes_limit')}")
    card = card_line()
    print(card, flush=True)  # nvidia-smi's own line: name, power limit
    return d, card


def phase_cli_small(work):
    from smcpp_jax.commands.main import main
    from smcpp_jax.data.simulate import write_example_vcf

    vcf = write_example_vcf(os.path.join(work, "example.vcf.gz"))
    pop1 = "pop1:" + ",".join(f"msp_{i}" for i in range(5))
    pop2 = "pop2:" + ",".join(f"msp_{i}" for i in range(5, 10))
    p1, p2, p12 = (os.path.join(work, f) for f in
                   ("p1.smc.gz", "p2.smc.gz", "p12.smc.gz"))
    main(["vcf2smc", vcf, p1, "1", pop1])
    main(["vcf2smc", vcf, p2, "1", pop2])
    main(["vcf2smc", vcf, p12, "1", pop1, pop2])
    with EStepProbe() as probe:
        fits = []
        for name, fn in (("fit1", p1), ("fit2", p2)):
            out = os.path.join(work, name)
            main(["estimate", "--devices", "1", "--em-iterations", "2",
                  "-o", out, "1.25e-8", fn])
            fits.append(os.path.join(out, "model.final.json"))
            finite_model(fits[-1])
        post = os.path.join(work, "post_small.npz")
        main(["posterior", "--devices", "1", fits[0], post, p1])
        shape, err = check_posterior(post, p1, 1e-3)
        out = os.path.join(work, "split")
        main(["split", "--devices", "1", "--em-iterations", "1", "-o", out,
              fits[0], fits[1], p12])
        d = finite_model(os.path.join(out, "model.final.json"))
    probe.check_gpu()
    sweeps = sorted({str(c[2]) for c in probe.calls if c[1] > 1})
    log(f"cli_small: {len(probe.calls)} E-steps on the GPU (sweeps "
        f"{sweeps}); posterior {shape} mass err {err:.2e}; split "
        f"{d['model']['split']:.4g}")


def c3_model():
    from smcpp_jax.models import SMCModel

    m = SMCModel(np.logspace(-2, np.log10(3.0), 8), 20000.0, "pchip")
    m.y[:] = np.sin(np.linspace(0, 3.0, len(m.y))) * 0.7
    return m


def write_c3_data(work, n_contigs, length):
    "Simulated n = 50 contigs in SMC++ format (theta = 1e-4, rho = theta/4)."
    from smcpp_jax.data import format as fmt
    from smcpp_jax.data.simulate import simulate_contig

    m = c3_model()
    files, rows = [], []
    for i in range(n_contigs):
        d = simulate_contig(m, 1e-4, 1e-4 / 4, length, C3_N, seed=i, M=24)
        fn = os.path.join(work, f"c3_{i}.smc.gz")
        fmt.write_contig(fn, d, ["pop1"], [[["sim", 0], ["sim", 1]]],
                         [[["sim_u", j] for j in range(C3_N)]])
        files.append(fn)
        rows.append(d)
    return files, rows


def phase_estimate_c3(work, card):
    from smcpp_jax.commands.main import main

    t0 = time.perf_counter()
    files, rows = write_c3_data(work, C3_CONTIGS, C3_LENGTH)
    log(f"estimate_c3: simulated and wrote {C3_CONTIGS} x {C3_LENGTH:.3g} bp "
        f"in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "fit_c3")
    lls = LoglikRecords()
    opt_log = logging.getLogger("smcpp_jax.inference.optimizer")
    opt_log.addHandler(lls)
    t0 = time.perf_counter()
    try:
        with EStepProbe() as probe:
            main(["estimate", "--devices", "1", "--em-iterations", "2",
                  "--knots", str(C3_KNOTS), "-w", str(C3_W), "-o", out,
                  "1.25e-8", *files])
    finally:
        opt_log.removeHandler(lls)
    wall = time.perf_counter() - t0
    probe.check_gpu()
    finite_model(os.path.join(out, "model.final.json"))
    ts, ll = lls.last_fit()
    if not np.all(np.isfinite(ll)) or len(ll) < 2:
        raise AssertionError(f"stage-2 log-likelihoods {ll}")
    from smcpp_jax import defaults

    # the optimizer's own notion of a decrease (its convergence tolerance)
    if ll[-1] < ll[-2] - defaults.ftol * abs(ll[-2]):
        raise AssertionError(f"log-likelihood decreased: {ll}")
    M = max(c[1] for c in probe.calls)
    st2 = [c for c in probe.calls if c[1] == M]
    warm = [c[3] for c in st2[1:]]
    log(f"estimate_c3: wall {wall:.1f} s; stage-2 loglik {ll}; "
        f"{len(st2)} E-steps at M={M} (sweeps {st2[-1][2]})")
    log(f"estimate_c3 smoke timings [{card}]: E-step (warm, median of "
        f"{len(warm)}) {np.median(warm):.4f} s, first E-step incl. compile "
        f"{st2[0][3]:.2f} s, EM iteration {np.diff(ts).tolist()} s")
    post = os.path.join(work, "post_c3.npz")
    t0 = time.perf_counter()
    with EStepProbe() as probe:
        main(["posterior", "--devices", "1", "--end", str(POSTERIOR_END),
              os.path.join(out, "model.final.json"), post, files[0]])
    probe.check_gpu()
    shape, err = check_posterior(post, files[0], 1e-3)
    log(f"estimate_c3: posterior M=32 on {POSTERIOR_END:.3g} bp of contig 0: "
        f"gammas {shape}, max |mass - 1| {err:.2e}, wall "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return rows


def bin_like_estimate(rows, n, a=(2,), pid=("pop1",)):
    "The estimate command's data pipeline up to its binned stage-2 rows."
    from smcpp_jax.contig import Contig
    from smcpp_jax.data import filters as ft

    n = np.atleast_1d(n)
    res = [Contig(data=d, pid=pid, fn=f"c{i}", n=n, a=list(a))
           for i, d in enumerate(rows)]
    for f in (ft.RecodeNonseg(cutoff=None), ft.Compress(),
              ft.BreakLongSpans(cutoff=100000),
              ft.Thin(thinning=int(500 * np.log(2 + n.sum()))),
              ft.BinObservations(w=C3_W), ft.RecodeMonomorphic(),
              ft.Compress(), ft.Validate()):
        res = f(res)
    return [c.data for c in res]


def head_bases(d, length):
    "Leading rows of a contig covering ``length`` bases."
    return d[: int(np.searchsorted(np.cumsum(d[:, 0]), length)) + 1]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def parity_one(im, label):
    """The manager's production E-step on the card at every precision rung
    vs f64 estep_windows and the f64 span kernel on the host CPU, all on
    the same (f32-valued) pi, T, E: these models are ill-conditioned
    enough that rounding the inputs to f32 alone moves the statistics by
    ~1e-3, which is not the card's error."""
    import jax
    import jax.numpy as jnp

    from smcpp_jax.inference.manager import PRECISION_LADDER, _cpu_device
    from smcpp_jax.ops import hmm, window_kernel as wk

    cpu = _cpu_device()
    pi, T, E = (np.asarray(np.asarray(x, np.float32), np.float64)
                for x in im.tensors())
    keys = np.asarray(im._wkeys)
    valid = np.asarray(im._wvalid)
    ref_w = jax.jit(
        lambda *a: wk.estep_windows(*a, im._soc, precision="highest"),
        device=cpu,
    )(pi, T, E, keys, valid)
    ref_s = jax.jit(
        lambda *a: hmm.estep(*a, nbits=im._nbits, chunk=im._chunk),
        device=cpu,
    )(pi, T, E, np.asarray(im._spans), np.asarray(im._keys))
    ref_w = [np.asarray(x, np.float64) for x in ref_w]
    ref_s = [np.asarray(x, np.float64) for x in ref_s]
    agree = max(abs(ref_w[0] - ref_s[0]) / abs(ref_s[0]),
                *(_rel(a, b) for a, b in zip(ref_w[1:], ref_s[1:])))
    if agree > 1e-8:
        raise AssertionError(f"{label}: f64 references disagree ({agree:g})")
    args = [jax.device_put(jnp.asarray(x, jnp.float32), im._device)
            for x in (pi, T, E)]
    for p in PRECISION_LADDER:
        im._precision = p
        fn = im._build_estep_fn()
        out = [np.asarray(x, np.float64) for x in jax.device_get(
            fn(*args, im._wkeys, im._wvalid))]
        lle = abs(out[0] - ref_w[0]) / abs(ref_w[0])
        se = max(_rel(out[2], ref_w[2]), _rel(out[3], ref_w[3]))
        pe = _rel(out[1], ref_w[1])
        log(f"parity {label} [{p}, sweeps={im.sweep}]: rel LL {lle:.3e}, "
            f"xisum/gamma_sums {se:.3e}, pi-stat {pe:.3e} (vs f64; span "
            f"and window references agree to {agree:.1e})")
        lim_ll, lim_st = PARITY_TOL[p]
        if not (lle <= lim_ll and se <= lim_st and pe <= lim_st):
            raise AssertionError(
                f"parity {label} [{p}] outside rel LL {lim_ll:g} / "
                f"statistics {lim_st:g}"
            )


# precision rung -> (relative log-likelihood, statistics: max |diff| over
# max |ref| per array), against f64 on the same inputs.  Measured on an
# H100 80GB HBM3, one-pop / two-pop slice:
#   highest        exact f32: LL 5.0e-7 / 7.6e-7, statistics 9.2e-5 /
#                  2.1e-4 (f32 rounding carried along a slowly mixing
#                  chain; 3.3e-5 / 1.1e-4 on a CPU, whose dots are exact)
#   tensorfloat32  TF32 dots: LL 3.2e-4 / 4.9e-5, statistics 0.19 / 0.26
#                  (T rounded to 10 mantissa bits inside every dot)
#   default        TF32 dots + bf16 alpha stream: LL the same, statistics
#                  0.20 / 0.28
# 1e-3 is the LL requirement on the low rungs; their statistic bound is
# twice the measured envelope (see ROADMAP A5).
PARITY_TOL = {
    "highest": (1e-6, 4e-4),
    "tensorfloat32": (1e-3, 0.6),
    "default": (1e-3, 0.6),
}


def phase_parity(c3_rows):
    from smcpp_jax.data.simulate import simulate_joint_contig
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import (
        OnePopInferenceManager, TwoPopInferenceManager,
    )
    from smcpp_jax.models import SMCModel, SMCTwoPopulationModel

    m = c3_model()
    data = bin_like_estimate([head_bases(c3_rows[0], 25_000_000)], C3_N)
    im = OnePopInferenceManager(
        C3_N, data, estimation.balance_hidden_states(m, 2 * C3_KNOTS + 1),
        ("pop1",), 0.5,
    )
    im.set_model(m)
    im.theta, im.rho, im.alpha = 1e-4, 1e-4 / 4 * C3_W, C3_W
    log(f"parity one-pop: M=16, {im.em_idx.n_keys} keys, windows "
        f"{tuple(im._wkeys.shape)}")
    parity_one(im, "one-pop M=16")

    knots = np.logspace(-2, np.log10(3.0), 8)
    m1 = SMCModel(knots, 20000.0, "pchip", "pop1")
    m1.y[:] = np.sin(np.linspace(0, 3.0, len(m1.y))) * 0.5
    m2 = SMCModel(knots, 20000.0, "pchip", "pop2")
    m2.y[:] = 0.2
    jm = SMCTwoPopulationModel(m1, m2, 0.25)
    n1, n2 = 8, 8
    rows = simulate_joint_contig(jm, 1e-4, 1e-4 / 4, TWOPOP_LENGTH, n1, n2)
    data = bin_like_estimate([rows], [n1, n2], (2, 0), ("pop1", "pop2"))
    im2 = TwoPopInferenceManager(
        n1, n2, 2, 0, data, estimation.balance_hidden_states(m1, 33),
        ("pop1", "pop2"), 0.5,
    )
    im2.set_model(jm)
    im2.theta, im2.rho, im2.alpha = 1e-4, 1e-4 / 4 * C3_W, C3_W
    if not im2._use_windows:
        raise AssertionError("two-pop slice did not take the window kernel")
    log(f"parity two-pop: M=32, {im2.em_idx.n_keys} keys, windows "
        f"{tuple(im2._wkeys.shape)}")
    parity_one(im2, "two-pop M=32")


def c3_synthetic_windows(contigs, windows, M=16):
    "bench-style synthetic binned rows: ``contigs`` x ``windows`` at w=100."
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench import synth_contig
    from smcpp_jax.ops import window_kernel as wk

    rng = np.random.default_rng(0)
    n_keys = 128
    raw = [synth_contig(rng, windows, n_keys, 3) for _ in range(contigs)]
    keys, valid, soc = wk.pack_windows(
        raw, {(k,): k for k in range(n_keys)}, seg_target=8192,
    )
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M) * 40, size=M) + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))
    return pi, T, E, keys, valid, soc


def timed(fn, *args, n=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_sweeps(dev, card, contigs=22, windows=2_500_000):
    import jax
    import jax.numpy as jnp
    from functools import partial

    from smcpp_jax.ops import window_kernel as wk

    stats = jax.jit(wk.stats_pass, static_argnames=("precision", "sweep"))

    @partial(jax.jit, static_argnames="soc")
    def boundaries(pi, T, E, k, v, soc):
        "Exact-f32 boundary vectors: the sweeps' common input."
        ops, logs = wk.segment_operators(T, E, k, v, "highest")
        _, A_in, Q_end, _ = wk.contig_boundaries(
            pi, ops, logs, np.asarray(soc), jnp.any(v, axis=1))
        return A_in, Q_end

    # M = 16: the C3 bench width; M = 17: estimate --knots 8 (2k + 1
    # intervals), which the kernel pads to 32 states
    for M in (16, 17):
        pi, T, E, keys, valid, soc = c3_synthetic_windows(contigs, windows, M)
        S, L = keys.shape
        n_keys = E.shape[0]
        chosen = wk.choose_sweep(dev.platform, S, L, M, n_keys)
        log(f"sweeps M={M}: S={S} L={L} keys={n_keys}; choose_sweep -> "
            f"{chosen}")
        if chosen != "pallas":
            raise AssertionError("the GPU did not choose the sweep kernel")
        put = lambda x, dt=None: jax.device_put(  # noqa: E731
            jnp.asarray(x, dt), dev)
        pi_d, T_d, E_d = (put(x, jnp.float32) for x in (pi, T, E))
        k_d, v_d = put(keys), put(valid)
        socs = tuple(map(tuple, soc))
        A_in, Q_end = boundaries(pi_d, T_d, E_d, k_d, v_d, socs)
        res = {}
        for p in ("highest", "default"):
            for sw in ("xla", "pallas"):
                out = stats(T_d, E_d, k_d, v_d, A_in, Q_end, precision=p,
                            sweep=sw)
                res[p, sw] = [np.asarray(x, np.float64)
                              for x in jax.device_get(out)]
        hi_x, hi_p = res["highest", "xla"], res["highest", "pallas"]
        for name, a, b in zip(("alpha_end", "u_start", "xo", "gsum"),
                              hi_p, hi_x):
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                err_msg=f"pallas vs XLA sweeps at 'highest': {name}",
            )
        d_p = res["default", "pallas"]
        env = [_rel(d_p[i], hi_x[i]) for i in (2, 3)]
        mass = abs(d_p[3].sum() - valid.sum()) / valid.sum()
        log(f"sweeps M={M} parity: 'highest' pallas vs XLA max rel "
            f"{max(_rel(a, b) for a, b in zip(hi_p, hi_x)):.2e} (rtol "
            f"1e-5); 'default' pallas vs XLA-highest xo/gsum "
            f"{env[0]:.2e}/{env[1]:.2e} (<= 5e-2), summed gsum vs valid "
            f"windows {mass:.2e} (<= 1e-5)")
        if max(env) > 5e-2 or mass > 1e-5:
            raise AssertionError("default-precision sweep envelope exceeded")

        t_st = {sw: timed(lambda *a, sw=sw: stats(*a, precision="default",
                                                   sweep=sw),
                          T_d, E_d, k_d, v_d, A_in, Q_end)
                for sw in ("xla", "pallas")}
        t_es = {
            sw: timed(jax.jit(partial(wk.estep_direct, seg_of_contig=soc,
                                      precision="default", sweep=sw)),
                      pi_d, T_d, E_d, k_d, v_d)
            for sw in ("xla", "pallas")
        }
        log(f"sweeps M={M} smoke timings [{card}] at 'default', median of "
            f"5: stat sweeps XLA {t_st['xla']:.4f} s, Pallas "
            f"{t_st['pallas']:.4f} s; estep_direct XLA {t_es['xla']:.4f} s, "
            f"Pallas {t_es['pallas']:.4f} s")


def phase_four(work, card, devs):
    from smcpp_jax.commands.main import main
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import OnePopInferenceManager

    if len(devs) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, found {devs}")
    files, rows = write_c3_data(work, 4, 25_000_000)
    data = bin_like_estimate(rows, C3_N)
    m = c3_model()
    hs = estimation.balance_hidden_states(m, 2 * C3_KNOTS + 1)
    outs = {}
    for nd in (1, 4):
        im = OnePopInferenceManager(C3_N, data, hs, ("pop1",), 0.5,
                                    devices=devs[:nd], precision="highest")
        im.set_model(m)
        im.theta, im.rho, im.alpha = 1e-4, 1e-4 / 4 * C3_W, C3_W
        ll = im.E_step()
        t = timed(lambda: im.E_step(), n=3)
        outs[nd] = (ll, im._stats, t, im.sweep)
    (ll1, st1, t1, sw1), (ll4, st4, t4, sw4) = outs[1], outs[4]
    lle = abs(ll4 - ll1) / abs(ll1)
    se = max(_rel(a, b) for a, b in zip(st4, st1))
    log(f"four: mesh E-step on 4 cards vs 1 at 'highest': rel LL {lle:.2e} "
        f"(<= 1e-6), statistics {se:.2e} (<= 1e-5); sweeps {sw1}/{sw4}")
    log(f"four smoke timings [{card}]: manager E-step 1 card {t1:.4f} s, "
        f"4 cards {t4:.4f} s (median of 3, {len(data)} x 25 Mbp binned)")
    if lle > 1e-6 or se > 1e-5:
        raise AssertionError("4-card E-step disagrees with 1 card")
    t0 = time.perf_counter()
    out = os.path.join(work, "fit4")
    main(["estimate", "--devices", "4", "--em-iterations", "1",
          "--knots", str(C3_KNOTS), "-o", out, "1.25e-8", *files])
    finite_model(os.path.join(out, "model.final.json"))
    log(f"four: estimate --devices 4 --em-iterations 1 wall "
        f"{time.perf_counter() - t0:.1f} s [{card}]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)
    import smcpp_jax  # noqa: F401  (x64, compile cache)
    import jax

    t_all = time.perf_counter()
    dev, card = phase_device()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            phases = [("four", lambda: phase_four(work, card,
                                                  jax.devices()))]
        else:
            state = {}
            phases = [
                ("cli_small", lambda: phase_cli_small(work)),
                ("estimate_c3", lambda: state.update(
                    rows=phase_estimate_c3(work, card))),
                ("parity", lambda: phase_parity(state["rows"])),
                ("sweeps", lambda: phase_sweeps(dev, card)),
            ]
        for name, run in phases:
            t0 = time.perf_counter()
            run()
            log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
        from smcpp_jax.inference import progcache

        log(f"export cache {progcache.STATS}; total "
            f"{time.perf_counter() - t_all:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
