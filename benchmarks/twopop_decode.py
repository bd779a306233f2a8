"""Two-pop posterior decode at production scale (VERDICT r3 item 7).

The two-pop manager rides the same window kernel, mesh, and decode
machinery as the one-pop path (reference analogue: both populations run
through one parallel HMM, /root/reference/src/inference_manager.cpp:525-550)
— but round 3 only exercised it at ~1e5 windows with a forced kernel.
This benchmark runs the REAL production shape: M = 32 hidden states,
~1e7 windows (1 Gbp at w = 100) of synthetic joint-SFS data, through
`TwoPopInferenceManager` on one chip, and

* times the E-step and the windowed gamma decode at that scale, and
* verifies the decode against the span-kernel f64 oracle on a small
  probe contig carried in the same dataset (same jitted program).

Run:  python benchmarks/twopop_decode.py
Prints one JSON line.
"""

import json
import os
import sys
import time

import numpy as np

N1, A1 = 10, 2   # distinguished pair in pop1
N2, A2 = 8, 0
C = 4
# SMOKE=1: tiny shapes for a CPU correctness pass of this script itself
_SMOKE = os.environ.get("SMOKE") == "1"
WINDOWS = 40_000 if _SMOKE else 2_500_000   # per contig -> 1e7 total
PROBE_ROWS = 500 if _SMOKE else 4000
M = 8 if _SMOKE else 32
W = 100


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_contig(rng, n_windows):
    """Span-compressed 7-col rows (span, a1, b1, nb1, a2, b2, nb2) with the
    post-pipeline mix: mostly short nonpolymorphic runs + dinucleotide
    windows, sparse joint-SFS rows."""
    m = 400_000
    spans_l, rows_l, total = [], [], 0
    while total < n_windows:
        r = rng.random(m)
        spans = np.where(
            r < 0.80,
            rng.geometric(0.45, m),
            np.where(r < 0.97, rng.geometric(0.02, m), 1),
        ).astype(np.int64)
        a1 = np.where(r < 0.97, rng.integers(0, 2, m), rng.integers(0, 3, m))
        b1 = np.where(r < 0.97, 0, rng.integers(0, N1 + 1, m))
        b2 = np.where(r < 0.97, 0, rng.integers(0, N2 + 1, m))
        cs = np.cumsum(spans)
        take = min(int(np.searchsorted(cs, n_windows - total) + 1), m)
        spans = spans[:take]
        over = int(spans.sum()) - (n_windows - total)
        if over > 0:
            spans[-1] -= over
        rows = np.empty((take, 7), np.int64)
        rows[:, 0] = spans
        rows[:, 1] = a1[:take]
        rows[:, 2] = b1[:take]
        rows[:, 3] = N1
        rows[:, 4] = -1  # no distinguished lineage in pop2 (a2 = 0)
        rows[:, 5] = b2[:take]
        rows[:, 6] = N2
        total += int(spans.sum())
        keep = rows[:, 0] > 0
        rows_l.append(rows[keep])
    return np.concatenate(rows_l, axis=0)


def build_manager(with_probe=True):
    """Synth the production-shape dataset and build the manager.
    Returns (im, windows, probe_rows) — also reused by bench.py's
    driver-captured two-pop metric."""
    import smcpp_jax  # noqa: F401
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import TwoPopInferenceManager
    from smcpp_jax.models import SMCModel, SMCTwoPopulationModel

    rng = np.random.default_rng(0)
    data = [synth_contig(rng, WINDOWS) for _ in range(C)]
    probes = []
    if with_probe:
        # small probe contigs: cheap span-kernel f64 oracle targets
        # (3 independent draws — VERDICT r4 next-5: one probe was a
        # single point estimate of the error distribution)
        probes = [
            synth_contig(rng, 60_000)[:PROBE_ROWS] for _ in range(3)
        ]
        data.extend(probes)
    windows = float(sum(d[:, 0].sum() for d in data))

    m1 = SMCModel(np.logspace(-2, np.log10(3.0), 8), 20000.0, "pchip",
                  pid="pop1")
    m1.y[:] = np.sin(np.linspace(0, 3.0, len(m1.y))) * 0.5
    m2 = SMCModel(np.logspace(-2, np.log10(3.0), 8), 20000.0, "pchip",
                  pid="pop2")
    m2.y[:] = 0.2
    jm = SMCTwoPopulationModel(m1, m2, 0.25)
    hs = estimation.balance_hidden_states(m1, M + 1)

    t0 = time.time()
    im = TwoPopInferenceManager(
        N1, N2, A1, A2, data, hs, ("pop1", "pop2"), 0.5
    )
    im.set_model(jm)
    im.theta = 1e-4
    im.alpha = W
    im.rho = 1e-4 / 4 * W
    _log(f"manager: kernel={'window' if im._use_windows else 'span'}, "
         f"{im.em_idx.n_keys} keys, {len(data)} contigs, "
         f"{windows:.0f} windows, build {time.time()-t0:.0f} s")
    assert im._use_windows, "cost model must pick windows at this scale"
    return im, windows, probes


def measure_estep(im, reps=3):
    "Warm + median E-step wall.  Returns (estep_s, warmup_s, loglik)."
    t0 = time.time()
    ll = im.E_step()
    t_warm = time.time() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        im.E_step()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), t_warm, float(ll)


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from smcpp_jax.ops import hmm

    im, windows, probes = build_manager()
    total_bases = windows * W
    t_e, t_warm, ll = measure_estep(im)

    im.save_gamma = True
    t0 = time.perf_counter()
    im.E_step()
    t_decode_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    im.E_step()
    t_decode = time.perf_counter() - t0

    # kernel-only decode timing (excludes the (n_rows, 32) host pull)
    pi_d, T_d, E_d = (
        jax.device_put(jnp.asarray(np.asarray(x), im._estep_dtype),
                       im._device)
        for x in im.tensors()
    )
    o = im._wdecode_fn(pi_d, T_d, E_d, im._wkeys, im._wvalid, im._wrow_ids)
    jax.block_until_ready(o)
    t0 = time.perf_counter()
    o = im._wdecode_fn(pi_d, T_d, E_d, im._wkeys, im._wvalid, im._wrow_ids)
    jax.block_until_ready(o)
    t_decode_kernel = time.perf_counter() - t0

    # oracle check on the probe contigs: span-kernel f64 row gammas.
    # Runs on the CPU backend — the oracle is tiny.
    # The timed decode above used the production default f16 transfer;
    # re-pull exact f32 here so the decomposition measures the KERNEL,
    # not the (separately bounded) transfer rounding.
    os.environ["SMCPP_JAX_DECODE_TRANSFER"] = "f32"
    im.E_step()
    cpu = jax.local_devices(backend="cpu")[0]
    pi, T, E = (np.asarray(x, np.float64) for x in im.tensors())
    span_refs = []
    for ci in range(-len(probes), 0):
        with jax.default_device(cpu):
            ref = np.asarray(
                hmm.posterior_gammas(
                    jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
                    jnp.asarray(np.asarray(im._spans[ci])),
                    jnp.asarray(np.asarray(im._keys[ci])),
                    im._nbits, im._chunk,
                )
            )
        reps = im._row_reps[ci]
        nsub = int(reps.sum())
        offs = np.concatenate([[0], np.cumsum(reps)[:-1]])
        span_refs.append(np.add.reduceat(ref[:nsub], offs, axis=0))

    # decomposition (VERDICT r4 next-5): run the SAME window decode at
    # f64 on a probe-only manager — err(f32 vs span-f64) splits into the
    # algorithmic window-vs-span difference (expected ~fp-level) and the
    # pure f32-accumulation part
    from smcpp_jax.inference.manager import TwoPopInferenceManager

    im64 = TwoPopInferenceManager(
        N1, N2, A1, A2, list(probes), im.hidden_states,
        ("pop1", "pop2"), 0.5,
        estep_dtype=jnp.float64, compute_device=cpu,
    )
    if not im64._use_windows:
        im64._use_windows = True
        im64._estep_fn = im64._build_estep_fn()
    im64.set_model(im.model)
    im64.theta, im64.alpha, im64.rho = im.theta, im.alpha, im.rho
    im64.save_gamma = True
    im64.E_step()

    e_total = e_prec = e_alg = 0.0
    for k, ci in enumerate(range(-len(probes), 0)):
        g32 = im.gammas[ci]
        g64 = im64.gammas[k]
        ref_rows = span_refs[k]
        den = np.maximum(np.abs(ref_rows), 1e-2)
        e_total = max(e_total, float(np.max(np.abs(g32 - ref_rows) / den)))
        e_prec = max(e_prec, float(np.max(np.abs(g32 - g64) / den)))
        e_alg = max(e_alg, float(np.max(np.abs(g64 - ref_rows) / den)))
        np.testing.assert_allclose(
            g32.sum(axis=1), probes[k][: len(g32), 0], rtol=1e-3
        )
    _log(f"probe oracle ({len(probes)} contigs): f32-vs-span {e_total:.2e} "
         f"= precision {e_prec:.2e} + algorithmic {e_alg:.2e}")
    assert e_total < 5e-2, e_total
    assert e_alg < 2e-3, e_alg  # window == span up to fp at f64

    print(json.dumps({
        "metric": "twopop_decode",
        "M": M,
        "windows": int(windows),
        "total_gbp": round(total_bases / 1e9, 2),
        "n_keys": int(im.em_idx.n_keys),
        "estep_s": round(t_e, 3),
        "estep_gbps": round(total_bases / t_e / 1e9, 2),
        "decode_kernel_s": round(t_decode_kernel, 3),
        "decode_kernel_gbps": round(total_bases / t_decode_kernel / 1e9, 2),
        "decode_wall_s": round(t_decode, 2),
        "decode_warmup_s": round(t_decode_warm, 1),
        "estep_warmup_s": round(t_warm, 1),
        "loglik": float(ll),
        "probe_oracle_max_rel_err": float(e_total),
        "probe_err_precision": float(e_prec),
        "probe_err_algorithmic": float(e_alg),
        "n_probes": len(probes),
    }))


if __name__ == "__main__":
    main()
