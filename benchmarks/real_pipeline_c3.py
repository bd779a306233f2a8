"""C3-scale real-pipeline benchmark (VERDICT r2 item 5 + decode number).

bench.py's headline number runs on a synthetic stream whose row statistics
were matched to real data by construction.  This benchmark closes the loop
at full C3 scale: simulate n=50 x 22 x 250 Mbp contigs from the model's own
generative HMM, push them through the REAL stage-2 filter stack
(RecodeNonseg -> Compress -> BreakLongSpans -> Thin -> Bin(100) ->
RecodeMonomorphic -> Compress -> Validate), and measure on one chip:

* `estep_direct` Gbp/s through the real InferenceManager on the real
  key/span distribution (to be compared against bench.py's synthetic
  number), and
* posterior decode throughput (`save_gamma` batched decode + Viterbi),
  the VERDICT r2 item-1 deliverable.

Two phases:

  # host-only prep (cached in the checkout):
  JAX_PLATFORMS=cpu python benchmarks/real_pipeline_c3.py --prep
  # measurement, on the card:
  python benchmarks/real_pipeline_c3.py --run

Prints one JSON object per phase.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache",
    "bench", "c3_contigs.npz",
)
N = 50
C = 22
LBP = 250_000_000
W = 100


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def prep():
    import smcpp_jax  # noqa: F401
    from smcpp_jax.contig import Contig
    from smcpp_jax.data import filters as ft
    from smcpp_jax.data.simulate import simulate_contig
    from smcpp_jax.models import SMCModel

    m = SMCModel(np.logspace(-2, np.log10(3.0), 8), 20000.0, "pchip")
    # sawtooth-ish history so the hidden path actually mixes
    m.y[:] = np.sin(np.linspace(0, 3.0, len(m.y))) * 0.7
    theta, rho = 1e-4, 1e-4 / 4

    t0 = time.time()
    contigs = []
    for i in range(C):
        d = simulate_contig(m, theta, rho, LBP, N, seed=i, M=24)
        contigs.append(
            Contig(data=d, pid=("pop1",), fn=f"sim{i}", n=[N], a=[2])
        )
        _log(f"simulated contig {i}: {len(d)} rows, "
             f"{time.time() - t0:.0f} s elapsed")
    t_sim = time.time() - t0

    t0 = time.time()
    pipeline = [
        ft.RecodeNonseg(cutoff=50000),
        ft.Compress(),
        ft.BreakLongSpans(cutoff=100000),
        ft.Thin(thinning=int(500 * np.log(2 + N))),
        ft.BinObservations(w=W),
        ft.RecodeMonomorphic(),
        ft.Compress(),
        ft.Validate(),
    ]
    res = contigs
    for f in pipeline:
        res = f(res)
        _log(f"filter {type(f).__name__}: {sum(len(c.data) for c in res)} rows")
    t_filter = time.time() - t0

    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    np.savez_compressed(
        CACHE, **{f"c{i}": c.data for i, c in enumerate(res)},
        n_contigs=len(res),
    )
    out = {
        "phase": "prep",
        "contigs": len(res),
        "rows": int(sum(len(c.data) for c in res)),
        "windows": int(sum(c.data[:, 0].sum() for c in res)),
        "sim_s": round(t_sim, 1),
        "filter_s": round(t_filter, 1),
        "cache": CACHE,
    }
    print(json.dumps(out))


def measure(em_iterations=2, decode=True, max_contigs=None):
    """Measure the real-pipeline C3 numbers on the default device.

    Importable (bench.py folds the result into the driver-captured JSON
    line — VERDICT r3 "what's weak" 1: these numbers were previously
    builder-reported prose only).  Requires the cached prep data; returns a
    flat dict of timings.  ``max_contigs`` subsets the cached data (CPU
    smoke tests of this script itself)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import smcpp_jax  # noqa: F401
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.models import SMCModel

    z = np.load(CACHE)
    nc = int(z["n_contigs"])
    if max_contigs:
        nc = min(nc, int(max_contigs))
    data = [z[f"c{i}"] for i in range(nc)]
    windows = sum(d[:, 0].sum() for d in data)
    total_bases = float(windows) * W  # each window is one w-bp bin

    m = SMCModel(np.logspace(-2, np.log10(3.0), 8), 20000.0, "pchip")
    m.y[:] = np.sin(np.linspace(0, 3.0, len(m.y))) * 0.7
    hs = estimation.balance_hidden_states(m, 17)  # M = 16
    im = OnePopInferenceManager(N, data, hs, ("pop1",), 0.5)
    im.set_model(m)
    im.theta = 1e-4
    im.alpha = W
    im.rho = 1e-4 / 4 * W
    _log(f"manager: kernel={'window' if im._use_windows else 'span'}, "
         f"{im.em_idx.n_keys} keys, {len(data)} contigs, "
         f"{windows} windows")

    t0 = time.time()
    ll = im.E_step()
    t_warm = time.time() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        im.E_step()
        times.append(time.perf_counter() - t0)
    t_e = float(np.median(times))

    out = {
        "real_pipeline_gbps": round(total_bases / t_e / 1e9, 2),
        "total_gbp": round(total_bases / 1e9, 2),
        "estep_s": round(t_e, 3),
        "estep_warmup_s": round(t_warm, 1),
        "loglik": float(ll),
        "n_keys": int(im.em_idx.n_keys),
        "kernel": "window" if im._use_windows else "span",
    }

    if decode:
        # posterior decode (gammas at row resolution) + MAP paths
        im.save_gamma = True
        t0 = time.perf_counter()
        im.E_step()
        t_decode_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        im.E_step()
        t_decode = time.perf_counter() - t0
        im.save_gamma = False

        # kernel-only decode (the wall number above includes pulling the
        # (n_rows, M) result to the host)
        t_decode_kernel = None
        if getattr(im, "_wdecode_fn", None) is not None:
            pi_d, T_d, E_d = (
                jax.device_put(jnp.asarray(np.asarray(x), im._estep_dtype),
                               im._device)
                for x in im.tensors()
            )
            o = im._wdecode_fn(pi_d, T_d, E_d, im._wkeys, im._wvalid,
                               im._wrow_ids)
            jax.block_until_ready(o)
            t0 = time.perf_counter()
            o = im._wdecode_fn(pi_d, T_d, E_d, im._wkeys, im._wvalid,
                               im._wrow_ids)
            jax.block_until_ready(o)
            t_decode_kernel = time.perf_counter() - t0

        t0 = time.perf_counter()
        im.map_paths()
        t_map_warmup = time.perf_counter() - t0
        # steady-state wall (the first call pays the one-time max-plus
        # kernel compile; round-4's 9.7 s "viterbi_s" was mostly that)
        t0 = time.perf_counter()
        im.map_paths()
        t_map = time.perf_counter() - t0
        out.update(
            decode_s=round(t_decode - t_e, 3),
            decode_kernel_s=(None if t_decode_kernel is None
                             else round(t_decode_kernel, 3)),
            decode_kernel_gbps=(
                None if t_decode_kernel is None
                else round(total_bases / t_decode_kernel / 1e9, 2)),
            decode_warmup_s=round(t_decode_warm, 1),
            viterbi_s=round(t_map, 3),
            viterbi_warmup_s=round(t_map_warmup, 1),
        )

    if em_iterations:
        # full EM iterations through the real optimizer (E-step + scale +
        # rho + per-knot coordinate M-step); first iteration pays the
        # Q/coarse-prefetch compiles, later ones are steady state
        from smcpp_jax.inference.optimizer import SMCPPOptimizer

        class _A:
            model = m
            _ims = {("pop1",): im}
            _theta = 1e-4
            _penalty = 0.0
            has_fast_batch = True

            # forward rho to the manager like the real Analysis does —
            # otherwise the optimizer's rho update lands on a dead
            # attribute and every measured iteration re-runs the same
            # search from stale state
            @property
            def rho(self):
                return im.rho

            @rho.setter
            def rho(self, x):
                im.rho = x

            def Q_batch(self, ys=None, rhos=None, coarse=False):
                return im.Q_batch(ys=ys, rhos=rhos, fast_ok=coarse)

            def Q_and_grad(self, y=None):
                return im.Q_and_grad(y=y)

            def Q(self, **kw):
                return im.Q(**kw)

            def E_step(self):
                im.E_step()

            def loglik(self):
                return im.loglik()

            def dump(self, fn):
                pass

        opt = SMCPPOptimizer(_A(), single=True, learn_rho=True)
        t0 = time.perf_counter()
        opt.run(1)
        em_warm = time.perf_counter() - t0
        # iteration #2 pays the one-time coarse-prefetch compile
        opt._old_loglik = None
        opt.run(1)
        em_times = []
        for _ in range(em_iterations):
            opt._old_loglik = None  # disarm ftol: measure full iterations
            t0 = time.perf_counter()
            opt.run(1)
            em_times.append(time.perf_counter() - t0)
        out.update(
            em_iteration_s=round(float(np.median(em_times)), 3),
            em_warmup_s=round(em_warm, 1),
        )
    return out


def run():
    out = {"phase": "run", "metric": "real_pipeline_estep_throughput",
           "unit": "Gbp/s"}
    out.update(measure())
    out["value"] = out["real_pipeline_gbps"]
    print(json.dumps(out))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--prep", action="store_true")
    p.add_argument("--run", action="store_true")
    args = p.parse_args()
    if args.prep:
        prep()
    if args.run:
        run()
    if not (args.prep or args.run):
        p.error("pass --prep and/or --run")
