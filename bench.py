"""Benchmark: E-step forward-backward throughput (Gbp/sec/chip).

Human-scale configuration from BASELINE.md C3: n = 50 haplotypes, 22
autosome-sized contigs (250 Mbp each, w = 100 bp windows -> 2.5e6 windows
per contig), M = 16 hidden states — the reference's default `estimate`
workload shape.  Measures the direct (AD-free) two-pass Baum-Welch window
kernel (smcpp_jax/ops/window_kernel.py:estep_direct) — the path the
inference manager selects for this data shape — including all E-step
sufficient statistics (pi-stat, xisum, per-key posterior masses).

The synthetic observation stream matches the row statistics of real
post-pipeline data (mostly short nonpolymorphic runs + dinucleotide windows,
sparse full-SFS rows); the E-step cost depends only on those shapes.

vs_baseline: the reference publishes no numbers (BASELINE.md) and cannot be
built in this image (no GMP/MPFR/GSL headers, no Cython).  The denominator
0.5 Gbp/s is an estimate for 16-core CPU SMC++ E-step throughput derived
from its per-row cost (O(M^2) eigenbasis ops per compressed row ~ 1 us/row
single-threaded, ~5e5 compressed rows per 0.25 Gbp contig, forward +
backward passes, 16 threads) and should be replaced by a measured number
when a buildable reference exists.
"""

import json
import time

import numpy as np

REFERENCE_ESTEP_GBP_PER_SEC = 0.5  # estimated; see module docstring


def synth_contig(rng, n_windows, n_keys, full_key_lo):
    "Span-compressed rows mimicking thinned+binned human data."
    out_spans = []
    out_keys = []
    total = 0
    # vectorized draw in blocks
    while total < n_windows:
        m = 200_000
        r = rng.random(m)
        spans = np.where(
            r < 0.80,
            rng.geometric(0.45, m),
            np.where(r < 0.97, rng.geometric(0.02, m), 1),
        ).astype(np.int64)
        keys = np.where(
            r < 0.97,
            rng.integers(0, 3, m),
            rng.integers(full_key_lo, n_keys, m),
        ).astype(np.int32)
        cs = np.cumsum(spans)
        take = np.searchsorted(cs, n_windows - total, side="left") + 1
        take = min(take, m)
        spans = spans[:take]
        keys = keys[:take]
        overshoot = int(np.sum(spans)) - (n_windows - total)
        if overshoot > 0:
            spans[-1] -= overshoot
        total += int(np.sum(spans))
        out_spans.append(spans)
        out_keys.append(keys)
    s = np.concatenate(out_spans)
    k = np.concatenate(out_keys)
    keep = s > 0
    return np.c_[s[keep], k[keep]].astype(np.int64)


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from functools import partial

    import smcpp_jax  # noqa: F401
    from smcpp_jax.ops import window_kernel as wk

    rng = np.random.default_rng(0)
    C = 22
    WINDOWS = 2_500_000  # 250 Mbp at w = 100
    W = 100
    M = 16
    n_keys = 128

    raw = [synth_contig(rng, WINDOWS, n_keys, 3) for _ in range(C)]
    key_id = {(k,): k for k in range(n_keys)}
    keys, valid, soc = wk.pack_windows(
        [r for r in raw], key_id, seg_target=8192, max_seg_len=16384
    )

    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M) * 40, size=M)
    T = T + np.eye(M) * 50
    T /= T.sum(1, keepdims=True)
    E = rng.uniform(0.05, 1.0, (n_keys, M))

    dev = jax.devices()[0]
    dt = jnp.float32
    pj = [jax.device_put(jnp.asarray(x, dt), dev) for x in (pi, T, E)]
    kj = jax.device_put(jnp.asarray(keys), dev)
    vj = jax.device_put(jnp.asarray(valid), dev)

    estep = jax.jit(partial(wk.estep_direct, seg_of_contig=soc), device=dev)
    out = estep(*pj, kj, vj)  # compile + warmup
    jax.block_until_ready(out)
    assert np.isfinite(float(out[0]))

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = estep(*pj, kj, vj)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    dt_s = float(np.median(times))
    total_bases = float(C * WINDOWS) * W
    gbps = total_bases / dt_s / 1e9
    out = {
        "metric": "estep_throughput",
        "value": round(gbps, 3),
        "unit": "Gbp/s",
        "vs_baseline": round(gbps / REFERENCE_ESTEP_GBP_PER_SEC, 2),
    }
    out.update(real_pipeline_metrics())
    out.update(twopop_metrics())
    print(json.dumps(out))


def real_pipeline_metrics():
    """Through-the-manager numbers on the REAL C3 pipeline data (cached
    prep from benchmarks/real_pipeline_c3.py --prep): E-step Gbp/s, gamma
    decode, window Viterbi, and full EM-iteration wall — folded into the
    driver-captured JSON line so the round's perf story is verifiable, not
    builder-reported (VERDICT r3 item 3).  Skipped (with a reason) when the
    prep cache is absent or SMCPP_JAX_BENCH_FAST=1."""
    import os
    import sys
    import traceback

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    import real_pipeline_c3 as rp

    if os.environ.get("SMCPP_JAX_BENCH_FAST") == "1":
        return {"real_pipeline": "skipped (SMCPP_JAX_BENCH_FAST=1)"}
    if not os.path.exists(rp.CACHE):
        return {"real_pipeline": f"skipped (no prep cache at {rp.CACHE}; "
                                 "run real_pipeline_c3.py --prep)"}
    try:
        m = rp.measure()
    except Exception:
        traceback.print_exc()
        return {"real_pipeline": "error (traceback on stderr)"}
    keep = ("real_pipeline_gbps", "total_gbp", "estep_s", "decode_s",
            "decode_kernel_s", "decode_kernel_gbps", "viterbi_s",
            "em_iteration_s", "kernel")
    return {k: m[k] for k in keep if k in m}


def twopop_metrics():
    """Two-pop E-step at production scale (M=32, 1 Gbp synthetic joint
    data through TwoPopInferenceManager) — driver-captured so the round-4
    two-pop setup-path work (2.48 s -> 0.24 s) is verifiable, not
    builder-reported.  ~2 min including synth + warmup; skipped under
    SMCPP_JAX_BENCH_FAST=1."""
    import os
    import sys
    import traceback

    if os.environ.get("SMCPP_JAX_BENCH_FAST") == "1":
        return {"twopop": "skipped (SMCPP_JAX_BENCH_FAST=1)"}
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    try:
        import jax

        # the JCSFS/tensor pipeline is validated under f64; standalone
        # callers must not silently build the manager under f32
        jax.config.update("jax_enable_x64", True)
        import twopop_decode as td

        im, windows, _ = td.build_manager(with_probe=False)
        estep_s, _warm_s, ll = td.measure_estep(im)
        assert np.isfinite(ll)
        return {
            "twopop_estep_s": round(estep_s, 3),
            "twopop_estep_gbps": round(windows * td.W / estep_s / 1e9, 2),
            "twopop_M": td.M,
        }
    except Exception:
        traceback.print_exc()
        return {"twopop": "error (traceback on stderr)"}


if __name__ == "__main__":
    main()
