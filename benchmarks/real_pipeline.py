"""E-step / EM benchmark on REAL pipeline output.

The headline bench.py stream is synthetic (rows drawn to match real row
statistics).  This benchmark instead drives the actual production path on
BASELINE.md-style configs and reports the same metrics, so the key-count
and span-distribution assumptions of the synthetic stream are checked
against data that went through the real filter stack:

* C1: the seeded example VCF (data/simulate.py:write_example_vcf) ->
  vcf2smc -> full `estimate` (2 EM iterations), wall-clock of the
  complete command.
* C2: sawtooth simulation (n=10, 10 x 10 Mb) -> the stage-2 filter
  pipeline (RecodeNonseg/Compress/BreakLongSpans/Thin/BinObservations/
  RecodeMonomorphic/Validate/DropUninformative) -> OnePopInferenceManager
  -> timed E-step (Gbp/s) + timed full EM iteration through the real
  optimizer.

Run:  python benchmarks/real_pipeline.py
Prints one JSON object with both configs.  On an H100: not measured yet.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

import jax

import smcpp_jax  # noqa: F401

try:
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
except RuntimeError:
    pass


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_c1(outdir):
    "vcf2smc + estimate on the seeded example VCF (correctness-scale)."
    from smcpp_jax.commands.main import main as cli_main
    from smcpp_jax.data.simulate import write_example_vcf

    vcf = write_example_vcf(os.path.join(outdir, "example.vcf.gz"))
    smc = os.path.join(outdir, "ex.smc.gz")
    t0 = time.time()
    cli_main([
        "vcf2smc", vcf, smc, "1",
        "pop1:" + ",".join(f"msp_{i}" for i in range(5)),
    ])
    t_vcf = time.time() - t0
    t0 = time.time()
    cli_main([
        "estimate", "--em-iterations", "2", "--knots", "6",
        "-o", os.path.join(outdir, "c1"), "1.25e-8", smc,
    ])
    t_est = time.time() - t0
    fit = json.load(
        open(os.path.join(outdir, "c1", "model.final.json"))
    )
    return {
        "vcf2smc_s": round(t_vcf, 2),
        "estimate_2it_s": round(t_est, 2),
        "final_model_loaded": "model" in fit,
    }


def bench_c2(outdir, w=100, M=16):
    "Sawtooth sim -> real filter pipeline -> manager -> timed E-step/EM."
    from smcpp_jax import util
    from smcpp_jax.data import filters as df
    from smcpp_jax.data.simulate import write_simulated
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.inference.optimizer import SMCPPOptimizer
    from smcpp_jax.models import PiecewiseModel, SMCModel

    saw = util.sawtooth
    a, s = util.exp_piecewise_to_stepwise(saw["a"], saw["b"], saw["s"])

    class _P(PiecewiseModel):
        def stepwise_values(self):
            return self.a

    true = _P(a, s, saw["N0"], "pop1")
    theta, rho = 5e-4, 4e-4
    # SMCPP_BENCH_SCALE < 1 shrinks the dataset (CPU smoke runs)
    scale = float(os.environ.get("SMCPP_BENCH_SCALE", "1"))
    L = max(int(10_000_000 * scale), 300_000)
    files = []
    for i in range(10):
        fn = os.path.join(outdir, f"c2_{i}.smc.gz")
        write_simulated(fn, true, theta, rho, L=L, n=10, seed=i)
        files.append(fn)
        _log("simulated", fn)

    # the stage-2 production pipeline (inference/analysis.py)
    N0 = saw["N0"]
    pipe = df.DataPipeline(files)
    pipe.add_filter(load_data=df.LoadData(cores=None))
    pipe.add_filter(df.RecodeNonseg(cutoff=None))
    pipe.add_filter(df.Compress())
    pipe.add_filter(df.BreakLongSpans(cutoff=100000))
    pipe.add_filter(df.DropSmallContigs(100000))
    pipe.add_filter(watterson=df.Watterson())
    pipe.add_filter(
        mutation_counts=df.CountMutations(w=int(2e-3 * N0 / rho))
    )
    pipe.add_filter(df.Thin(thinning=None))
    pipe.add_filter(df.BinObservations(w=w))
    pipe.add_filter(df.RecodeMonomorphic())
    pipe.add_filter(df.Compress())
    pipe.add_filter(df.Validate())
    pipe.add_filter(df.DropUninformativeContigs())
    pipe.add_filter(df.Summarize())
    t0 = time.time()
    contigs = list(pipe.results())
    t_pipe = time.time() - t0
    _log("pipeline", round(t_pipe, 1), "s,", len(contigs), "contigs")

    m = SMCModel(np.logspace(-2, 0.9, 8), N0, "piecewise", ("pop1",))
    m.y[:] = 0.0
    hs = estimation.balance_hidden_states(m, M)
    data = [c.data for c in contigs]
    n = max(int(c.n[0]) for c in contigs)
    t0 = time.time()
    im = OnePopInferenceManager(n, data, hs, ("pop1",), 0.5)
    t_build = time.time() - t0
    im.set_model(m)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = w
    total_bases = im.total_bases * w  # spans are in w-bp windows

    t0 = time.time()
    im.E_step()
    t_compile = time.time() - t0
    times = []
    for _ in range(3):
        t0 = time.time()
        im.E_step()
        times.append(time.time() - t0)
    t_estep = float(np.median(times))
    _log("E-step", t_estep, "s")

    class _FA:
        model = m
        _ims = {("pop1",): im}
        _theta = 1e-4
        _penalty = 0.0
        has_fast_batch = True

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

    opt = SMCPPOptimizer(_FA(), single=True, learn_rho=True)
    opt.run(1)  # compile
    opt._old_loglik = None
    t0 = time.time()
    opt.run(1)
    t_em = time.time() - t0
    _log("EM iteration", t_em, "s")
    return {
        "pipeline_s": round(t_pipe, 1),
        "manager_build_s": round(t_build, 2),
        "kernel": "window" if im._use_windows else "span",
        "n_keys": int(im.em_idx.n_keys),
        "estep_s": round(t_estep, 4),
        "estep_gbps": round(total_bases / t_estep / 1e9, 3),
        "estep_compile_s": round(t_compile, 1),
        "em_iteration_s": round(t_em, 2),
        "total_gbp": round(total_bases / 1e9, 3),
    }


def main():
    out = tempfile.mkdtemp()
    res = {"metric": "real_pipeline_bench", "unit": "see fields"}
    res["c2"] = bench_c2(out)
    res["c1"] = bench_c1(out)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
