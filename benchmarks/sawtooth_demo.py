"""BASELINE C2-style demonstration: sawtooth size history, simulate ->
estimate -> plot.

Simulates ~40 Mb (4 x 10 Mb contigs, n = 10 haplotypes) from the MSMC
sawtooth preset with the built-in generative HMM (no msprime in this image),
fits with a cubic spline, and writes truth-vs-fit to sawtooth.png + the
fitted model JSON.

Run:  PYTHONPATH=. python benchmarks/sawtooth_demo.py [outdir]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

import smcpp_jax  # noqa: F401
from smcpp_jax import util
from smcpp_jax.data.simulate import write_simulated
from smcpp_jax.inference.analysis import Analysis
from smcpp_jax.models import PiecewiseModel, SMCModel


def main(outdir):
    os.makedirs(outdir, exist_ok=True)
    saw = util.sawtooth
    a, s = util.exp_piecewise_to_stepwise(saw["a"], saw["b"], saw["s"])
    # wrap as an SMCModel-compatible object for the simulator
    class _P(PiecewiseModel):
        def stepwise_values(self):
            return self.a

    true = _P(a, s, saw["N0"], "pop1")
    # human-like rates: theta = 2*N0*mu with mu = 1.25e-8, N0 = 2e4
    theta, rho = 5e-4, 4e-4
    files = []
    for i in range(8):
        fn = os.path.join(outdir, f"saw{i}.smc.gz")
        write_simulated(fn, true, theta, rho, L=10_000_000, n=8, seed=i)
        files.append(fn)
        print("simulated", fn)

    args = argparse.Namespace(
        mu=theta / (2 * saw["N0"]), r=rho / (2 * saw["N0"]),
        em_iterations=30, knots=12, spline="cubic",
        polarization_error=0.5, unfold=False, w=100, thinning=None,
        # without --timepoints the knots come only from empirical-TMRCA
        # quantiles (reference analysis.py:104-116) and miss recent times;
        # pin the range in generations like the reference's published runs
        timepoints=(40.0, 40000.0), outdir=outdir, base="model",
        algorithm="L-BFGS-B", xtol=0.1, ftol=1e-7,
        regularization_penalty=8, lambda_=None, nonseg_cutoff=None,
        multi=False, cores=None, seed=0,
    )
    np.random.seed(0)
    an = Analysis(files, args)
    an.run()
    an.dump(os.path.join(outdir, "model.final"))
    print("final loglik", an.loglik())

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # plot in PHYSICAL units: the analysis rescales internally so that
    # theta == 1e-4 (its N0 differs from the simulation's) — comparing
    # in coalescent units would be a unit mismatch.
    fit = an.model
    tgen = np.logspace(1, 5.3, 400)
    fig, ax = plt.subplots()
    tt = np.cumsum(true.s) * 2 * true.N0
    ax.step(np.r_[10.0, tt], np.r_[true.a[0], true.a] * true.N0,
            where="pre", label="truth (sawtooth)", lw=2)
    ax.plot(tgen, np.asarray(fit(tgen / (2 * fit.N0))) * fit.N0,
            label="fit (cubic spline)", lw=2)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("generations")
    ax.set_ylabel("Ne (diploid)")
    ax.legend()
    out = os.path.join(outdir, "sawtooth.png")
    fig.savefig(out, dpi=120)
    print("wrote", out)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp())
