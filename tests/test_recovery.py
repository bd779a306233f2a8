"""Parameter recovery: simulate from a known size history with the model's
own generative HMM, refit with `estimate`, and check the recovered history.

This is the framework's analogue of the reference's scrm/msprime
cross-validation strategy (SURVEY.md section 4.3) given that no external
simulator is installed.
"""

import argparse

import numpy as np
import pytest

from smcpp_jax.data.simulate import write_simulated
from smcpp_jax.models import SMCModel


def make_args(**kw):
    d = dict(
        mu=1.25e-8, r=1.25e-8, em_iterations=5, knots=6, spline="piecewise",
        polarization_error=0.5, unfold=False, w=100, thinning=None,
        timepoints=None, outdir=None, base="model", algorithm="L-BFGS-B",
        xtol=0.1, ftol=1e-4, regularization_penalty=6, lambda_=None,
        nonseg_cutoff=None, multi=False, cores=None, seed=0,
    )
    d.update(kw)
    return argparse.Namespace(**d)


@pytest.mark.slow
def test_bottleneck_recovery(tmp_path):
    from smcpp_jax.inference.analysis import Analysis

    # true history: recent size 2.0, ancient size 0.5 (in 2N0 units),
    # switching at t = 0.3 coalescent units
    true = SMCModel(np.array([0.05, 0.3, 2.0]), 2e4, "piecewise", "pop1")
    true.y = np.log(np.array([2.0, 2.0, 0.5]))
    theta = 1e-4  # per-base, matches mu * 2 * N0 with N0 = 0.5e-4 / mu
    rho = 1e-4
    files = []
    for i in range(4):
        fn = tmp_path / f"sim{i}.smc.gz"
        write_simulated(str(fn), true, theta, rho, L=5_000_000, n=6, seed=i)
        files.append(str(fn))

    np.random.seed(0)
    a = Analysis(files, make_args(outdir=str(tmp_path)))
    a.run()
    fit = a.model

    # The recent epoch (dense het windows) and ancient tail (SFS rows) are
    # well constrained at this data size; mid-range knots fluctuate (as the
    # reference's estimator does on ~20 Mb of data), so check the ends and
    # the overall decline.
    got_recent = float(np.asarray(fit(np.array([0.05])))[0])
    got_ancient = float(np.asarray(fit(np.array([2.5])))[0])
    assert abs(np.log(got_recent / 2.0)) < np.log(2.2), got_recent
    assert abs(np.log(got_ancient / 0.5)) < np.log(2.2), got_ancient
    assert got_recent > got_ancient
