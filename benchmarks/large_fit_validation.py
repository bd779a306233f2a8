"""Large-data parameter-recovery validation: full two-stage `estimate`
on 1 Gbp of simulated data (4 x 250 Mb, n = 50) from a known smooth truth
model, end-to-end through the production Analysis path on one device.

The sawtooth demo validates at 80 Mb; here the E-step/M-step machinery
runs at 12x that scale with the real filter stack, thinning, binning, GMM
hidden states, and the full EM loop, and the fitted N(t) is scored against
the truth curve (median / p90 relative error of log N over the
data-supported time window).

  # host prep (cached in the checkout):
  JAX_PLATFORMS=cpu python benchmarks/large_fit_validation.py --prep
  # fit, on the card:
  python benchmarks/large_fit_validation.py --run
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache",
    "large_fit",
)
N = 50
C = 4
LBP = 250_000_000
THETA, RHO = 1e-4, 2.5e-5
N0 = 20000.0


def _truth_model():
    from smcpp_jax.models import SMCModel

    m = SMCModel(np.logspace(-2, np.log10(3.0), 8), N0, "pchip")
    m.y[:] = np.sin(np.linspace(0, 3.0, len(m.y))) * 0.7
    return m


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def prep():
    import smcpp_jax  # noqa: F401
    from smcpp_jax.data.simulate import write_simulated

    os.makedirs(CACHE_DIR, exist_ok=True)
    m = _truth_model()
    t0 = time.time()
    for i in range(C):
        fn = os.path.join(CACHE_DIR, f"sim{i}.smc.gz")
        if not os.path.exists(fn):
            write_simulated(fn, m, THETA, RHO, L=LBP, n=N, seed=100 + i)
        _log(f"contig {i} ready ({time.time() - t0:.0f} s)")
    print(json.dumps({"phase": "prep", "dir": CACHE_DIR, "gbp": C * LBP / 1e9}))


def run():
    import jax

    jax.config.update("jax_enable_x64", True)
    import smcpp_jax  # noqa: F401
    from smcpp_jax.inference.analysis import Analysis
    from smcpp_jax.ops.ratefunc import HostRateFunction

    files = sorted(glob.glob(os.path.join(CACHE_DIR, "sim*.smc.gz")))
    assert len(files) == C, files
    outdir = os.path.join(CACHE_DIR, "fit")
    os.makedirs(outdir, exist_ok=True)
    args = argparse.Namespace(
        mu=THETA / (2 * N0), r=RHO / (2 * N0),
        em_iterations=20, knots=8, spline="pchip",
        polarization_error=0.5, unfold=False, w=100, thinning=None,
        timepoints=None, outdir=outdir, base="model",
        algorithm="L-BFGS-B", xtol=0.1, ftol=1e-4,
        regularization_penalty=6.0, lambda_=None, nonseg_cutoff=None,
        multi=False, cores=None, seed=0,
    )
    np.random.seed(0)
    t0 = time.time()
    a = Analysis(files, args)
    t_init = time.time() - t0
    t0 = time.time()
    a.run()
    t_fit = time.time() - t0
    a.dump(os.path.join(outdir, "model.final"))

    # score the fit against the truth on the data-supported window
    truth = _truth_model()
    eta_t = HostRateFunction(truth.stepwise_values(), truth.s)
    eta_f = HostRateFunction(a.model.stepwise_values(), a.model.s)
    # evaluate between the ~2.5% and ~97.5% coalescent quantiles of truth
    lo = float(eta_t.Rinv(-np.log(0.975)))
    hi = float(eta_t.Rinv(-np.log(0.025)))
    ts = np.geomspace(max(lo, 1e-3), hi, 64)

    def stepval(model, t):
        cs = np.concatenate([[0.0], np.cumsum(model.s)])
        v = np.asarray(model.stepwise_values(), float)
        i = np.minimum(np.searchsorted(cs, t, side="right") - 1, len(v) - 1)
        return v[i]

    err = np.abs(np.log(stepval(a.model, ts)) - np.log(stepval(truth, ts)))
    out = {
        "phase": "run",
        "metric": "large_fit_logN_abs_err",
        "gbp": C * LBP / 1e9,
        "median_abs_log_err": round(float(np.median(err)), 4),
        "p90_abs_log_err": round(float(np.percentile(err, 90)), 4),
        "loglik": float(a.loglik()),
        "init_s": round(t_init, 1),
        "fit_s": round(t_fit, 1),
        "window_coal_units": [round(lo, 4), round(hi, 4)],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--prep", action="store_true")
    p.add_argument("--run", action="store_true")
    a = p.parse_args()
    if a.prep:
        prep()
    if a.run:
        run()
    if not (a.prep or a.run):
        p.error("pass --prep and/or --run")
