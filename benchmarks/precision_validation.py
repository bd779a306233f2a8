"""Low-precision-vs-f32 E-step validation at EM scale.

Runs the sawtooth simulate -> estimate recovery (the C2-style config of
benchmarks/sawtooth_demo.py) twice through the production ``Analysis``
path on the accelerator — once at the default precision rung
('default') and once at exact f32 ('highest', the reference's forward
precision, /root/reference/include/hmm.h:35) — and reports per-run final
loglik, wall time, and the max relative deviation of the fitted N(t)
curves between the two runs.

The claim under test: EM is robust to the 'default' rung's E-step
statistic noise, so 'default' may stand as the production setting with
the optimizer's automatic escalation
(inference/optimizer.py:_maybe_raise_precision) as the safety net.  On an
H100: not measured yet.

Run:  python benchmarks/precision_validation.py [outdir]
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

# Host-side work (simulation, eager model math) stays on the CPU backend;
# only the manager's explicitly-placed E-step goes to the accelerator, so
# eager ops do not each pay a launch and a transfer.
try:
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
except RuntimeError:
    pass


def _log(*a):
    print(*a, file=sys.stderr, flush=True)
from smcpp_jax import util
from smcpp_jax.data.simulate import write_simulated
from smcpp_jax.inference.analysis import Analysis
from smcpp_jax.models import PiecewiseModel


def _simulate(outdir):
    saw = util.sawtooth
    a, s = util.exp_piecewise_to_stepwise(saw["a"], saw["b"], saw["s"])

    class _P(PiecewiseModel):
        def stepwise_values(self):
            return self.a

    true = _P(a, s, saw["N0"], "pop1")
    theta, rho = 5e-4, 4e-4
    files = []
    for i in range(8):
        fn = os.path.join(outdir, f"saw{i}.smc.gz")
        write_simulated(fn, true, theta, rho, L=10_000_000, n=8, seed=i)
        files.append(fn)
        _log("simulated", fn)
    return files, saw["N0"], theta, rho


def _fit(files, outdir, N0, theta, rho, precision):
    args = argparse.Namespace(
        mu=theta / (2 * N0), r=rho / (2 * N0),
        em_iterations=30, knots=12, spline="cubic",
        polarization_error=0.5, unfold=False, w=100, thinning=None,
        timepoints=(40.0, 40000.0), outdir=outdir,
        base=f"model-{precision or 'env'}",
        algorithm="L-BFGS-B", xtol=0.1, ftol=1e-7,
        regularization_penalty=8, lambda_=None, nonseg_cutoff=None,
        multi=False, cores=None, seed=0, precision=precision,
    )
    np.random.seed(0)
    t0 = time.time()
    _log("fitting at precision", precision)
    an = Analysis(files, args)
    an.run()
    wall = time.time() - t0
    _log("fit done", precision, "wall", round(wall, 1))
    fit = an.model
    tgen = np.logspace(np.log10(40.0), np.log10(40000.0), 200)
    curve = np.asarray(fit(tgen / (2 * fit.N0)), float) * fit.N0
    final_prec = {im.precision for im in an._ims.values()}
    return {
        "precision": precision,
        "final_precision": sorted(final_prec),
        "loglik": float(an.loglik()),
        "wall_s": round(wall, 1),
        "curve": curve,
    }


def main(outdir):
    os.makedirs(outdir, exist_ok=True)
    files, N0, theta, rho = _simulate(outdir)
    print("simulated", len(files), "contigs", file=sys.stderr)
    runs = [
        _fit(files, outdir, N0, theta, rho, p)
        for p in ("default", "highest")
    ]
    c0, c1 = runs[0].pop("curve"), runs[1].pop("curve")
    rel = np.abs(c0 - c1) / np.maximum(np.abs(c1), 1e-300)
    out = {
        "metric": "bf16_vs_f32_fit_deviation",
        "value": round(float(rel.max()), 6),
        "unit": "max |dN/N|",
        "runs": runs,
        "loglik_rel_gap": abs(runs[0]["loglik"] - runs[1]["loglik"])
        / abs(runs[1]["loglik"]),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp())
