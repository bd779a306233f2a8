"""Per-phase breakdown of one steady-state EM iteration at C3 scale.

Instruments the REAL optimizer (no reimplementation): wraps
SMCPPOptimizer phase methods and the analysis Q entry points with timers,
warms up to steady state, then reports median per-phase wall over the
measured iterations plus a log of every batched-Q dispatch (width,
coarse/f64, seconds).

Usage (one process on the card):
  python benchmarks/em_breakdown.py
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import real_pipeline_c3 as rp
    import smcpp_jax  # noqa: F401
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.inference.optimizer import SMCPPOptimizer
    from smcpp_jax.models import SMCModel

    z = np.load(rp.CACHE)
    data = [z[f"c{i}"] for i in range(int(z["n_contigs"]))]

    m = SMCModel(np.logspace(-2, np.log10(3.0), 8), 20000.0, "pchip")
    m.y[:] = np.sin(np.linspace(0, 3.0, len(m.y))) * 0.7
    hs = estimation.balance_hidden_states(m, 17)
    im = OnePopInferenceManager(rp.N, data, hs, ("pop1",), 0.5)
    im.set_model(m)
    im.theta = 1e-4
    im.alpha = rp.W
    im.rho = 1e-4 / 4 * rp.W

    class _A:
        model = m
        _ims = {("pop1",): im}
        _theta = 1e-4
        _penalty = 0.0
        has_fast_batch = True

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

    a = _A()
    opt = SMCPPOptimizer(a, single=True, learn_rho=True)

    phases = {}
    dispatches = []
    phase_stack = []

    def timed(obj, name, label=None):
        orig = getattr(obj, name)

        @functools.wraps(orig)
        def wrap(*args, **kw):
            lbl = label or name
            phase_stack.append(lbl)
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                phase_stack.pop()
                # only credit OUTERMOST phase entries (e.g. _minimize
                # inside the knot loop, not nested Q calls)
                if lbl not in phase_stack:
                    phases.setdefault(lbl, []).append(dt)

        setattr(obj, name, wrap)

    orig_qb = a.Q_batch

    def qb(ys=None, rhos=None, coarse=False):
        t0 = time.perf_counter()
        out = orig_qb(ys=ys, rhos=rhos, coarse=coarse)
        dt = time.perf_counter() - t0
        width = len(ys) if ys is not None else len(rhos)
        dispatches.append({
            "phase": phase_stack[-1] if phase_stack else "?",
            "width": int(width),
            "coarse": bool(coarse),
            "rho_sweep": ys is None,
            "s": round(dt, 4),
        })
        return out

    a.Q_batch = qb

    timed(a, "E_step")
    timed(a, "loglik")
    timed(opt, "_unified_mstep", "unified_mstep")
    timed(opt, "_optimize_param", "rho_search")
    timed(opt, "_optimize_scale", "scale_search")
    timed(opt, "_prefetch_coarse", "coarse_prefetch")
    timed(opt, "_fast_coordinate_pass", "fast_pass")
    timed(opt, "_minimize", "knot_minimize")
    timed(opt, "_occupancy_diagnostics", "occupancy")

    # warmup: 2 iterations (compiles + radius establishment)
    for _ in range(2):
        opt._old_loglik = None
        opt.run(1)
    phases.clear()
    dispatches.clear()

    iter_times = []
    n_iter = 4
    marks = []
    for _ in range(n_iter):
        opt._old_loglik = None
        marks.append(len(dispatches))
        t0 = time.perf_counter()
        opt.run(1)
        iter_times.append(time.perf_counter() - t0)
    marks.append(len(dispatches))

    per_phase = {}
    for k, v in phases.items():
        arr = np.asarray(v).reshape(n_iter, -1).sum(axis=1)
        per_phase[k] = {
            "median_s": round(float(np.median(arr)), 4),
            "calls_per_iter": len(v) // n_iter,
        }
    accounted = sum(p["median_s"] for p in per_phase.values())
    out = {
        "em_iteration_s": round(float(np.median(iter_times)), 4),
        "iter_times": [round(t, 4) for t in iter_times],
        "phases": per_phase,
        "accounted_s": round(accounted, 4),
        "dispatches_iter0": dispatches[marks[0]:marks[1]],
        "n_dispatches_per_iter": [
            marks[i + 1] - marks[i] for i in range(n_iter)
        ],
        "fast_pass_engaged": per_phase.get("knot_minimize") is None,
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
