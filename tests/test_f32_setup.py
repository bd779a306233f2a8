"""The f32 M-step objective (manager._setup_fast) must track the f64 host
objective far below the scalar-search signal and the E-step's own bf16
statistic noise.

The routing (Q_batch -> accelerator f32 program) only engages on a non-CPU
E-step device; here the f32 programs themselves are built and compared on
CPU, which exercises the same trace (TimeGrid.astype(float32) + the
dtype-following constants in ops/)."""

import numpy as np
import jax.numpy as jnp

from smcpp_jax.inference.manager import OnePopInferenceManager
from smcpp_jax.inference import estimation
from smcpp_jax.models import SMCModel
from smcpp_jax.ops import grid as grid_mod


def _make_im(n=30, M=12):
    rng = np.random.default_rng(1)
    rows = []
    for _ in range(300):
        if rng.random() < 0.8:
            rows.append((3, int(rng.integers(0, 2)), 0, 0))
        else:
            rows.append(
                (1, int(rng.integers(0, 3)), int(rng.integers(0, n + 1)), n)
            )
    data = [np.array(rows, dtype=np.int32)] * 2
    m = SMCModel(np.logspace(-2, 0.9, 8), 2e4, "piecewise", ("pop1",))
    m.y[:] = rng.normal(0.0, 0.3, size=len(m.y))
    hs = estimation.balance_hidden_states(m, M)
    im = OnePopInferenceManager(n, data, hs, ("pop1",), 0.5)
    im.set_model(m)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 100
    im.E_step()
    return im, m


def test_grid_astype():
    g = grid_mod.make_time_grid(np.logspace(-2, 1, 5), [0.0, 0.1, 1.0, np.inf])
    g32 = g.astype(np.float32)
    assert g32.dt.dtype == np.float32
    assert np.isfinite(g32.dt[-1]) and g32.dt[-1] <= 1e25
    assert g32.segment_matrix().dtype == np.float32
    np.testing.assert_array_equal(g32.src, g.src)
    np.testing.assert_array_equal(g32.hs_indices, g.hs_indices)
    assert g.astype(np.float64) is g


def test_fast_q_matches_f64():
    im, m = _make_im()
    # scale stats up to production magnitude so the f64-reduction design is
    # actually exercised (f32 accumulation would fail this tolerance)
    g0, xi, gs = im._stats
    scale = 5e7 / gs.sum()
    im._stats = (g0, xi * scale, gs * scale)

    B = 16
    ys = np.tile(m.y, (B, 1))
    ys[:, 4] = np.linspace(-1.5, 1.5, B)
    qb64 = im._setup()[3]
    qb32 = im._setup_fast()[0]
    y0, th, rho0, al, g0d, xsd, gsd = im._q_args(None, None, None, None)
    rhob = np.full(B, rho0)
    v64 = np.asarray(qb64(ys, th, rhob, al, g0d, xsd, gsd), np.float64)
    v32 = np.asarray(qb32(ys, th, rhob, al, g0d, xsd, gsd), np.float64)
    # absolute error << between-candidate signal; ~1e-7 relative measured
    sig = np.median(np.abs(np.diff(v64)))
    assert np.max(np.abs(v32 - v64)) < max(1e-3 * sig, 1e-5 * np.abs(v64).max())
    assert int(np.argmax(v32)) == int(np.argmax(v64))

    # rho-batch variant
    qrb64 = im._setup()[4]
    qrb32 = im._setup_fast()[1]
    rhos = np.geomspace(1e-6, 1e-2, 12)
    r64 = np.asarray(qrb64(y0, th, rhos, al, g0d, xsd, gsd), np.float64)
    r32 = np.asarray(qrb32(y0, th, rhos, al, g0d, xsd, gsd), np.float64)
    sig = np.median(np.abs(np.diff(r64)))
    assert np.max(np.abs(r32 - r64)) < max(1e-3 * sig, 1e-5 * np.abs(r64).max())
    assert int(np.argmax(r32)) == int(np.argmax(r64))


def test_fast_routing_gates():
    im, _ = _make_im(n=10, M=6)
    # CPU E-step device -> fast path off
    assert not im._use_fast_mstep()
    import os
    os.environ["SMCPP_JAX_FAST_MSTEP"] = "0"
    try:
        assert not im._use_fast_mstep()
    finally:
        del os.environ["SMCPP_JAX_FAST_MSTEP"]


def test_batched_argmax_coarse_never_decides():
    """The shrinking-grid search may bracket with a noisy 'coarse'
    objective but must make every decision (best value, refinement,
    termination) from exact evaluations: a +10-biased coarse round must
    not leak into the returned optimum."""
    from smcpp_jax.inference.optimizer import SMCPPOptimizer

    opt = SMCPPOptimizer.__new__(SMCPPOptimizer)
    calls = {"coarse": 0, "exact": 0}

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        v = -((xs - 0.3) ** 2)
        if coarse:
            calls["coarse"] += 1
            return v + 10.0  # inflated values; correct shape
        calls["exact"] += 1
        return v

    x, val = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3)
    assert abs(x - 0.3) < 1e-2
    # the returned value must come from the exact objective (never the
    # +10-shifted coarse one)
    assert val <= 0.0 + 1e-12
    assert calls["coarse"] == 1 and calls["exact"] >= 1


def test_batched_argmax_exact_when_no_coarse_consumer():
    "Callers that ignore the coarse flag (pure-f64 paths) still converge."
    from smcpp_jax.inference.optimizer import SMCPPOptimizer

    opt = SMCPPOptimizer.__new__(SMCPPOptimizer)

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        return -np.abs(xs - 1.234) ** 1.5

    x, _ = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3)
    assert abs(x - 1.234) < 5e-3


def test_batched_argmax_prefetched_bracket():
    """A prefetched coarse bracket (Jacobi prefetch, _prefetch_coarse)
    replaces the round-0 dispatch: no coarse evaluation is issued, the
    optimum is found, and the returned value still comes from exact
    evaluations only."""
    from smcpp_jax.inference.optimizer import SMCPPOptimizer

    opt = SMCPPOptimizer.__new__(SMCPPOptimizer)
    calls = {"coarse": 0, "exact": 0}

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        calls["coarse" if coarse else "exact"] += 1
        return -((xs - 0.3) ** 2) + (10.0 if coarse else 0.0)

    xs0 = np.linspace(-3.0, 3.0, opt._BATCH)
    # stale-context values: shifted but with an interior argmax near the
    # true optimum (coarse values only ever bracket)
    v0 = -((xs0 - 0.35) ** 2) + 7.0
    x, val = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3, coarse0=(xs0, v0))
    assert abs(x - 0.3) < 1e-2
    assert val <= 1e-12
    assert calls["coarse"] == 0 and calls["exact"] >= 1


def test_batched_argmax_prefetch_edge_rejected():
    "An edge-argmax prefetched bracket is rejected: fresh coarse round runs."
    from smcpp_jax.inference.optimizer import SMCPPOptimizer

    opt = SMCPPOptimizer.__new__(SMCPPOptimizer)
    calls = {"coarse": 0}

    def f(xs, coarse=False):
        xs = np.asarray(xs, float)
        if coarse:
            calls["coarse"] += 1
        return -((xs - 0.3) ** 2)

    xs0 = np.linspace(-3.0, 3.0, opt._BATCH)
    v0 = xs0.copy()  # argmax at the right edge -> stale-context suspicion
    x, _ = opt._batched_argmax(f, -3.0, 3.0, xatol=1e-3, coarse0=(xs0, v0))
    assert calls["coarse"] == 1
    assert abs(x - 0.3) < 1e-2


def test_prefetch_coarse_grids_match_scalar_windows():
    """_prefetch_coarse builds, per coordinate with a trust radius, exactly
    the grid the scalar search would evaluate in its round 0, in ONE
    batched Q call."""
    from smcpp_jax.inference.optimizer import SMCPPOptimizer

    class M:
        K = 3
        y = np.array([0.1, -0.2, 0.4])

    class A:
        model = M()
        has_fast_batch = True

        def __init__(self):
            self.calls = []

        def Q_batch(self, ys=None, rhos=None, coarse=False):
            self.calls.append((np.asarray(ys).shape, coarse))
            return -np.sum((np.asarray(ys) - 0.25) ** 2, axis=1)

    a = A()
    opt = SMCPPOptimizer(a, single=True)
    opt._radius = {0: 0.5, 2: 1.0}  # coordinate 1 untouched so far
    pf = opt._prefetch_coarse()
    assert set(pf) == {0, 2}
    assert a.calls == [((2 * opt._BATCH, 3), True)]
    for k in (0, 2):
        lo, hi = opt._scalar_window(k, M.y[k])
        xs, vals = pf[k]
        np.testing.assert_allclose(xs, np.linspace(lo, hi, opt._BATCH))
        assert len(vals) == opt._BATCH
