"""Search-policy tests for the M-step's batched scalar machinery
(VERDICT r2 weak item 5): edge-argmax rejection of prefetched brackets,
trust-radius regrowth after clamped moves, all-non-finite coarse rounds,
and the Jacobi coarse prefetch — all on deterministic synthetic
objectives, no managers involved."""

from types import SimpleNamespace

import numpy as np
import pytest

from smcpp_jax.inference.optimizer import SMCPPOptimizer


class FakeAnalysis:
    """Quadratic per-coordinate objective with full call recording.

    Q(y) = -sum_k w_k (y_k - opt_k)^2; Q_batch mirrors the manager's
    batched contract (ys (B, K) rows, optional coarse flag)."""

    def __init__(self, K=4, opt=None, w=None):
        self.model = SimpleNamespace(y=np.zeros(K), K=K)
        self.has_fast_batch = True
        self.opt = np.full(K, 1.5) if opt is None else np.asarray(opt, float)
        self.w = np.ones(K) if w is None else np.asarray(w, float)
        self.calls = []
        self.coarse_value = None  # override for coarse rounds (e.g. -inf)

    def _q(self, ys):
        ys = np.atleast_2d(np.asarray(ys, float))
        return -np.sum(self.w * (ys - self.opt) ** 2, axis=1)

    def Q_batch(self, ys=None, rhos=None, coarse=False):
        assert ys is not None
        self.calls.append((np.asarray(ys, float).copy(), bool(coarse)))
        v = self._q(ys)
        if coarse and self.coarse_value is not None:
            v = np.full_like(v, self.coarse_value)
        return v


def make_opt(a, xtol=1e-3):
    o = SMCPPOptimizer.__new__(SMCPPOptimizer)
    o._analysis = a
    o._algorithm = "L-BFGS-B"
    o._xtol = xtol
    o._ftol = 1e-4
    o._single = True
    o._learn_rho = False
    o._outdir = None
    o._base = "model"
    # mid-run state: the unified M-step defers its FIRST M-step to the
    # sequential cascade (warm-start basin selection)
    o._old_loglik = -1.0
    o._mstep_count = 1
    o._radius = {}
    return o


def _fb(a, k):
    "Single-coordinate batched objective around the current model."

    def f(xs, coarse=False):
        ys = np.tile(a.model.y, (len(xs), 1))
        ys[:, k] = xs
        return a.Q_batch(ys=ys, coarse=coarse)

    return f


def test_prefetched_bracket_accepted_interior():
    "An interior-argmax prefetched bracket replaces the round-0 dispatch."
    a = FakeAnalysis(opt=[0.7, 0, 0, 0])
    o = make_opt(a)
    xs0 = np.linspace(-3, 3, o._BATCH)
    v0 = np.asarray(a._q(np.c_[xs0, np.zeros((len(xs0), 3))]))
    x, v = o._batched_argmax(_fb(a, 0), -3, 3, 1e-3, coarse0=(xs0, v0))
    assert abs(x - 0.7) < 1e-3
    # every dispatched round used the exact (non-coarse) objective
    assert all(not c for _, c in a.calls)


def test_prefetched_bracket_rejected_on_edge_argmax():
    """A prefetched bracket whose best point sits on a grid EDGE (the
    symptom of stale-context drift) must be discarded: round 0 re-runs
    fresh as a full-width coarse dispatch."""
    a = FakeAnalysis(opt=[2.0, 0, 0, 0])
    o = make_opt(a)
    xs0 = np.linspace(-3, 3, o._BATCH)
    v0 = -((xs0 - 5.0) ** 2)  # stale values: argmax at the right edge
    x, v = o._batched_argmax(_fb(a, 0), -3, 3, 1e-3, coarse0=(xs0, v0))
    assert abs(x - 2.0) < 1e-3
    # first dispatched round is the fresh full-width coarse grid
    ys0, coarse0_flag = a.calls[0]
    assert coarse0_flag and len(ys0) == o._BATCH
    assert np.isclose(ys0[:, 0].min(), -3) and np.isclose(ys0[:, 0].max(), 3)


def test_all_nonfinite_coarse_round_keeps_x0():
    """If every candidate of the coarse round is non-finite the search
    aborts (no zoom on garbage) and _minimize keeps the incumbent."""
    a = FakeAnalysis(opt=[1.0, 0, 0, 0])
    a.coarse_value = -np.inf
    o = make_opt(a)
    x, v = o._batched_argmax(_fb(a, 0), -3, 3, 1e-3)
    assert x is None and v == -np.inf
    # through _minimize: the model keeps its current value
    res = o._minimize(np.array([0.25]), [0])
    assert np.isclose(res.x[0], 0.25)


def test_trust_radius_regrows_after_clamped_move():
    """A move clamped at the trust-radius edge must regrow the radius
    (x4 per iteration) so later iterations reach a distant optimum."""
    a = FakeAnalysis(opt=[2.0, 0, 0, 0])
    o = make_opt(a, xtol=1e-3)
    o._radius[0] = 0.1  # tiny stale radius, optimum 2.0 away
    radii = []
    for _ in range(6):
        x0 = a.model.y[[0]].copy()
        res = o._minimize(x0, [0])
        a.model.y[0] = res.x[0]
        radii.append(o._radius[0])
        if abs(a.model.y[0] - 2.0) < 1e-2:
            break
    assert abs(a.model.y[0] - 2.0) < 1e-2, (a.model.y[0], radii)
    # the first moves were clamped at the radius edge and the radius grew
    assert radii[0] > 0.1
    assert radii[1] > radii[0]


def test_radius_shrinks_near_convergence():
    "Small moves shrink the next search window (but never below 4*xtol)."
    a = FakeAnalysis(opt=[0.002, 0, 0, 0])
    o = make_opt(a, xtol=1e-3)
    res = o._minimize(np.array([0.0]), [0])
    a.model.y[0] = res.x[0]
    assert o._radius[0] <= 0.05
    assert o._radius[0] >= 4 * o._xtol - 1e-12


def test_prefetch_coarse_gating_and_layout():
    """_prefetch_coarse batches one grid per coordinate WITH a trust
    radius (none on the first iteration), all in a single Q_batch call,
    each grid centered on the iteration-start model."""
    a = FakeAnalysis(K=3, opt=[0.5, -0.5, 1.0])
    o = make_opt(a)
    assert o._prefetch_coarse() == {}  # no radii yet -> no prefetch
    o._radius = {0: 0.5, 2: 1.0}
    a.model.y[:] = [0.1, 0.2, 0.3]
    out = o._prefetch_coarse()
    assert set(out) == {0, 2}
    assert len(a.calls) == 1  # ONE batched dispatch for both grids
    ys, coarse = a.calls[0]
    assert coarse and len(ys) == 2 * o._BATCH
    xs0, v0 = out[0]
    assert np.isclose(xs0.min(), 0.1 - 0.5) and np.isclose(xs0.max(), 0.1 + 0.5)
    # rows follow the (reversed) coordinate schedule; find k=0's block and
    # check the off-coordinate columns are pinned to the iteration-start model
    ks = [c[0] for c in o._coordinates() if c[0] in o._radius]
    blk = ks.index(0) * o._BATCH
    np.testing.assert_allclose(ys[blk : blk + o._BATCH, 0], xs0)
    np.testing.assert_array_equal(ys[blk : blk + o._BATCH, 1], 0.2)
    np.testing.assert_array_equal(ys[blk : blk + o._BATCH, 2], 0.3)
    # values are the true objective on that grid
    np.testing.assert_allclose(
        v0, a._q(np.c_[xs0, np.full(len(xs0), 0.2), np.full(len(xs0), 0.3)])
    )


def test_prefetch_requires_fast_batch():
    a = FakeAnalysis()
    a.has_fast_batch = False
    o = make_opt(a)
    o._radius = {0: 1.0}
    assert o._prefetch_coarse() == {}


# -- fast coordinate pass (round-4 M-step tail cut) -----------------------

def _converged_radius(o):
    """A trust radius small enough that every coarse bracket counts as
    converged (2 * grid spacing <= 6 * xtol)."""
    return 1.4 * o._xtol * (o._BATCH - 1) / 2.0


def test_fast_pass_one_decision_batch():
    """With every bracket converged, the whole knot loop collapses to ONE
    f64 decision batch (K candidates + base) and moves every knot to its
    parabola vertex."""
    o = make_opt(FakeAnalysis(K=4))
    a = o._analysis
    r = _converged_radius(o)
    a.model.y[:] = 1.5 - 0.4 * r  # optima 0.4 r away: interior argmax
    o._radius = {k: r for k in range(4)}
    prefetch = o._prefetch_coarse()
    a.calls.clear()
    assert o._fast_coordinate_pass(prefetch)
    f64_calls = [ys for ys, coarse in a.calls if not coarse]
    assert len(f64_calls) <= 2  # decision batch (+ combined-move check)
    assert len(f64_calls[0]) == 4 + 1
    np.testing.assert_allclose(a.model.y, 1.5, atol=2 * o._xtol)


def test_fast_pass_falls_back_when_unconverged():
    "A wide bracket (genuine zoom needed) must use the sequential path."
    o = make_opt(FakeAnalysis(K=3))
    o._analysis.model.y[:] = 1.0
    o._radius = {k: 0.5 for k in range(3)}  # way over the confirm threshold
    prefetch = o._prefetch_coarse()
    assert not o._fast_coordinate_pass(prefetch)


def test_fast_pass_falls_back_on_missing_bracket():
    "First iterations (no radius yet on some knot) keep the full search."
    o = make_opt(FakeAnalysis(K=3))
    r = _converged_radius(o)
    o._radius = {0: r, 1: r}  # knot 2 has no prefetched bracket
    prefetch = o._prefetch_coarse()
    assert not o._fast_coordinate_pass(prefetch)


def test_fast_pass_rejects_nonimproving_candidates():
    """Candidates whose exact f64 value does not beat the base stay put
    (the f32 coarse parabola never decides an accept on its own)."""

    o = make_opt(FakeAnalysis(K=2))
    a = o._analysis
    r = _converged_radius(o)
    shift = 0.3 * r

    orig = a.Q_batch

    def q_batch(ys=None, rhos=None, coarse=False):
        if coarse:  # stale coarse values: apparent optimum shifted
            return orig(ys=np.asarray(ys, float) - shift, coarse=True)
        return orig(ys=ys, rhos=rhos, coarse=coarse)

    a.Q_batch = q_batch
    a.model.y[:] = 1.5  # already AT the true optimum
    o._radius = {k: r for k in range(2)}
    prefetch = o._prefetch_coarse()
    assert o._fast_coordinate_pass(prefetch)
    # the shifted coarse parabola proposes 1.5 + shift; its exact f64
    # value loses to the base row, so both moves are rejected
    np.testing.assert_allclose(a.model.y, 1.5, atol=1e-12)


def test_fast_pass_coupling_falls_back_to_best_single():
    """When knot couplings make the COMBINED move worse than the best
    single move, the pass takes the best single accepted move instead."""

    class Coupled(FakeAnalysis):
        # Q = -(y0 + y1 - 1)^2: per-coordinate concave, strongly coupled
        def _q(self, ys):
            ys = np.atleast_2d(np.asarray(ys, float))
            return -((ys[:, 0] + ys[:, 1] - 1.0) ** 2)

    o = make_opt(Coupled(K=2))
    a = o._analysis
    r = _converged_radius(o)
    # sum is 1 + 0.9 r: each single move of -0.9 r fixes the sum exactly
    # (interior argmax); BOTH moves overshoot to sum = 1 - 0.9 r
    y0 = 0.5 + 0.45 * r
    a.model.y[:] = [y0, y0]
    o._radius = {k: r for k in range(2)}
    q0 = float(a._q(a.model.y[None])[0])
    prefetch = o._prefetch_coarse()
    assert o._fast_coordinate_pass(prefetch)
    q1 = float(a._q(a.model.y[None])[0])
    assert q1 > q0  # never regress
    # exactly one knot moved (the combined move was rejected)
    assert (np.abs(a.model.y - y0) > 1e-9).sum() == 1


# -- unified M-step (round-5: one coarse dispatch + one f64 decision) ------

class FakeAnalysisRho(FakeAnalysis):
    """FakeAnalysis plus a rho term: Q -= wr * (log rho - log rho_opt)^2."""

    def __init__(self, K=4, opt=None, w=None, rho_opt=0.02, wr=1.0):
        super().__init__(K=K, opt=opt, w=w)
        self.rho = 0.01
        self._theta = 0.01
        self.rho_opt = rho_opt
        self.wr = wr

    def Q_batch(self, ys=None, rhos=None, coarse=False):
        if ys is None:
            ys = np.tile(self.model.y, (len(rhos), 1))
        self.calls.append((np.asarray(ys, float).copy(), bool(coarse)))
        v = self._q(ys)
        if rhos is not None:
            r = np.asarray(rhos, float)
            v = v - self.wr * (np.log(r) - np.log(self.rho_opt)) ** 2
        else:
            v = v - self.wr * (np.log(self.rho) - np.log(self.rho_opt)) ** 2
        if coarse and self.coarse_value is not None:
            v = np.full_like(v, self.coarse_value)
        return v


def test_unified_steady_state_dispatch_count():
    """With converged radii a moving round is one coarse dispatch + one
    f64 decision batch (+ combined check), plus ONE verification round
    (coarse only) that finds nothing left — the multi-round policy that
    restored the 1 Gbp fit quality (see _unified_mstep docstring)."""
    o = make_opt(FakeAnalysis(K=4))
    a = o._analysis
    r = _converged_radius(o)
    a.model.y[:] = 1.5 - 0.4 * r
    o._radius = {k: r for k in range(4)}
    o._radius["scale"] = r
    assert o._unified_mstep()
    coarse_calls = [ys for ys, c in a.calls if c]
    f64_calls = [ys for ys, c in a.calls if not c]
    # one moving round + at most one verification round (no further
    # rounds once nothing moves)
    assert len(coarse_calls) <= 2
    assert len(coarse_calls[0]) == 4 * o._BATCH + o._BATCH  # knots + scale
    assert len(f64_calls) <= 4  # decision + combined, moving round only
    np.testing.assert_allclose(a.model.y, 1.5, atol=2 * o._xtol)


def test_unified_rounds_converge_within_mstep():
    """The round loop reaches the coordinate optimum in ONE M-step even
    from far away (the single-round Jacobi pass left the 1 Gbp fit
    thousands of LL units short and the EM ftol monitor stopped early)."""
    o = make_opt(FakeAnalysis(K=4))
    a = o._analysis
    a.model.y[:] = 0.0  # far from the optimum at 1.5
    assert o._unified_mstep()
    np.testing.assert_allclose(a.model.y, 1.5, atol=3 * o._xtol)


def test_unified_first_iteration_no_radius():
    "Without trust radii (iteration 1) the full +-3 windows still work."
    o = make_opt(FakeAnalysis(K=3, opt=[1.2, -0.8, 0.5]))
    a = o._analysis
    assert o._unified_mstep()
    # at xtol=1e-3 the +-3 coarse bracket is NOT converged -> batched
    # f64 zoom rounds, then the decision batch; everything lands
    np.testing.assert_allclose(a.model.y, a.opt, atol=5 * o._xtol)
    # radii established for the next iteration
    assert {0, 1, 2, "scale"} <= set(o._radius)


def test_unified_zoom_rounds_are_batched():
    "Unconverged scalars zoom together: one f64 dispatch per round."
    o = make_opt(FakeAnalysis(K=4), xtol=1e-4)
    a = o._analysis
    o._radius = {k: 2.0 for k in range(4)}  # wide: zoom needed everywhere
    a.model.y[:] = 1.0
    assert o._unified_mstep()
    # every f64 call must carry MULTIPLE scalars' grids (no per-scalar
    # sequential dispatches): width > one zoom grid
    f64_calls = [ys for ys, c in a.calls if not c]
    zooms = [ys for ys in f64_calls if len(ys) > o._BATCH_ZOOM]
    assert zooms, "expected batched zoom rounds"
    np.testing.assert_allclose(a.model.y, 1.5, atol=5e-3)


def test_unified_learn_rho_updates_rho():
    "The rho scalar rides the same machinery and updates a.rho."
    o = make_opt(FakeAnalysisRho(K=2, rho_opt=0.02))
    o._learn_rho = True
    a = o._analysis
    a.model.y[:] = 1.5  # knots already optimal
    assert o._unified_mstep()
    assert abs(np.log(a.rho) - np.log(0.02)) < 0.05
    assert "rho" in o._radius


def test_unified_rejects_nonimproving_candidates():
    "Stale coarse values position candidates; f64 decides — no regression."
    o = make_opt(FakeAnalysis(K=2))
    a = o._analysis
    r = _converged_radius(o)
    shift = 0.3 * r
    orig = a.Q_batch

    def q_batch(ys=None, rhos=None, coarse=False):
        if coarse:
            return orig(ys=np.asarray(ys, float) - shift, coarse=True)
        return orig(ys=ys, rhos=rhos, coarse=coarse)

    a.Q_batch = q_batch
    a.model.y[:] = 1.5  # at the optimum already
    o._radius = {k: r for k in range(2)}
    assert o._unified_mstep()
    np.testing.assert_allclose(a.model.y, 1.5, atol=1e-12)


def test_unified_combined_falls_back_to_best_single():
    "Coupled knots: combined move rejected, best single applied."

    class Coupled(FakeAnalysis):
        def _q(self, ys):
            ys = np.atleast_2d(np.asarray(ys, float))
            return -((ys[:, 0] + ys[:, 1] - 1.0) ** 2)

    o = make_opt(Coupled(K=2))
    a = o._analysis
    r = _converged_radius(o)
    y0 = 0.5 + 0.45 * r
    a.model.y[:] = [y0, y0]
    o._radius = {k: r for k in range(2)}
    q0 = float(a._q(a.model.y[None])[0])
    assert o._unified_mstep()
    q1 = float(a._q(a.model.y[None])[0])
    assert q1 > q0


def test_unified_env_off(monkeypatch):
    monkeypatch.setenv("SMCPP_JAX_UNIFIED_MSTEP", "0")
    o = make_opt(FakeAnalysis(K=2))
    assert not o._unified_mstep()


def test_unified_requires_fast_batch():
    a = FakeAnalysis(K=2)
    a.has_fast_batch = False
    assert not make_opt(a)._unified_mstep()


def test_unified_all_nonfinite_coarse_proposes_nothing():
    "A scalar whose whole coarse grid is non-finite must not move."
    a = FakeAnalysis(K=2)
    a.coarse_value = -np.inf
    o = make_opt(a)
    y0 = a.model.y.copy()
    assert o._unified_mstep()
    np.testing.assert_array_equal(a.model.y, y0)


def test_ftol_switches_unified_to_sequential_before_terminating():
    """When the ftol monitor trips while the unified M-step is active it
    must SWITCH to the sequential machinery (one more chance at real
    progress) and only terminate once sequential stalls too — the 1 Gbp
    fit regression (round 5) was the unified pass tripping ftol on
    iteration one."""
    from smcpp_jax.inference.optimizer import EMTerminationException

    o = make_opt(FakeAnalysis(K=2))
    o._unified_used = True
    o._check_termination(-1000.0)
    # sub-ftol improvement: first trip switches, second terminates
    o._check_termination(-999.99)
    assert o._force_sequential
    assert not o._unified_mstep()  # unified now defers to sequential
    with pytest.raises(EMTerminationException):
        o._check_termination(-999.98)
