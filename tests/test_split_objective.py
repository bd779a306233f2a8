"""Traced-grid differentiable split objective (VERDICT r1 item 9).

Three layers of oracle:

* J-tensor parity: the traced ``_j_together`` / ``_j_apart`` fed the SAME
  marginal params as the eager ``JointCSFS.compute`` must agree to ~1e-8
  (the only residual is the eager path's two-sided 1e-6 below-at-split
  interval, which the traced path replaces with its exact limit).
* manager-level Q parity: the traced objective deviates from the eager Q
  only through the documented raw-model2 vs spliced-marginal difference
  (ops/split_objective.py module docstring) — a few 1e-4 relative.
* gradients: d Q / d split matches central finite differences.
"""

import numpy as np
import jax
import pytest

from smcpp_jax.ops import jcsfs as jmod
from smcpp_jax.ops.split_objective import (
    MarginalSplitObjective,
    SplitObjective,
    _StaticEta,
    _leggauss01,
    _undist_matrix,
)

MODEL1 = (np.array([1.0, 4.0]), np.array([0.5, 1.0]))
MODEL2 = (np.array([2.0, 4.0, 2.0]), np.array([0.1, 0.2, 0.3]))


def _stub(a1, a2, n1, n2, K=16):
    "SplitObjective with only the J-tensor machinery populated."
    so = SplitObjective.__new__(SplitObjective)
    so.n1, so.n2, so.a1, so.a2 = n1, n2, a1, a2
    so.theta, so.alpha = 1e-4, 1
    so.eta1 = _StaticEta(*MODEL1)
    so.eta2 = _StaticEta(*MODEL2)
    ref = jmod.JointCSFS(n1, n2, a1, a2, [0.0, np.inf], K=K)
    so.hyp1, so.hyp2 = ref.hyp1, ref.hyp2
    so.S0, so.S2, so.Sn1 = ref.S0, ref.S2, ref.Sn1
    so.quad_u, so.quad_w = _leggauss01(K)
    so._U_n1 = _undist_matrix(n1)
    so._U_n12m1 = _undist_matrix(n1 + n2 - 1)
    if n2 >= 2:
        so._U_n2m2 = _undist_matrix(n2 - 2)
    if a1 == 1:
        so._U_n1m1 = _undist_matrix(n1 - 1)
        so._U_n2m1 = _undist_matrix(n2 - 1)
    return so, ref


@pytest.mark.parametrize(
    "a1,a2,n1,n2", [(2, 0, 5, 8), (1, 1, 4, 5)],
    ids=["together", "apart"],
)
def test_traced_j_matches_eager(a1, a2, n1, n2):
    so, ref = _stub(a1, a2, n1, n2)
    fn = jax.jit(so._j_together if a1 == 2 else so._j_apart)
    for split in [0.05, 0.3, 0.8, 2.0]:
        Jt = np.maximum(np.asarray(fn(split)), 1e-20)
        v = Jt.reshape(1, a1 + 1, n1 + 1, a2 + 1, n2 + 1).copy()
        v[:, 0, 0, 0, 0] = 0.0
        v[:, a1, n1, a2, n2] = 0.0
        Jt = v.reshape(Jt.shape)
        Je = ref.compute(MODEL1, MODEL2, split)
        np.testing.assert_allclose(Jt, Je, rtol=1e-6, atol=1e-8)


def _make_joint_setup(split=0.4):
    from smcpp_jax.inference.manager import TwoPopInferenceManager
    from smcpp_jax.models import SMCModel, SMCTwoPopulationModel

    rng = np.random.RandomState(5)
    n1 = n2 = 3
    rows = 60
    data = []
    for _ in range(3):
        d = np.c_[
            rng.randint(1, 50, rows),
            rng.randint(0, 3, rows), rng.randint(0, n1 + 1, rows),
            np.full(rows, n1),
            np.zeros(rows), rng.randint(0, n2 + 1, rows),
            np.full(rows, n2),
        ].astype(np.int64)
        data.append(d)
    hs = np.array([0.0, np.inf])
    im = TwoPopInferenceManager(n1, n2, 2, 0, data, hs, ("p1", "p2"), 0.5)
    knots = np.array([0.05, 0.2, 0.8, 3.0])
    m1 = SMCModel(knots, 2e4, "piecewise", "p1")
    m1.y[:] = 0.1
    m2 = SMCModel(knots, 2e4, "piecewise", "p2")
    m2.y[:] = -0.2
    model = SMCTwoPopulationModel(m1, m2, split)
    im.set_model(model)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    im.E_step()
    return im, model


def test_manager_q_batch_close_to_eager():
    im, model = _make_joint_setup()
    so = im.split_objective()
    splits = np.array([0.05, 0.2, 0.5, 1.0, 2.0])
    qt = so.q_batch(splits)
    qe = np.array(
        [
            (setattr(model, "split", float(s)), im.Q())[1]
            for s in splits
        ]
    )
    # raw-model2 vs spliced-marginal deviation only (module docstring)
    np.testing.assert_allclose(qt, qe, rtol=1e-3)


def test_split_grad_matches_fd():
    im, _ = _make_joint_setup()
    so = im.split_objective()
    for s in (0.15, 0.5, 1.2):
        v, g = so.q_and_grad(s)
        eps = 1e-5
        v1, _ = so.q_and_grad(s + eps)
        v0, _ = so.q_and_grad(s - eps)
        fd = (v1 - v0) / (2 * eps)
        assert np.isclose(g, fd, rtol=1e-4), (s, g, fd)


def _make_marginal_setup(split=0.4):
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.models import SMCModel, SMCTwoPopulationModel

    rng = np.random.RandomState(7)
    n = 4
    rows = 50
    data = [
        np.c_[
            rng.randint(1, 40, rows), rng.randint(0, 3, rows),
            rng.randint(0, n + 1, rows), np.full(rows, n),
        ].astype(np.int64)
        for _ in range(2)
    ]
    hs = np.array([0.0, np.inf])
    im = OnePopInferenceManager(n, data, hs, ("p2",), 0.5)
    knots = np.array([0.05, 0.2, 0.8, 3.0])
    m1 = SMCModel(knots, 2e4, "piecewise", "p1")
    m1.y[:] = 0.1
    m2 = SMCModel(knots, 2e4, "piecewise", "p2")
    m2.y[:] = -0.2
    model = SMCTwoPopulationModel(m1, m2, split)
    im.set_model(model)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    im.E_step()
    return im, model


def test_marginal_split_objective_matches_eager():
    im, model = _make_marginal_setup()
    mo = im.marginal_split_objective()
    splits = np.array([0.1, 0.3, 0.7, 1.5])
    qt = mo.q_batch(splits)
    qe = np.array(
        [
            (setattr(model, "split", float(s)), im.Q())[1]
            for s in splits
        ]
    )
    # static-grid splice vs eager spline re-fit: small discretization gap
    np.testing.assert_allclose(qt, qe, rtol=2e-3)
    # gradient sanity
    v, g = mo.q_and_grad(0.5)
    eps = 1e-5
    v1, _ = mo.q_and_grad(0.5 + eps)
    v0, _ = mo.q_and_grad(0.5 - eps)
    assert np.isclose(g, (v1 - v0) / (2 * eps), rtol=1e-3, atol=1e-3)
