"""Traced JCSFS pipeline (ops/jcsfs_traced.py) vs the eager path.

The traced pipeline must reproduce the eager JointCSFS (ops/jcsfs.py) and
the eager manager tensors() — including the reference's for_pop pop-2
splice semantics (/root/reference/smcpp/_smcpp.pyx:363) — across split
positions below / inside / above the hidden-state range, for both the
together (a1=2) and apart (a1=a2=1) configurations.  The one documented
deviation is the exact eps->0 below-at-split limit (vs the eager two-sided
1e-6 interval), bounded here at 1e-6 relative on significant entries.
"""

import os

import numpy as np
import pytest

from smcpp_jax.inference import estimation
from smcpp_jax.inference.manager import TwoPopInferenceManager
from smcpp_jax.models import SMCModel, SMCTwoPopulationModel

N1, N2 = 4, 3


def _models():
    m1 = SMCModel(np.logspace(-2, np.log10(3.0), 5), 2e4, "pchip",
                  pid="pop1")
    m1.y[:] = np.sin(np.linspace(0, 2.0, len(m1.y))) * 0.4
    m2 = SMCModel(np.logspace(-2, np.log10(3.0), 5), 2e4, "pchip",
                  pid="pop2")
    m2.y[:] = 0.2
    return m1, m2


def _manager(a1, a2, M, split):
    rng = np.random.RandomState(11)
    n_rows = 300
    data = np.zeros((n_rows, 7), dtype=np.int32)
    data[:, 0] = rng.randint(20, 400, n_rows)
    data[:, 1] = rng.randint(0, a1 + 1, n_rows)
    data[:, 3] = N1
    data[:, 2] = rng.randint(0, N1 + 1, n_rows)
    data[:, 4] = -1 if a2 == 0 else rng.randint(0, a2 + 1, n_rows)
    data[:, 6] = N2
    data[:, 5] = rng.randint(0, N2 + 1, n_rows)
    m1, m2 = _models()
    jm = SMCTwoPopulationModel(m1, m2, split)
    hs = estimation.balance_hidden_states(m1, M + 1)
    im = TwoPopInferenceManager(
        N1, N2, a1, a2, [data], hs, ("pop1", "pop2"), 0.5
    )
    im.set_model(jm)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    return im


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
@pytest.mark.parametrize("split", [0.005, 0.25, 2.0])
def test_traced_joint_csfs_matches_eager(a1, a2, split):
    "Raw J tensors: identical marginal inputs -> ~fp-exact agreement."
    from smcpp_jax.ops.jcsfs import JointCSFS
    from smcpp_jax.ops.jcsfs_traced import TracedJointCSFS

    m1, m2 = _models()
    a1v = np.asarray(m1.stepwise_values())
    a2v = np.asarray(m2.stepwise_values())
    hs = np.asarray(estimation.balance_hidden_states(m1, 7))
    J_e = JointCSFS(N1, N2, a1, a2, hs, K=10).compute(
        (a1v, m1.s), (a2v, m2.s), split
    )
    J_t = np.asarray(
        TracedJointCSFS(N1, N2, a1, a2, m1.s, m2.s, hs, K=10).compute(
            a1v, a2v, split
        )
    )
    assert np.all(np.isfinite(J_t))
    sig = np.abs(J_e) > 1e-8
    rel = np.abs(J_t - J_e) / np.maximum(np.abs(J_e), 1e-12)
    # documented deviation (below-at-split limit) bounded at 1e-6
    assert rel[sig].max() < 1e-6
    np.testing.assert_allclose(J_t, J_e, atol=1e-9)


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
@pytest.mark.parametrize("split,M", [(0.25, 6), (0.005, 6), (2.0, 6),
                                     (0.9999999, 8)])
def test_traced_tensors_match_eager(a1, a2, split, M):
    "Manager tensors(): traced == eager incl. the pop-2 splice semantics."
    im = _manager(a1, a2, M, split)
    os.environ["SMCPP_JAX_TRACED_JCSFS"] = "0"
    try:
        pi_e, T_e, E_e = [np.asarray(x) for x in im.tensors()]
    finally:
        os.environ.pop("SMCPP_JAX_TRACED_JCSFS", None)
    assert im._traced_tensors_ok()
    pi_t, T_t, E_t = [np.asarray(x) for x in im.tensors()]

    np.testing.assert_allclose(pi_t, pi_e, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(E_t, E_e, rtol=1e-6, atol=1e-12)
    # T rows from zero-mass intervals (pi ~ floor) are numerically
    # arbitrary in both paths (near-0/0 average coal times); weight by pi
    np.testing.assert_allclose(
        pi_t[:, None] * T_t, pi_e[:, None] * T_e, rtol=1e-6, atol=1e-12
    )


@pytest.mark.parametrize("a1,a2", [(2, 0), (1, 1)])
def test_traced_estep_loglik_matches_eager(a1, a2):
    im = _manager(a1, a2, 6, 0.25)
    os.environ["SMCPP_JAX_TRACED_JCSFS"] = "0"
    try:
        ll_e = im.E_step()
        stats_e = [np.asarray(s) for s in im._stats]
    finally:
        os.environ.pop("SMCPP_JAX_TRACED_JCSFS", None)
    ll_t = im.E_step()
    stats_t = [np.asarray(s) for s in im._stats]
    assert np.isclose(ll_t, ll_e, rtol=1e-8)
    for a, b in zip(stats_t, stats_e):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


def test_traced_cache_no_retrace_on_split_or_y():
    """Split / y changes within the same grid fingerprint reuse one trace
    (the M-step's split search must not retrace per candidate)."""
    im = _manager(2, 0, 6, 0.25)
    im.tensors()
    assert len(im._traced_cache) == 1
    im.model.split = 0.4
    im.model.model1.y[:] += 0.01
    pi, T, E = im.tensors()
    assert len(im._traced_cache) == 1
    assert np.all(np.isfinite(np.asarray(E)))


def test_traced_env_revert():
    "SMCPP_JAX_TRACED_JCSFS=0 reverts to the eager path."
    im = _manager(2, 0, 6, 0.25)
    os.environ["SMCPP_JAX_TRACED_JCSFS"] = "0"
    try:
        assert not im._traced_tensors_ok()
    finally:
        os.environ.pop("SMCPP_JAX_TRACED_JCSFS", None)
    assert im._traced_tensors_ok()
