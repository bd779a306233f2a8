"""Transition-matrix correctness.

Oracles: (1) scipy.linalg.expm for the closed-form 3x3 exponential;
(2) an independent, loop-based NumPy reimplementation of the HJ transition
(following the math, not the vectorization) for the full Phi; (3) structural
invariants (row sums, floors, smoothing); (4) FD gradient checks.
"""

import jax
import numpy as np
import scipy.linalg

from smcpp_jax import defaults
from smcpp_jax.ops import grid as gridmod, ratefunc, transition

A_RHO = np.array([[-1.0, 1, 0], [0, 0, 0], [0, 0, 0]])
A_ETA = np.array([[0.0, 0, 0], [1, -2, 1], [0, 0, 0]])


def test_expm_closed_form():
    rng = np.random.RandomState(0)
    for _ in range(20):
        c_rho = rng.uniform(0, 3)
        c_eta = rng.uniform(1e-4, 4)
        got = np.array(transition.expm_recomb(c_rho, c_eta))
        want = scipy.linalg.expm(c_rho * A_RHO + c_eta * A_ETA)
        np.testing.assert_allclose(got, want, atol=1e-12)


def reference_phi(a, s, hs, rho):
    "Loop-based HJ transition (correct cumulative-rate bookkeeping)."
    g = gridmod.make_time_grid(s, hs)
    ada = (1.0 / np.asarray(a))[g.src]
    ts = g.ts
    K = g.K
    dt = np.diff(ts)
    Rr = np.concatenate([[0.0], np.cumsum(ada[:-1] * dt[:-1])])
    Rr = np.append(Rr, np.inf)  # R at grid points, R(inf) = inf

    # per-piece expms and prefix products
    E = [None] * K
    for k in range(K):
        if np.isinf(ts[k + 1]):
            E[k] = np.array([[0.0, 0, 1], [0, 0, 1], [0, 0, 1]])
        else:
            E[k] = scipy.linalg.expm(rho * dt[k] * A_RHO + ada[k] * dt[k] * A_ETA)
    P = [np.eye(3)]
    for k in range(K):
        P.append(P[-1] @ E[k])

    H = g.hs_indices
    M = g.M
    act = np.array(ratefunc.average_coal_times(np.asarray(a), g))
    Phi = np.zeros((M, M))
    # below diagonal
    expm_diff = np.array([P[H[k]][0, 2] - P[H[k - 1]][0, 2] for k in range(1, M)])
    for j in range(1, M + 1):
        Phi[j - 1, : j - 1] = expm_diff[: j - 1]
        rct = act[j - 1]
        ip = min(np.searchsorted(ts, rct, side="right") - 1, K - 1)
        delta = rct - ts[ip]
        B = P[ip] @ scipy.linalg.expm(
            rho * delta * A_RHO + ada[ip] * delta * A_ETA
        )
        R_rct = Rr[ip] + ada[ip] * delta
        Rj = Rr[H[j]] - R_rct  # R(hs_j) - R(rct); inf if j == M
        p_float = B[0, 1] * (0.0 if np.isinf(Rj) else np.exp(-Rj))
        if j == M:
            p_float = 0.0
        for k in range(j + 1, M + 1):
            inc = Rr[H[k]] - Rr[H[k - 1]]
            p_coal = np.exp(-(Rr[H[k - 1]] - Rr[H[j]]))
            if not np.isinf(inc):
                p_coal *= -np.expm1(-inc)
            Phi[j - 1, k - 1] += p_float * p_coal
        Phi[j - 1, j - 1] = 0.0
        Phi[j - 1, j - 1] = 1.0 - Phi[j - 1].sum()
    Phi = np.maximum(Phi, 1e-20)
    beta = 1e-5
    return Phi * (1 - beta) + beta / (M + 1)


def test_phi_matches_loop_reference():
    rng = np.random.RandomState(1)
    s = rng.uniform(0.05, 0.5, 8)
    a = rng.uniform(0.3, 4.0, 8)
    hs = np.array([0.0, 0.15, 0.45, 0.9, 1.6, np.inf])
    g = gridmod.make_time_grid(s, hs)
    rho = 1.7e-2
    got = np.array(transition.transition_matrix(a, rho, g))
    want = reference_phi(a, s, hs, rho)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-14)


def test_phi_structure():
    rng = np.random.RandomState(2)
    s = rng.uniform(0.05, 0.5, 10)
    a = rng.uniform(0.1, 8.0, 10)
    hs = np.array([0.0, 0.1, 0.3, 0.7, 1.2, 2.0, 4.0, np.inf])
    g = gridmod.make_time_grid(s, hs)
    M = g.M
    Phi = np.array(transition.transition_matrix(a, 1e-2, g))
    assert Phi.shape == (M, M)
    # rows sum to ~1 (up to floor/beta adjustments)
    np.testing.assert_allclose(Phi.sum(axis=1), 1.0, atol=1e-4)
    assert np.all(Phi >= defaults.transition_beta / (M + 1) * 0.999)
    # diagonal dominates for small rho
    assert np.all(np.argmax(Phi, axis=1) == np.arange(M))


def test_phi_gradient_fd():
    rng = np.random.RandomState(3)
    s = rng.uniform(0.05, 0.5, 6)
    a = rng.uniform(0.3, 4.0, 6)
    hs = np.array([0.0, 0.3, 0.9, 2.0, np.inf])
    g = gridmod.make_time_grid(s, hs)
    rho = 2e-2

    def f(av):
        return jax.numpy.sum(
            jax.numpy.log(transition.transition_matrix(av, rho, g))
        )

    ga = np.array(jax.grad(f)(a))
    assert np.all(np.isfinite(ga))
    eps = 1e-6
    for i in range(len(a)):
        ap, am = a.copy(), a.copy()
        ap[i] += eps
        am[i] -= eps
        fd = (float(f(ap)) - float(f(am))) / (2 * eps)
        assert np.isclose(ga[i], fd, rtol=2e-4, atol=1e-7), i


def test_phi_m1_degenerate():
    "hs = [0, inf] (stage-1 warm start) must give the 1x1 matrix [~1]."
    s = np.r_[1.0, np.zeros(5)]
    a = np.full(6, 2.0)
    g = gridmod.make_time_grid(s, np.array([0.0, np.inf]))
    Phi = np.array(transition.transition_matrix(a, 1e-2, g))
    assert Phi.shape == (1, 1)
    assert np.isclose(Phi[0, 0], 1.0, atol=1e-4)
