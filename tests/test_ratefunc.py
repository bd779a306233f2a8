"""Rate-function correctness: closed forms vs direct numerical quadrature.

This mirrors the reference's finite-difference/quadrature validation strategy
(test/unit/test_rate_function.py) but checks against scipy.integrate instead
of printouts.
"""

import jax
import numpy as np
import pytest
import scipy.integrate

from smcpp_jax.ops import grid as gridmod
from smcpp_jax.ops import ratefunc


def nC2(v):
    return v * (v - 1) / 2


@pytest.fixture
def setup():
    rng = np.random.RandomState(0)
    K = 7
    s = np.r_[0.05, rng.uniform(0.05, 0.5, K - 1)]
    a = rng.uniform(0.2, 5.0, K)
    hs = np.array([0.0, 0.1, 0.5, 1.0, 2.5, np.inf])
    g = gridmod.make_time_grid(s, hs)
    return a, s, hs, g




def quad(f, lo, hi, ts):
    "Quadrature with breakpoints at the piece boundaries."
    pts = [x for x in ts if lo < x < hi and np.isfinite(x)]
    v, _ = scipy.integrate.quad(f, lo, hi, limit=400, points=pts or None)
    return v

def host_R(a, s):
    return ratefunc.HostRateFunction(a, s).R


def test_cumulative_rate_matches_host(setup):
    a, s, hs, g = setup
    Rr = np.array(ratefunc.cumulative_rate(ratefunc.ada_on_grid(a, g), g))
    R = host_R(a, s)
    for i, t in enumerate(g.ts[:-1]):
        assert np.isclose(Rr[i], R(t), rtol=1e-12), (i, t)


def test_initial_distribution(setup):
    a, s, hs, g = setup
    pi = np.array(ratefunc.initial_distribution(a, g))
    R = host_R(a, s)
    expected = np.array(
        [
            np.exp(-R(hs[m])) - (0.0 if np.isinf(hs[m + 1]) else np.exp(-R(hs[m + 1])))
            for m in range(len(hs) - 1)
        ]
    )
    expected /= expected.sum()
    np.testing.assert_allclose(pi, expected, rtol=1e-12)
    assert np.isclose(pi.sum(), 1.0)


def test_average_coal_times(setup):
    a, s, hs, g = setup
    act = np.array(ratefunc.average_coal_times(a, g))
    R = host_R(a, s)
    eta = ratefunc.HostRateFunction(a, s)

    def density(t):
        ip = min(np.searchsorted(eta.ts, t, side="right") - 1, len(eta.ada) - 1)
        return eta.ada[ip] * np.exp(-R(t))

    for m in range(len(hs) - 1):
        lo, hi = hs[m], hs[m + 1]
        ub = hi if np.isfinite(hi) else 60.0
        num = quad(lambda t: t * density(t), lo, ub, eta.ts[:-1])
        den = quad(density, lo, ub, eta.ts[:-1])
        assert np.isclose(act[m], num / den, rtol=1e-6), m
        assert hs[m] <= act[m] <= hs[m + 1]


def test_tjj_below_quadrature(setup):
    """tjj_below[h, j-2] must equal
    E[ int_0^T exp(-rate R(t)) dt | T in interval h ], rate = C(j,2)-1.

    Derivation of the reference quantity: for the below integrals the outer
    variable is the coalescence time T with density eta(T) e^{-R(T)}
    restricted to the hidden interval, and the inner integral accumulates
    exp(-rate * R(t)) over t in [0, T]  (conditioned_sfs.cpp:12-39 pairs these
    with the M0/M1 Moran matrices).
    """
    a, s, hs, g = setup
    n = 4
    out = np.array(ratefunc.tjj_below(a, g, n))
    eta = ratefunc.HostRateFunction(a, s)
    R = eta.R

    def density(t):
        ip = min(np.searchsorted(eta.ts, t, side="right") - 1, len(eta.ada) - 1)
        return eta.ada[ip] * np.exp(-R(t))

    for h in range(len(hs) - 1):
        lo, hi = hs[h], hs[h + 1]
        ub = hi if np.isfinite(hi) else 60.0
        den = quad(density, lo, ub, eta.ts[:-1])
        for idx, j in enumerate(range(2, n + 3)):
            rate = nC2(j) - 1

            def inner(T):
                return quad(lambda t: np.exp(-rate * R(t)), 0.0, T, eta.ts[:-1])

            num = quad(lambda T: inner(T) * density(T), lo, ub, eta.ts[:-1])
            assert np.isclose(out[h, idx], num / den, rtol=1e-5), (h, j)


def test_tjj_above_quadrature(setup):
    """tjj_above[h, jj-2, j-2] must equal (derived from the closed forms at
    piecewise_constant_rate_function.cpp:108-138 by integrating each piece):

      (1/P(h)) * int_{hs_h}^{hs_{h+1}} dT eta(T) e^{-(lam+1) R(T)}
                 * int_T^inf dt e^{-rate (R(t) - R(T))}

    with lam = C(jj,2) - 1, rate = C(j,2).  Note the outer weight carries the
    extra e^{-lam R(T)} Moran decay factor relative to the coalescent density.
    """
    a, s, hs, g = setup
    n = 3
    out = np.array(ratefunc.tjj_above(a, g, n))
    eta = ratefunc.HostRateFunction(a, s)
    R = eta.R

    def density(T):
        ip = min(np.searchsorted(eta.ts, T, side="right") - 1, len(eta.ada) - 1)
        return eta.ada[ip] * np.exp(-R(T))

    UB = 80.0
    for h in range(len(hs) - 1):
        lo, hi = hs[h], hs[h + 1]
        ub = hi if np.isfinite(hi) else UB
        den = quad(density, lo, ub, eta.ts[:-1])
        for jj in range(2, n + 3):
            lam = nC2(jj) - 1
            for j in range(2, n + 2):
                rate = nC2(j)

                def outer(T):
                    RT = R(T)
                    inner = quad(
                        lambda t: np.exp(-rate * (R(t) - RT)), T, UB, eta.ts[:-1]
                    )
                    return density(T) * np.exp(-lam * RT) * inner

                num = quad(outer, lo, ub, eta.ts[:-1])
                got = out[h, jj - 2, j - 2]
                assert np.isclose(got, num / den, rtol=1e-4), (h, jj, j)


def test_tjj_gradients_finite(setup):
    a, s, hs, g = setup
    n = 4

    def f(av):
        return ratefunc.tjj_below(av, g, n).sum() + ratefunc.tjj_above(
            av, g, n
        ).sum()

    ga = np.array(jax.grad(f)(a))
    assert np.all(np.isfinite(ga))
    # finite-difference check
    eps = 1e-6
    for i in range(len(a)):
        ap = a.copy()
        ap[i] += eps
        am = a.copy()
        am[i] -= eps
        fd = (f(ap) - f(am)) / (2 * eps)
        assert np.isclose(ga[i], fd, rtol=1e-4, atol=1e-8), i


def test_degenerate_zero_width_pieces():
    "Stage-1 warm-start models have zero-width pieces; nothing may NaN."
    s = np.r_[1.0, np.zeros(9)]
    a = np.full(10, 2.0)
    hs = np.array([0.0, 0.7, 1.9, np.inf])
    g = gridmod.make_time_grid(s, hs)
    pi = np.array(ratefunc.initial_distribution(a, g))
    assert np.all(np.isfinite(pi))
    act = np.array(ratefunc.average_coal_times(a, g))
    assert np.all(np.isfinite(act))
    tb = np.array(ratefunc.tjj_below(a, g, 3))
    ta = np.array(ratefunc.tjj_above(a, g, 3))
    assert np.all(np.isfinite(tb)) and np.all(np.isfinite(ta))

    ga = np.array(
        jax.grad(lambda av: ratefunc.tjj_below(av, g, 3).sum())(a)
    )
    assert np.all(np.isfinite(ga))
