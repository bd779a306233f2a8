"""CSFS correctness via analytic invariants (the reference's oracle strategy,
test/unit/test_bugs.py:20-35 and test_moran.py):

1. For a constant-size model, the undistinguished SFS entries are 2/k.
2. The a'=1 row of the CSFS sums to 2 * E[TMRCA | interval].
3. The Moran eigendecomposition reconstructs the rate matrix.
"""

import jax
import numpy as np
import scipy.integrate

from smcpp_jax.ops import csfs, exact, grid as gridmod, ratefunc


def moran_dense(n, a, na):
    sub, dia, sup = exact._modified_moran_rate_matrix(n, a, na)
    M = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        M[i, i] = float(dia[i])
        if i > 0:
            M[i, i - 1] = float(sub[i])
        if i < n:
            M[i, i + 1] = float(sup[i])
    return M


def test_moran_eigensystem_reconstruction():
    for n in [2, 5, 11]:
        mei = exact.moran_eigensystem(n)
        M = moran_dense(n, 0, 2)
        recon = mei.U @ np.diag(mei.D) @ mei.Uinv
        np.testing.assert_allclose(recon, M, atol=1e-8)
        np.testing.assert_allclose(mei.Uinv @ mei.U, np.eye(n + 1), atol=1e-9)


def undistinguished_sfs(sfs):
    "Marginalize the (3, n+1) CSFS onto total derived count (util.py:55-70)."
    a_dim = sfs.shape[0] - 1
    n = sfs.shape[1] - 1
    usfs = np.zeros(n + a_dim)
    for i in range(a_dim + 1):
        for j in range(n + 1):
            if 0 <= i + j < n + a_dim:
                usfs[i + j] += sfs[i, j]
    return usfs


def test_constant_model_sfs_invariant():
    """Constant model, full time range: undistinguished SFS = 2/k for k>=1.

    Mirrors test_bugs.py:test_bug2.
    """
    for ntot in [3, 5, 8]:
        n = ntot - 2
        s = np.array([1.0, 1.0, 2.0])
        a = np.ones(3)
        g = gridmod.make_time_grid(s, np.array([0.0, np.inf]))
        out = np.array(csfs.conditioned_sfs(a, g, n))[0]
        undist = undistinguished_sfs(out)
        np.testing.assert_allclose(
            undist[1:], 2.0 / np.arange(1, ntot), rtol=1e-8
        )


def test_row1_sums_to_twice_expected_tmrca():
    "raw_sfs(...).sum(axis=1)[1] == 2 E[T | interval] (test_bugs.py:29-35)."
    s = np.array([1.0, 1.0, 2.0])
    a = np.ones(3)
    ts = [0.0, 0.5, 1.0, 2.0, np.inf]
    for t1, t2 in zip(ts[:-1], ts[1:]):
        g = gridmod.make_time_grid(s, np.array([t1, t2]))
        for n in [0, 2, 7]:
            out = np.array(csfs.conditioned_sfs(a, g, n))[0]
            q, _ = scipy.integrate.quad(lambda t: t * np.exp(-t), t1, t2)
            ans = q / (np.exp(-t1) - np.exp(-t2))
            np.testing.assert_allclose(out.sum(axis=1)[1], 2.0 * ans, rtol=1e-6)


def test_row1_sums_nonconstant_model():
    "Same invariant under a non-trivial size history and multiple intervals."
    rng = np.random.RandomState(1)
    s = rng.uniform(0.1, 0.5, 6)
    a = rng.uniform(0.3, 4.0, 6)
    hs = np.array([0.0, 0.2, 0.8, 1.5, np.inf])
    g = gridmod.make_time_grid(s, hs)
    out = np.array(csfs.conditioned_sfs(a, g, 4))
    act = np.array(ratefunc.average_coal_times(a, g))
    np.testing.assert_allclose(out.sum(axis=2)[:, 1], 2.0 * act, rtol=1e-6)


def test_csfs_nonnegative_and_finite():
    rng = np.random.RandomState(2)
    s = rng.uniform(0.02, 0.4, 12)
    a = rng.uniform(1e-2, 1e2, 12)
    hs = np.array([0.0, 0.05, 0.3, 1.0, 3.0, np.inf])
    g = gridmod.make_time_grid(s, hs)
    out = np.array(csfs.conditioned_sfs(a, g, 10))
    assert np.all(np.isfinite(out))
    assert np.all(out >= -1e-12)


def test_incorporate_theta_distribution():
    rng = np.random.RandomState(3)
    s = rng.uniform(0.05, 0.4, 8)
    a = rng.uniform(0.2, 5.0, 8)
    hs = np.array([0.0, 0.3, 1.2, np.inf])
    g = gridmod.make_time_grid(s, hs)
    bl = csfs.conditioned_sfs(a, g, 5)
    em = np.array(csfs.incorporate_theta(bl, 1e-4))
    assert np.all(em > 0)
    assert np.all(em <= 1)
    np.testing.assert_allclose(em.sum(axis=(1, 2)), 1.0, atol=1e-6)


def test_stable_eigensystem_matches_exact():
    "Stable T-block eigensystem: biorthonormal, reconstructs T, matches D."
    for n in [1, 2, 5, 11, 40]:
        mse = exact.stable_eigensystem(n)
        T = moran_dense(n, 0, 2)[1:, 1:]
        np.testing.assert_allclose(mse.Uinv @ mse.U, np.eye(n), atol=1e-10)
        np.testing.assert_allclose(
            mse.U @ np.diag(mse.D) @ mse.Uinv, T, atol=1e-8
        )
        ks = np.arange(3, n + 3)
        np.testing.assert_allclose(
            mse.D, -(ks * (ks - 1) / 2.0 - 1.0), rtol=1e-12
        )


def test_csfs_large_n_envelope():
    """Large-n accuracy of the f64 CSFS in the stable basis.

    The reference's pipeline passes through the exactly-normalized Moran
    eigenbasis, whose Uinv grows to ~1e44 by n=150; its sorted
    doubly-compensated summation (conditioned_sfs.cpp:55-80) cannot
    recover the amplified input rounding, so it degrades past n ~ 60
    (measured on the old identical formulation here: n=50 -> 7e-5,
    n=55 -> 3e-3, n=60 -> 0.16, n>=65 garbage).  The symmetrized
    eigenbasis + exact below-products keep every constant factor
    O(n)-bounded, so plain f64 holds ~1e-12 through n = 200 — covering
    the reference's "hundreds of unphased whole genomes" paper scale
    (commands/cite.py:8-9) without extended precision."""
    s = np.array([1.0, 1.0, 2.0])
    a = np.ones(3)
    g = gridmod.make_time_grid(s, np.array([0.0, np.inf]))
    for n in [60, 100, 150, 200]:
        out = np.asarray(csfs.conditioned_sfs(a, g, n, xp=np))[0]
        undist = undistinguished_sfs(out)
        np.testing.assert_allclose(undist[1:], 2.0 / np.arange(1, n + 2),
                                   rtol=1e-10)
        assert out.min() >= 0.0


def test_csfs_gradient_fd():
    rng = np.random.RandomState(4)
    s = rng.uniform(0.05, 0.4, 6)
    a = rng.uniform(0.3, 4.0, 6)
    hs = np.array([0.0, 0.4, 1.5, np.inf])
    g = gridmod.make_time_grid(s, hs)

    def f(av):
        return jax.numpy.sum(
            csfs.incorporate_theta(csfs.conditioned_sfs(av, g, 4), 1e-4) ** 2
        )

    ga = np.array(jax.grad(f)(a))
    eps = 1e-6
    for i in range(len(a)):
        ap, am = a.copy(), a.copy()
        ap[i] += eps
        am[i] -= eps
        fd = (f(ap) - f(am)) / (2 * eps)
        assert np.isclose(ga[i], fd, rtol=1e-4, atol=1e-9), i
