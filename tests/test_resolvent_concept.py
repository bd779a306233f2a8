"""Mechanism pins for the large-n CSFS stabilization (implemented in
exact.stable_eigensystem / exact._exact_below_matrices; accuracy pinned by
test_csfs.py::test_csfs_large_n_envelope).

The old pipeline (like the reference, conditioned_sfs.cpp) contracted the
tjj integrals through the EXACT rational Moran eigendecomposition, whose
normalization carries ~1e20-1e44 alternating entries at large n: any f64
rounding of the contracted integrals is amplified into the result, the
mechanism behind the measured n ~ 60 breakdown.  These tests pin the two
facts the fix rests on:

1. the instability is the basis normalization, not the spectral method:
   the same T block is symmetrizable by a polynomially-bounded diagonal,
   so an orthonormal-up-to-D eigenbasis exists with BOTH factors small;
2. the below-path products bc @ diag @ P are O(1)-bounded even though bc
   alone reaches ~1e28, so computing them exactly (rationally) removes
   the other half of the cancellation.
"""

import numpy as np

from smcpp_jax.ops import exact


def test_exact_basis_explodes_stable_basis_does_not():
    """The exact rational normalization is the problem: max|Uinv| ~ 1e13 at
    n=50 already, while the symmetrized basis keeps both U and Uinv
    polynomially bounded at n=150."""
    assert np.abs(exact.moran_eigensystem(50).Uinv).max() > 1e13
    mse = exact.stable_eigensystem(150)
    assert np.abs(mse.U).max() < 1e3
    assert np.abs(mse.Uinv).max() < 1e2
    # and it is still an exact eigenbasis (biorthonormal to f64 precision)
    np.testing.assert_allclose(mse.Uinv @ mse.U, np.eye(150), atol=1e-9)


def test_below_products_bounded_despite_huge_coefficients():
    """bc entries reach ~1e13 by n=50 but the exact products M0/M1 stay
    O(1) — the f64 product would carry ~|bc|max*eps absolute error."""
    n = 50
    bc = exact._below_coeffs(n)
    bcf = np.array([[float(x) for x in row] for row in bc])
    assert np.abs(bcf).max() > 1e12
    mc = exact.cached_matrices(n)
    assert np.abs(mc.M0).max() < 50
    assert np.abs(mc.M1).max() < 50
