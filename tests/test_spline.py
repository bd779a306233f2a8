import jax
import numpy as np
import pytest

from smcpp_jax.models import spline as sp
from smcpp_jax.models.model import SMCModel, model_from_dict


KNOTS = np.array([0.1, 0.3, 0.9, 2.7, 8.1])
Y = np.array([0.5, -0.2, 0.3, 0.8, -0.1])


@pytest.mark.parametrize("cls", [sp.Piecewise, sp.CubicSpline, sp.PChipSpline, sp.AkimaSpline])
def test_interpolates_knots(cls):
    s = cls(KNOTS)
    vals = np.array(s(Y, KNOTS))
    np.testing.assert_allclose(vals, Y, atol=1e-10)


@pytest.mark.parametrize("cls", [sp.CubicSpline, sp.PChipSpline, sp.AkimaSpline])
def test_c1_continuity(cls):
    s = cls(KNOTS)
    eps = 1e-7
    for k in KNOTS[1:-1]:
        lo = np.array(s(Y, [k - eps]))[0]
        hi = np.array(s(Y, [k + eps]))[0]
        assert np.isclose(lo, hi, atol=1e-5)
        dlo = (np.array(s(Y, [k - eps]))[0] - np.array(s(Y, [k - 2 * eps]))[0]) / eps
        dhi = (np.array(s(Y, [k + 2 * eps]))[0] - np.array(s(Y, [k + eps]))[0]) / eps
        assert np.isclose(dlo, dhi, atol=1e-3)


def test_cubic_c2_continuity():
    "Second derivative continuous at interior knots (from the coefficients)."
    s = sp.CubicSpline(KNOTS)
    coef = np.array(s.coefficients(Y))
    h = np.diff(KNOTS)
    for i in range(1, len(KNOTS) - 1):
        d2_left = 6 * coef[0, i - 1] * h[i - 1] + 2 * coef[1, i - 1]
        d2_right = 2 * coef[1, i]
        assert np.isclose(d2_left, d2_right, atol=1e-9), i


@pytest.mark.parametrize("cls", [sp.Piecewise, sp.CubicSpline, sp.PChipSpline, sp.AkimaSpline])
def test_flat_extrapolation(cls):
    s = cls(KNOTS)
    assert np.isclose(float(s(Y, [1e-3])[0]), Y[0])
    assert np.isclose(float(s(Y, [100.0])[0]), Y[-1])


def test_pchip_monotone():
    ym = np.array([0.0, 0.5, 0.7, 2.0, 2.1])
    s = sp.PChipSpline(KNOTS)
    q = np.linspace(KNOTS[0], KNOTS[-1], 200)
    v = np.array(s(ym, q))
    assert np.all(np.diff(v) >= -1e-9)


@pytest.mark.parametrize("cls", [sp.Piecewise, sp.CubicSpline, sp.PChipSpline, sp.AkimaSpline])
def test_grad_and_roughness(cls):
    s = cls(KNOTS)
    q = np.linspace(0.05, 9.0, 13)
    # strictly monotone knot values keep pchip/akima away from their
    # discontinuous sign-switch boundaries (where FD is meaningless)
    Y = np.array([0.1, 0.3, 0.8, 1.5, 1.9])

    def f(y):
        return (s(y, q) ** 2).sum() + s.roughness(y)

    g = np.array(jax.grad(f)(Y))
    assert np.all(np.isfinite(g))
    eps = 1e-6
    for i in range(len(Y)):
        yp, ym_ = Y.copy(), Y.copy()
        yp[i] += eps
        ym_[i] -= eps
        fd = (float(f(yp)) - float(f(ym_))) / (2 * eps)
        assert np.isclose(g[i], fd, rtol=1e-4, atol=1e-7), (cls, i)


def test_model_roundtrip():
    m = SMCModel(KNOTS, 10000.0, "cubic", pid="pop1")
    m.y = Y.copy()
    d = m.to_dict()
    assert d["spline_class"] == "CubicSpline"
    m2 = model_from_dict(d)
    np.testing.assert_allclose(m2.stepwise_values(), m.stepwise_values())
    assert len(m.s) == 100
    sv = m.stepwise_values()
    assert np.all(sv >= 1e-3) and np.all(sv <= 1e3)


def test_bspline():
    s = sp.BSpline(KNOTS)
    y = s.fit_to(np.log(np.array([1.0, 1.5, 2.0, 1.2, 0.8])))
    assert len(y) == len(KNOTS) + 2
    vals = np.array(s(y, KNOTS))
    np.testing.assert_allclose(
        np.exp(vals), [1.0, 1.5, 2.0, 1.2, 0.8], rtol=0.15
    )
    # flat extrapolation
    assert np.isclose(float(s(y, [1e-3])[0]), vals[0], atol=1e-8)
    assert np.isclose(float(s(y, [100.0])[0]), vals[-1], atol=1e-8)
    # grads
    g = np.array(jax.grad(lambda yy: (s(yy, np.linspace(0.2, 5, 7)) ** 2).sum())(y))
    assert np.all(np.isfinite(g))
