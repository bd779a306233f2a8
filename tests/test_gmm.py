"""The empirical-TMRCA mixture (inference/estimation.py:gmm_1d and
mixture_positive_quantiles) that picks `estimate`'s stage-2 hidden
states."""

import numpy as np
import pytest

from smcpp_jax.inference.estimation import gmm_1d, mixture_positive_quantiles


def _counts(seed):
    "Windowed mutation counts: Poisson over gamma-distributed TMRCAs."
    rng = np.random.RandomState(seed)
    return rng.poisson(rng.gamma(2.0, 10.0, size=3000)).astype(float)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantiles_match_sklearn(seed):
    "Quantiles within 15% of sklearn's GaussianMixture + 1e5-draw recipe."
    try:
        import sklearn.mixture
    except ImportError:
        pytest.skip("sklearn not installed")
    import scipy.stats.mstats

    X = _counts(seed)
    k = 16
    p = np.logspace(np.log10(0.01), np.log10(0.99), k)
    ours = mixture_positive_quantiles(*gmm_1d(X, k), p)
    g = sklearn.mixture.GaussianMixture(n_components=k, random_state=seed)
    Y = g.fit(X[:, None]).sample(100000)[0]
    ref = scipy.stats.mstats.mquantiles(Y[Y > 0], p)
    np.testing.assert_allclose(ours, ref, rtol=0.15)


def test_two_component_recovery_and_errors():
    rng = np.random.RandomState(3)
    x = np.r_[rng.normal(5.0, 1.0, 4000), rng.normal(40.0, 3.0, 2000)]
    w, mu, var = gmm_1d(x, 2)
    order = np.argsort(mu)
    np.testing.assert_allclose(w[order], [2 / 3, 1 / 3], atol=0.01)
    np.testing.assert_allclose(mu[order], [5.0, 40.0], atol=0.2)
    np.testing.assert_allclose(np.sqrt(var[order]), [1.0, 3.0], rtol=0.05)
    # deterministic: no hidden random state
    np.testing.assert_array_equal(gmm_1d(x, 2)[1], mu)
    q = mixture_positive_quantiles(w, mu, var, [0.5])
    assert 5.0 < q[0] < 8.0
    with pytest.raises(ValueError):
        gmm_1d(x[:3], 4)
    with pytest.raises(ValueError):
        mixture_positive_quantiles(np.ones(1), np.array([-50.0]),
                                   np.array([1.0]), [0.5])
