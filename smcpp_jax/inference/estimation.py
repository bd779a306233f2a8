"""Estimation utilities: hidden-state balancing and related root finding.

Host-side NumPy (the reference routes these through the C++ rate function;
/root/reference/smcpp/estimation_tools.py:170-233)."""

import numpy as np
import scipy.optimize
import scipy.special
import scipy.stats

from ..ops.ratefunc import HostRateFunction


def balance_hidden_states(model, M):
    """Break points [0, b_1, ..., b_{M-1}, inf) with equal coalescent mass
    under the model.  Returned in coalescent units (the reference returns
    generations and every caller divides by 2 N0 again).

    The coalescent survival function is exp(-R(t)) with R piecewise linear,
    so the equal-mass quantiles come in closed form from R's exact inverse —
    no iterative root finding (the reference brackets + brentqs each one,
    estimation_tools.py:170-197)."""
    eta = HostRateFunction(model.stepwise_values(), model.s)
    pieces = M - 1
    survival = (pieces - np.arange(1, pieces)) / pieces
    interior = np.atleast_1d(eta.Rinv(-np.log(survival)))
    return np.concatenate([[0.0], interior, [np.inf]])


def calculate_t1(model, n, q):
    "Time by which a pair out of n has coalesced with probability q."
    eta = HostRateFunction(model.stepwise_values(), model.s)
    c = n * (n - 1) / 2

    def f(t):
        return np.expm1(-c * eta.R(t)) + q

    return scipy.optimize.brentq(f, 0.0, model.knots[-1])


def extract_pieces(piece_str):
    """Convert a PSMC-style piece string like "32*1+16*2" to piece spans
    (estimation_tools.py:28-38)."""
    pieces = []
    for piece in piece_str.split("+"):
        try:
            num, span = map(int, piece.split("*"))
        except ValueError:
            span = int(piece)
            num = 1
        pieces += [span] * num
    return pieces


def construct_time_points(t1, tK, pieces, offset):
    "Log-spaced time points grouped by pieces (estimation_tools.py:41-48)."
    s = np.diff(
        np.logspace(np.log10(offset + t1), np.log10(tK), sum(pieces) + 1)
    )
    time_points = np.zeros(len(pieces))
    count = 0
    for i, p in enumerate(pieces):
        time_points[i] = s[count : count + p].sum()
        count += p
    return np.concatenate([[t1], time_points])


def gmm_1d(x, k, max_iter=100, tol=1e-3, reg=1e-6):
    """Maximum-likelihood ``k``-component Gaussian mixture of 1-D data by
    EM, with sklearn GaussianMixture's defaults (k-means initialization,
    variance floor ``reg``, stop when the mean log-likelihood per sample
    gains less than ``tol``).  Deterministic: k-means starts from evenly
    spaced data quantiles.  Returns (weights, means, variances).  Raises
    ValueError when there are fewer samples than components."""
    x = np.asarray(x, np.float64).ravel()
    if x.size < k:
        raise ValueError(f"{x.size} samples for a {k}-component mixture")
    mu = np.quantile(x, (np.arange(k) + 0.5) / k)
    for _ in range(100):  # Lloyd iterations of 1-D k-means
        lab = np.argmin(np.abs(x[:, None] - mu[None, :]), axis=1)
        cnt = np.bincount(lab, minlength=k)
        new = np.where(
            cnt > 0, np.bincount(lab, x, minlength=k) / np.maximum(cnt, 1), mu
        )
        if np.allclose(new, mu):
            break
        mu = new
    resp = np.zeros((x.size, k))
    resp[np.arange(x.size), lab] = 1.0
    lower = -np.inf
    for _ in range(max_iter):
        nk = resp.sum(axis=0) + 10 * np.finfo(np.float64).eps
        w = nk / x.size
        mu = resp.T @ x / nk
        var = (resp * (x[:, None] - mu[None, :]) ** 2).sum(axis=0) / nk + reg
        logp = (np.log(w) - 0.5 * np.log(2 * np.pi * var)
                - 0.5 * (x[:, None] - mu[None, :]) ** 2 / var)
        lse = scipy.special.logsumexp(logp, axis=1)
        resp = np.exp(logp - lse[:, None])
        ll = lse.mean()
        if abs(ll - lower) < tol:
            break
        lower = ll
    return w, mu, var


def mixture_positive_quantiles(w, mu, var, p):
    """Quantiles ``p`` of a 1-D Gaussian mixture conditioned on x > 0 (the
    reference takes them from 1e5 mixture draws; here they are solved
    exactly from the mixture CDF).  Raises ValueError when the mixture
    puts no mass above 0."""
    sd = np.sqrt(var)
    mass0 = scipy.stats.norm.cdf(0.0, mu, sd)
    pos = np.sum(w * (1.0 - mass0))
    if not pos > 0:
        raise ValueError("the mixture has no mass above 0")

    def cdf(t):
        return np.sum(w * (scipy.stats.norm.cdf(t, mu, sd) - mass0)) / pos

    hi = float(np.max(mu + 40 * sd))
    return np.array([
        scipy.optimize.brentq(lambda t: cdf(t) - q, 0.0, hi) for q in p
    ])
