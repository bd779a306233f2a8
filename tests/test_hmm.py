"""HMM kernel correctness against a brute-force NumPy forward-backward on the
*decompressed* observation sequence (every span expanded to unit steps).

This pins down both the span-compression algebra and the gradient-identity
E-step statistics (xisum / gamma_sums / gamma0) against textbook Baum-Welch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from smcpp_jax.ops import hmm


def brute_force(pi, T, E, spans, keys):
    "Textbook scaled forward-backward on the decompressed sequence."
    M = len(pi)
    seq = [k for s, k in zip(spans, keys) for _ in range(s)]
    L = len(seq)
    alpha = np.zeros((L + 1, M))
    c = np.zeros(L + 1)
    alpha[0] = pi
    c[0] = 1.0
    for t, k in enumerate(seq, start=1):
        v = E[k] * (T.T @ alpha[t - 1])
        c[t] = v.sum()
        alpha[t] = v / c[t]
    ll = np.log(c[1:]).sum()
    beta = np.zeros((L + 1, M))
    beta[L] = 1.0
    xisum = np.zeros((M, M))
    gamma = np.zeros((L + 1, M))
    gamma[L] = alpha[L] * beta[L]
    for t in range(L, 0, -1):
        k = seq[t - 1]
        xisum += np.outer(alpha[t - 1], E[k] * beta[t]) * T / c[t]
        beta[t - 1] = T @ (E[k] * beta[t]) / c[t]
        gamma[t - 1] = alpha[t - 1] * beta[t - 1]
    gamma_sums = {}
    for t, k in enumerate(seq, start=1):
        gamma_sums.setdefault(k, np.zeros(M))
        gamma_sums[k] += gamma[t]
    return ll, gamma[0], xisum, gamma_sums, gamma


@pytest.fixture
def problem():
    rng = np.random.RandomState(0)
    M, n_keys = 4, 5
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)  # rows sum to 1
    E = rng.uniform(0.1, 1.0, (n_keys, M))
    spans = np.array([1, 5, 1, 1, 12, 3, 1, 37, 2, 1, 1, 6, 1, 1, 2, 1], np.int32)
    keys = np.array([0, 1, 2, 0, 1, 3, 4, 1, 0, 2, 3, 1, 0, 4, 1, 0], np.int32)
    return pi, T, E, spans, keys


def test_forward_loglik(problem):
    pi, T, E, spans, keys = problem
    ll_bf, *_ = brute_force(pi, T, E, spans, keys)
    nbits = int(spans.max()).bit_length()
    ll = float(
        hmm.forward_loglik(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits, 8,
        )
    )
    assert np.isclose(ll, ll_bf, rtol=1e-10)


def test_forward_loglik_padding(problem):
    "span == 0 rows are exact no-ops."
    pi, T, E, spans, keys = problem
    spans_p = np.concatenate([spans, np.zeros(16, np.int32)])
    keys_p = np.concatenate([keys, np.zeros(16, np.int32)])
    nbits = int(spans.max()).bit_length()
    args = (jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E))
    ll1 = float(hmm.forward_loglik(*args, jnp.asarray(spans), jnp.asarray(keys), nbits, 8))
    ll2 = float(hmm.forward_loglik(*args, jnp.asarray(spans_p), jnp.asarray(keys_p), nbits, 8))
    assert np.isclose(ll1, ll2, rtol=1e-12)


def test_estep_statistics(problem):
    pi, T, E, spans, keys = problem
    ll_bf, gamma0_bf, xisum_bf, gs_bf, _ = brute_force(pi, T, E, spans, keys)
    nbits = int(spans.max()).bit_length()
    ll, gamma0, xisum, gs = hmm.estep(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(spans)[None], jnp.asarray(keys)[None], nbits, 8,
    )
    assert np.isclose(float(ll), ll_bf, rtol=1e-10)
    np.testing.assert_allclose(np.array(gamma0), gamma0_bf, rtol=1e-8)
    np.testing.assert_allclose(np.array(xisum), xisum_bf, rtol=1e-8)
    for k, v in gs_bf.items():
        np.testing.assert_allclose(np.array(gs)[k], v, rtol=1e-8, atol=1e-12)
    # keys never observed have zero expected counts
    assert np.allclose(np.array(gs).sum(axis=1).sum(), sum(spans), rtol=1e-8)


def test_estep_multi_contig(problem):
    "Statistics sum across contigs."
    pi, T, E, spans, keys = problem
    nbits = int(spans.max()).bit_length()
    args = (jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E))
    ll1, g1, x1, gs1 = hmm.estep(*args, jnp.asarray(spans)[None], jnp.asarray(keys)[None], nbits, 8)
    spans2 = np.stack([spans, spans])
    keys2 = np.stack([keys, keys])
    ll2, g2, x2, gs2 = hmm.estep(*args, jnp.asarray(spans2), jnp.asarray(keys2), nbits, 8)
    assert np.isclose(float(ll2), 2 * float(ll1), rtol=1e-12)
    np.testing.assert_allclose(np.array(x2), 2 * np.array(x1), rtol=1e-10)
    np.testing.assert_allclose(np.array(gs2), 2 * np.array(gs1), rtol=1e-10)


def test_posterior_gammas(problem):
    pi, T, E, spans, keys = problem
    *_, gamma_full = brute_force(pi, T, E, spans, keys)
    nbits = int(spans.max()).bit_length()
    g = np.array(
        hmm.posterior_gammas(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits, 8,
        )
    )
    # row l of g = sum of per-position gammas within row l's span
    pos = 1
    for l, s in enumerate(spans):
        want = gamma_full[pos : pos + s].sum(axis=0)
        np.testing.assert_allclose(g[l], want, rtol=1e-7, atol=1e-10)
        pos += s


def test_float32_accuracy(problem):
    "The f32 accelerator path agrees with f64 to ~1e-4 relative."
    pi, T, E, spans, keys = problem
    nbits = int(spans.max()).bit_length()
    ll64 = float(
        hmm.forward_loglik(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits, 8,
        )
    )
    ll32 = float(
        hmm.forward_loglik(
            jnp.asarray(pi, jnp.float32), jnp.asarray(T, jnp.float32),
            jnp.asarray(E, jnp.float32),
            jnp.asarray(spans), jnp.asarray(keys), nbits, 8,
        )
    )
    assert np.isclose(ll32, ll64, rtol=1e-4)


def test_viterbi_brute_force():
    """MAP path vs exhaustive base-resolution enumeration on a tiny chain.

    The base-level MAP path's states at row boundaries must match
    viterbi_path's row-resolution output."""
    import itertools

    rng = np.random.RandomState(3)
    M, n_keys = 3, 3
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.1, 1.0, (n_keys, M))
    spans = np.array([2, 1, 3, 1, 2], np.int32)
    keys = np.array([0, 1, 2, 0, 1], np.int32)
    base_keys = np.repeat(keys, spans)
    B = base_keys.size
    ends = np.cumsum(spans) - 1  # base index at each row end

    best_lp, best_path = -np.inf, None
    for path in itertools.product(range(M), repeat=B + 1):
        lp = np.log(pi[path[0]])
        for b in range(B):
            lp += np.log(T[path[b], path[b + 1]])
            lp += np.log(E[base_keys[b], path[b + 1]])
        if lp > best_lp:
            best_lp, best_path = lp, path
    expect = np.array(best_path[1:])[ends]

    nbits = int(spans.max()).bit_length()
    got = np.asarray(
        hmm.viterbi_path(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits,
        )
    )
    np.testing.assert_array_equal(got, expect)
