"""Golden regression values: pin down concrete numerical outputs of the
setup pipeline and E-step on fixed inputs, so future refactors (kernel
rewrites, stability changes) are checked against today's validated values.

All golden numbers were produced by the current implementation *after* it
passed the independent oracles (quadrature, brute-force HMM, loop-based
transition, JCSFS marginalization) — they encode cross-validated behavior,
not just self-consistency.
"""

import jax.numpy as jnp
import numpy as np

from smcpp_jax.ops import csfs, emission, grid as gridmod, hmm, ratefunc, transition


def fixed_problem():
    s = np.array([0.05, 0.1, 0.2, 0.4, 0.8, 1.6])
    a = np.array([2.0, 1.5, 0.8, 0.5, 1.0, 3.0])
    hs = np.array([0.0, 0.1, 0.3, 0.7, 1.5, np.inf])
    g = gridmod.make_time_grid(s, hs)
    return a, g


def test_golden_pi_and_transition():
    a, g = fixed_problem()
    pi = np.asarray(ratefunc.initial_distribution(jnp.asarray(a), g))
    np.testing.assert_allclose(
        pi,
        [0.05666455012650784, 0.18692162613539898, 0.4035477422792442,
         0.20204584926510122, 0.15082023219374774],
        rtol=1e-10,
    )
    T = np.asarray(transition.transition_matrix(jnp.asarray(a), 1e-2, g))
    np.testing.assert_allclose(T.sum(axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        np.diag(T),
        [0.9994911708887326, 0.9984416691539665, 0.9980034833873568,
         0.9955615992410298, 0.9947325846366666],
        rtol=1e-8,
    )


def test_golden_csfs():
    a, g = fixed_problem()
    bl = np.asarray(csfs.conditioned_sfs(jnp.asarray(a), g, 4))
    np.testing.assert_allclose(
        bl.sum(axis=(1, 2)),
        [4.606808203442039, 4.479079340239874, 3.9800324482514338,
         3.991856077656391, 10.28718903171539],
        rtol=1e-9,
    )
    np.testing.assert_allclose(
        bl[0, :, 0],
        [0.0, 0.09920953931813842, 0.3322126633558882],
        rtol=1e-8,
    )


def test_golden_estep():
    a, g = fixed_problem()
    pi = ratefunc.initial_distribution(jnp.asarray(a), g)
    T = transition.transition_matrix(jnp.asarray(a), 1e-2, g)
    em = csfs.incorporate_theta(csfs.conditioned_sfs(jnp.asarray(a), g, 4), 1e-4)
    e2 = emission.e2_matrix(ratefunc.average_coal_times(jnp.asarray(a), g), 1e-4, 100)
    keys = [(-1, 0, 0), (0, 0, 0), (1, 0, 0)] + [
        (x, b, 4) for x in (0, 1, 2) for b in range(5)
    ]
    idx = emission.build_emission_index(keys, 4)
    E = emission.emission_matrix(idx, em, e2)
    rng = np.random.RandomState(7)
    spans = rng.randint(1, 50, size=(2, 64)).astype(np.int32)
    kk = rng.randint(0, idx.n_keys, size=(2, 64)).astype(np.int32)
    ll, g0, xi, gs = hmm.estep(
        pi, T, jnp.asarray(E), jnp.asarray(spans), jnp.asarray(kk), 6, 8
    )
    assert np.isclose(float(ll), -21662.49850867423, rtol=1e-8), float(ll)
    # conservation: expected transition and emission counts both equal the
    # total number of HMM steps
    total = float(spans.sum())
    assert np.isclose(float(np.asarray(xi).sum()), total, rtol=1e-9)
    assert np.isclose(float(np.asarray(gs).sum()), total, rtol=1e-9)
    # posterior at position 0 sums to the contig count
    assert np.isclose(float(np.asarray(g0).sum()), 2.0, rtol=1e-9)
