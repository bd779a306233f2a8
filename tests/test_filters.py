"""Data-pipeline kernels: semantics checks + native/NumPy equivalence."""

import numpy as np
import pytest

from smcpp_jax.contig import Contig
from smcpp_jax.data import filters as df


def test_compress_merges_repeats():
    "test_bugs.py:test_bug3"
    np.testing.assert_equal(
        [[3, 0, 0, 0]],
        df.compress_repeated_obs([[1, 0, 0, 0], [2, 0, 0, 0]]),
    )


def test_compress_roundtrip():
    rng = np.random.RandomState(0)
    d = np.c_[
        rng.randint(1, 5, 50), rng.randint(0, 2, 50),
        rng.randint(0, 2, 50), np.full(50, 4),
    ].astype(np.int32)
    c = df.compress_repeated_obs(d)
    assert c[:, 0].sum() == d[:, 0].sum()
    # no two adjacent rows identical
    assert np.all(np.any(c[1:, 1:] != c[:-1, 1:], axis=1))


def _rand_contig(rng, rows=200, n=6):
    d = np.c_[
        rng.randint(1, 2000, rows),
        rng.choice([-1, 0, 1, 2], rows, p=[0.1, 0.5, 0.3, 0.1]),
        rng.randint(0, n + 1, rows),
        np.full(rows, n),
    ].astype(np.int32)
    d[:, 2] = np.minimum(d[:, 2], d[:, 3])
    d[d[:, 1] == -1, 3] = rng.choice([0, n], (d[:, 1] == -1).sum())
    return Contig(pid=("p",), data=d, n=[n], a=[2])


def _py_thin(data, thinning):
    "Force the NumPy fallback."
    import smcpp_jax.data.filters as f
    import sys

    native = sys.modules.pop("smcpp_jax._native", None)
    saved = None
    try:
        import smcpp_jax

        saved = getattr(smcpp_jax, "_native", None)
        if saved is not None:
            delattr(smcpp_jax, "_native")
        sys.modules["smcpp_jax._native"] = None  # force ImportError
        try:
            return f.thin_data(data, thinning)
        finally:
            del sys.modules["smcpp_jax._native"]
    finally:
        if native is not None:
            sys.modules["smcpp_jax._native"] = native
        if saved is not None:
            import smcpp_jax

            smcpp_jax._native = saved


def test_thin_preserves_total_span():
    rng = np.random.RandomState(1)
    c = _rand_contig(rng)
    out = df.thin_data(c.data, 137)
    assert out[:, 0].sum() == c.data[:, 0].sum()
    # thinned (non-boundary) rows carry no undistinguished information
    boundary = out[:, 0] == 1
    assert np.all(out[~boundary, 3] == 0)


def test_native_matches_python():
    pytest.importorskip("smcpp_jax._native")
    from smcpp_jax import _native

    rng = np.random.RandomState(2)
    for _ in range(5):
        c = _rand_contig(rng, rows=100)
        th = int(rng.randint(2, 500))
        a = _native.thin_data(c.data, th)
        b = _py_thin(c.data, th)
        np.testing.assert_equal(a, b)

        w = int(rng.randint(50, 300))
        a2 = _native.bin_observations(c.data.copy(), np.asarray(c.a, np.int64), w)
        # Python fallback (bin_observations mutates a copy internally)
        import smcpp_jax.data.filters as f

        c2 = Contig(pid=c.pid, data=c.data.copy(), n=c.n, a=c.a)
        # temporarily hide native
        import smcpp_jax

        native = smcpp_jax._native if hasattr(smcpp_jax, "_native") else None
        import sys

        sys.modules["smcpp_jax._native"] = None
        try:
            b2 = f.bin_observations(c2, w)
        finally:
            del sys.modules["smcpp_jax._native"]
        np.testing.assert_equal(a2, b2)

        a3 = _native.windowed_mutation_counts(
            np.ascontiguousarray(c.data[::-1]), w
        )
        sys.modules["smcpp_jax._native"] = None
        try:
            b3 = f.windowed_mutation_counts(c, w)
        finally:
            del sys.modules["smcpp_jax._native"]
        np.testing.assert_equal(a3, b3)


def test_realign():
    rng = np.random.RandomState(3)
    d = np.c_[rng.randint(1, 500, 60), rng.randint(0, 2, 60),
              np.zeros(60, int), np.full(60, 4)].astype(np.int32)
    out = df.realign(d, 100)
    assert out[:, 0].sum() == d[:, 0].sum()
    # no row crosses a 100-boundary
    starts = np.concatenate([[0], np.cumsum(out[:, 0])[:-1]])
    ends = starts + out[:, 0]
    assert np.all(starts // 100 == (ends - 1) // 100)


def test_break_long_spans():
    d = np.array(
        [
            [500, 0, 0, 4],
            [200000, -1, 0, 0],
            [300, 1, 2, 4],
        ],
        dtype=np.int32,
    )
    c = Contig(pid=("p",), data=d, n=[4], a=[2])
    parts = df.break_long_spans(c, 100000)
    assert len(parts) == 2
    assert len(parts[0]) == 501  # prepended missing row adds 1
    assert len(parts[1]) == 301


def test_watterson_constant():
    "Watterson's estimate on dense fake data is in a sane range."
    rng = np.random.RandomState(4)
    n = 6
    L = 10000
    theta = 0.01
    # P(seg) ~ theta * harmonic(n+1)
    seg = rng.random(L) < theta * np.log(n + 2)
    d = np.c_[
        np.ones(L, int), np.zeros(L, int), seg.astype(int), np.full(L, n)
    ].astype(np.int32)
    c = Contig(pid=("p",), data=d, n=[n], a=[2])
    wat = df.Watterson()
    wat.run([c])
    assert 0.3 * theta < wat.theta_hat < 3 * theta
