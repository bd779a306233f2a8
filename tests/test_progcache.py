"""Export-program disk cache (inference/progcache.py).

The cache must serve bit-identical programs, key on closure fingerprints
and argument shapes, invalidate with the source hash, and fall back to
plain jit on any failure.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smcpp_jax.inference import progcache as pc


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "expcache"
    monkeypatch.setenv("SMCPP_JAX_EXPORT_CACHE", str(d))
    return d


def test_roundtrip_and_hit(cache_dir):
    calls = []

    def build():
        calls.append(1)
        return lambda x, s: jnp.sum(jnp.sin(x) * s)

    f = pc.exported_jit("t1", "fpA", build)
    x = np.linspace(0, 1, 64)
    v1 = float(f(x, np.float64(2.0)))
    assert len(calls) == 1
    assert len(list(cache_dir.iterdir())) == 1

    # fresh wrapper, same key: served from disk, build() never called
    calls2 = []
    f2 = pc.exported_jit(
        "t1", "fpA", lambda: calls2.append(1) or (lambda *a: None)
    )
    v2 = float(f2(x, np.float64(2.0)))
    assert not calls2
    assert v1 == v2  # bit-identical program


def test_shape_and_fingerprint_keying(cache_dir):
    build = lambda: (lambda x: jnp.sum(x * x))  # noqa: E731
    f = pc.exported_jit("t2", "fpA", build)
    f(np.ones(8))
    f(np.ones(16))  # second shape -> second artifact
    g = pc.exported_jit("t2", "fpB", build)
    g(np.ones(8))  # different closure fingerprint -> third artifact
    assert len(list(cache_dir.iterdir())) == 3


def test_transformed_builds(cache_dir):
    "vmap/grad are applied before export and survive the round trip."
    def q(y):
        return jnp.sum(jnp.exp(y) * jnp.arange(3.0))

    fv = pc.exported_jit("t3v", "fp", lambda: jax.vmap(q))
    fg = pc.exported_jit("t3g", "fp", lambda: jax.value_and_grad(q))
    ys = np.random.RandomState(0).randn(5, 3)
    np.testing.assert_allclose(
        np.asarray(fv(ys)), [float(q(y)) for y in ys], rtol=1e-12
    )
    v, g = fg(ys[0])
    np.testing.assert_allclose(
        np.asarray(g), np.exp(ys[0]) * np.arange(3.0), rtol=1e-12
    )
    # warm copies agree
    fv2 = pc.exported_jit("t3v", "fp", lambda: jax.vmap(q))
    np.testing.assert_array_equal(np.asarray(fv2(ys)), np.asarray(fv(ys)))


def test_disabled_env_falls_back(tmp_path, monkeypatch):
    monkeypatch.setenv("SMCPP_JAX_EXPORT_CACHE", "0")
    f = pc.exported_jit("t4", "fp", lambda: (lambda x: x + 1))
    assert float(f(np.float64(1.0))) == 2.0


def test_no_serializer_turns_cache_off(cache_dir, monkeypatch):
    """Without flatbuffers (jax.export's serializer) nothing is exported
    or written: every signature is a counted plain-jit fallback."""
    import builtins

    real_import = builtins.__import__

    def no_flatbuffers(name, *a, **k):
        if name == "flatbuffers":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_flatbuffers)
    pc._can_serialize.cache_clear()
    try:
        before = dict(pc.STATS)
        f = pc.exported_jit("t5", "fp", lambda: (lambda x: x * 3))
        assert float(f(np.float64(2.0))) == 6.0
        assert pc.STATS["fallback"] == before["fallback"] + 1
        assert pc.STATS["store"] == before["store"]
        assert not cache_dir.exists()
    finally:
        monkeypatch.undo()
        pc._can_serialize.cache_clear()


def test_manager_setup_uses_cache(cache_dir):
    "A one-pop manager's Q programs land in (and reload from) the cache."
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.models import SMCModel

    rng = np.random.RandomState(5)
    data = np.zeros((100, 4), np.int32)
    data[:, 0] = rng.randint(1, 30, 100)
    data[:, 1] = rng.randint(0, 3, 100)
    data[:, 3] = 2

    def fit():
        m = SMCModel([0.01, 3.0], 2e4, "piecewise")
        m.y[:] = 0.1
        hs = estimation.balance_hidden_states(m, 6)
        im = OnePopInferenceManager(2, [data], hs, ("pop1",), 0.5)
        im.set_model(m)
        im.theta = 1e-4
        im.rho = 1e-4
        im.alpha = 1
        im.E_step()
        return im.Q(), im.Q_batch(ys=np.tile(m.y, (3, 1)))

    q1, qb1 = fit()
    files = {p.name for p in cache_dir.iterdir()}
    assert any(f.startswith("q-") for f in files)
    assert any(f.startswith("qbatch-") for f in files)
    q2, qb2 = fit()  # second build: served from disk
    assert q1 == q2
    np.testing.assert_array_equal(qb1, qb2)
    assert {p.name for p in cache_dir.iterdir()} == files
