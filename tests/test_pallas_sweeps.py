"""Pallas statistic-sweep kernel (ops/pallas_sweeps.py) vs the XLA sweeps.

The kernel is written for the Triton route; here it runs in interpret mode
on the CPU, where every dot is exact f32, so at 'highest' it must agree
with ``stats_pass`` to f32 rounding (both accumulate xo/gsum in f64).  The
`gpu`-marked test compiles it for the card.
"""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from smcpp_jax.ops import pallas_sweeps as ps
from smcpp_jax.ops import window_kernel as wk


def _problem(seed, S, L, M=16, n_keys=89, invalid_tail=2):
    rng = np.random.RandomState(seed)
    T = rng.dirichlet(np.ones(M), size=M).astype(np.float32)
    E = rng.uniform(0.05, 1.0, (n_keys, M)).astype(np.float32)
    keys = rng.randint(0, n_keys, (S, L)).astype(np.int32)
    valid = rng.rand(S, L) < 0.9
    if invalid_tail:
        valid[-invalid_tail:] = False  # mesh-padding segments
    A_in = rng.rand(S, M).astype(np.float32)
    Q_end = rng.rand(S, M).astype(np.float32)
    return T, E, keys, valid, A_in, Q_end


def _xla(T, E, keys, valid, A_in, Q_end, precision="highest"):
    return wk.stats_pass(
        jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys),
        jnp.asarray(valid), jnp.asarray(A_in), jnp.asarray(Q_end),
        None, precision=precision,
    )


def _kernel(T, E, keys, valid, A_in, Q_end, **kw):
    kw.setdefault("interpret", True)
    return ps.sweeps(
        jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys.T),
        jnp.asarray(valid.T), jnp.asarray(A_in), jnp.asarray(Q_end), **kw
    )


def _assert_close(got, ref, rtol=1e-5):
    for g, r in zip(got, ref):
        g = np.asarray(g, np.float64)
        r = np.asarray(r, np.float64)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * np.abs(r).max())


@pytest.mark.parametrize("S,L,M", [(8, 256, 16), (24, 192, 17)])
def test_pallas_sweeps_match_xla_exact(S, L, M):
    """'highest': alphas and statistics agree with the XLA sweeps (rtol
    1e-5); M=17 (estimate's --knots 8) pads to 32 states inside."""
    prob = _problem(0, S, L, M=M)
    _assert_close(_kernel(*prob, precision="highest"), _xla(*prob))


def test_pallas_sweeps_multi_segment_tile():
    """Several programs plus a padded last tile (S=40 over 16-segment
    tiles) exercise the per-program partial sums and the caller's
    reduction; M=32 the two-population state count."""
    prob = _problem(3, 40, 64, M=32)
    got = _kernel(*prob, precision="highest")
    _assert_close(got, _xla(*prob))


def test_pallas_sweeps_default_precision_envelope():
    """'default' with the bf16 alpha stream (the production rung): stats
    agree with the exact-f32 XLA sweeps to bf16-noise tolerances, and
    per-key masses stay conservative (the summed gsum equals the
    valid-window count to f32 accumulation)."""
    T, E, keys, valid, A_in, Q_end = _problem(1, 16, 256)
    ref = _xla(T, E, keys, valid, A_in, Q_end)
    got = _kernel(T, E, keys, valid, A_in, Q_end,
                  alpha_dtype=jnp.bfloat16, precision="default")
    _, _, xo_r, gs_r = [np.asarray(x, np.float64) for x in ref]
    _, _, xo_g, gs_g = [np.asarray(x, np.float64) for x in got]
    assert np.abs(xo_g - xo_r).max() / np.abs(xo_r).max() < 5e-2
    assert np.abs(gs_g - gs_r).max() / np.abs(gs_r).max() < 5e-2
    # conservation: every valid window contributes exactly one unit of
    # posterior mass across (key, state)
    np.testing.assert_allclose(gs_g.sum(), valid.sum(), rtol=1e-5)


def test_stats_pass_pallas_gate(monkeypatch):
    """stats_pass(sweep='pallas') routes to the kernel and matches the XLA
    result through the public entry; configurations the kernel does not
    serve are refused, never silently rerouted."""
    calls = {}
    real = ps.sweeps

    def spy(*a, **kw):
        calls["hit"] = True
        return real(*a, interpret=True, **kw)

    monkeypatch.setattr(ps, "sweeps", spy)
    T, E, keys, valid, A_in, Q_end = _problem(2, 8, 128)
    args = (jnp.asarray(T), jnp.asarray(E), jnp.asarray(keys),
            jnp.asarray(valid), jnp.asarray(A_in), jnp.asarray(Q_end))
    out = wk.stats_pass(*args, None, precision="highest", sweep="pallas")
    assert calls.get("hit")
    _assert_close(out, wk.stats_pass(*args, None, precision="highest"))
    with pytest.raises(ValueError):
        wk.stats_pass(*args, None, precision="highest", emit_gamma=True,
                      sweep="pallas")
    with pytest.raises(ValueError):
        wk.stats_pass(*args, None, precision="highest", alpha_remat=16,
                      sweep="pallas")


@pytest.mark.parametrize(
    "platform,S,M,n_keys,dtype,want",
    [
        ("gpu", 6732, 16, 128, jnp.float32, "pallas"),
        ("gpu", 100, 32, 97, jnp.float32, "pallas"),
        ("cpu", 6732, 16, 128, jnp.float32, "xla"),
        ("gpu", 6732, 16, 129, jnp.float32, "xla"),  # key table too wide
        ("gpu", 6732, 16, 500, jnp.float32, "xla"),  # emission-stream path
        ("gpu", 6732, 17, 64, jnp.float32, "pallas"),  # padded to 32
        ("gpu", 6732, 33, 64, jnp.float32, "xla"),  # above the state cap
        ("gpu", 6732, 16, 64, jnp.float64, "xla"),  # f64 oracle programs
    ],
)
def test_choose_sweep(platform, S, M, n_keys, dtype, want):
    assert wk.choose_sweep(platform, S, 8192, M, n_keys, dtype) == want


def test_launch_config():
    """States pad to a power of two >= 16; warps grow with the (states x
    keys) f64 accumulator, 2 at the C3 one-pop width and 4 at M = 32."""
    assert [ps.padded_states(m) for m in (2, 16, 17, 32)] == [16, 16, 32, 32]
    assert ps.num_warps(16, 128) == 2
    assert ps.num_warps(32, 128) == 4
    assert ps.num_warps(16, 16) == 2
    assert ps.BLOCK_SEGMENTS == 16


@pytest.mark.parametrize("n_devices", [1, 2])
def test_manager_runs_selected_sweep(monkeypatch, n_devices):
    """The manager threads its sweep choice into the jitted E-step, alone
    and on a mesh (shard_map over segments): forcing the kernel (in
    interpret mode) reproduces the XLA E-step."""
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.models import SMCModel

    rng = np.random.RandomState(5)
    data = []
    for _ in range(3):
        rows = 300
        d = np.zeros((rows, 4), np.int32)
        d[:, 0] = rng.randint(1, 40, rows)
        d[:, 1] = rng.randint(0, 3, rows)
        d[:, 2] = rng.randint(0, 5, rows)
        d[:, 3] = 4
        data.append(d)
    m = SMCModel([0.05, 0.3, 1.5], 1e4, "piecewise")
    hs = estimation.balance_hidden_states(m, 17)

    def run():
        im = OnePopInferenceManager(
            4, data, hs, ("pop1",), 0.5, devices=jax.devices()[:n_devices],
            precision="highest",
        )
        im.set_model(m)
        im.theta, im.rho, im.alpha = 1e-3, 1e-3, 1
        return im, im.E_step(), im._stats

    im_x, ll_x, st_x = run()
    assert im_x._use_windows and im_x.sweep == "xla"
    real = ps.sweeps
    monkeypatch.setattr(wk, "choose_sweep", lambda *a, **k: "pallas")
    monkeypatch.setattr(
        ps, "sweeps", lambda *a, **kw: real(*a, interpret=True, **kw)
    )
    im_p, ll_p, st_p = run()
    assert im_p.sweep == "pallas"
    assert np.isclose(ll_p, ll_x, rtol=1e-6)
    for a, b in zip(st_p, st_x):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


@pytest.mark.gpu
def test_pallas_sweeps_compiled_on_gpu(gpu_device):
    """The kernel as Triton compiles it for the card, at 'highest' and
    'default' (TF32 recursion dots, bf16 alpha stream)."""
    prob = _problem(4, 300, 256)
    with jax.default_device(gpu_device):
        got = _kernel(*prob, precision="highest", interpret=False)
        _assert_close(got, _xla(*prob))
        got = _kernel(*prob, precision="default", interpret=False,
                      alpha_dtype=jnp.bfloat16)
    gs = np.asarray(got[3], np.float64)
    np.testing.assert_allclose(gs.sum(), prob[3].sum(), rtol=1e-5)
