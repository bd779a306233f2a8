"""Posterior decode on the batched path: decode_gammas / viterbi_paths
kernels vs the per-contig oracles, mesh-sharded decode vs single device,
and the sub-row re-aggregation contract of the manager (gammas and MAP
paths must line up with the ORIGINAL input rows even when pack_observations
splits long spans)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smcpp_jax.ops import hmm


@pytest.fixture(scope="module")
def small_hmm():
    rng = np.random.RandomState(7)
    M, nK = 6, 9
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.01, 1.0, (nK, M))
    C, L = 4, 32
    spans = rng.randint(0, 9, (C, L)).astype(np.int32)
    spans[1, -7:] = 0  # ragged padding
    keys = rng.randint(0, nK, (C, L)).astype(np.int32)
    keys[spans == 0] = 0
    return pi, T, E, spans, keys


def test_decode_gammas_matches_oracle(small_hmm):
    pi, T, E, spans, keys = small_hmm
    nbits, chunk = 5, 8
    g = np.asarray(
        hmm.decode_gammas(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits, chunk,
        )
    )
    for c in range(spans.shape[0]):
        ref = np.asarray(
            hmm.posterior_gammas(
                jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
                jnp.asarray(spans[c]), jnp.asarray(keys[c]), nbits, chunk,
            )
        )
        np.testing.assert_allclose(g[c], ref, atol=1e-12)
    # per-row normalization: gamma sums to the span
    np.testing.assert_allclose(g.sum(axis=2), spans, atol=1e-9)


def test_viterbi_paths_matches_single(small_hmm):
    pi, T, E, spans, keys = small_hmm
    nbits = 5
    vb = np.asarray(
        hmm.viterbi_paths(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits,
        )
    )
    for c in range(spans.shape[0]):
        ref = np.asarray(
            hmm.viterbi_path(
                jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
                jnp.asarray(spans[c]), jnp.asarray(keys[c]), nbits,
            )
        )
        np.testing.assert_array_equal(vb[c], ref)


def test_sharded_decode_matches_single(small_hmm):
    from smcpp_jax.parallel import mesh as mesh_mod

    pi, T, E, spans, keys = small_hmm
    nbits, chunk = 5, 8
    mesh = mesh_mod.make_mesh()
    fn = mesh_mod.make_sharded_decode(mesh, nbits, chunk)
    sp, ky = mesh_mod.shard_batch(mesh, spans, keys)
    g_sh = np.asarray(fn(jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
                         sp, ky))
    g = np.asarray(
        hmm.decode_gammas(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits, chunk,
        )
    )
    np.testing.assert_allclose(g_sh[: spans.shape[0]], g, atol=1e-12)

    vfn = mesh_mod.make_sharded_viterbi(mesh, nbits)
    v_sh = np.asarray(vfn(jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
                          sp, ky))
    v = np.asarray(
        hmm.viterbi_paths(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits,
        )
    )
    np.testing.assert_array_equal(v_sh[: spans.shape[0]], v)


def _make_im(data, max_span=None, **kw):
    from smcpp_jax.inference import estimation
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.models import SMCModel

    m = SMCModel([0.01, 3.0], 20000.0, "piecewise")
    m.y[:] = 0.0
    hs = estimation.balance_hidden_states(m, 6)
    im = OnePopInferenceManager(2, [data], hs, ("pop1",), 0.5, **kw)
    im.set_model(m)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    return im


def test_gamma_alignment_under_span_splitting(monkeypatch):
    """pack_observations splits long spans into sub-rows; the decoded
    gammas and MAP paths must still line up 1:1 with the caller's rows
    (this was silently wrong when the decode returned sub-row arrays)."""
    # exact f32 pull: this oracle compares raw masses at atol 1e-5 on
    # ~5e4-mass rows, below the default f16 transfer rounding
    monkeypatch.setenv("SMCPP_JAX_DECODE_TRANSFER", "f32")
    rng = np.random.RandomState(3)
    n_rows = 60
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 30, n_rows)
    # a few very long homozygous runs that the cost model will split
    data[5, 0] = 40000
    data[20, 0] = 35000
    data[40, 0] = 50000
    data[:, 1] = rng.randint(0, 2, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows) % (data[:, 3] + 1)

    im = _make_im(data)
    # ensure the scenario actually splits rows
    assert any(r.max() > 1 for r in im._row_reps)
    im.save_gamma = True
    im.E_step()
    g = im.gammas[0]
    assert g.shape[0] == n_rows
    np.testing.assert_allclose(g.sum(axis=1), data[:, 0], rtol=1e-3)

    paths = im.map_paths()
    assert paths[0].shape == (n_rows,)
    assert paths[0].dtype == np.int32

    # oracle: an unsplit manager (max span large enough to avoid splitting)
    from smcpp_jax.inference.manager import pack_observations

    spans, keys, reps = pack_observations(
        [data], im.em_idx.key_id(), im._chunk, max_span=1 << 20
    )
    assert all(r.max() == 1 for r in reps)
    pi, T, E = (np.asarray(x, np.float64) for x in im.tensors())
    nbits = max(1, int(spans.max()).bit_length())
    g_ref = np.asarray(
        hmm.decode_gammas(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(keys), nbits, im._chunk,
        )
    )[0, :n_rows]
    # the manager decode runs in the f32 E-step dtype; span sums reach
    # ~5e4, so f32 rounding shows up at the ~1e-3 relative level
    np.testing.assert_allclose(g, g_ref, rtol=5e-3, atol=1e-5)


def test_manager_memory_gate_toggles_remat(monkeypatch):
    """With a tiny HBM budget the manager must select the remat (+ no
    e-stream) kernel and still reproduce the full-memory statistics."""
    rng = np.random.RandomState(8)
    n_rows = 200
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(5, 60, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)

    im_full = _make_im(data)
    assert im_full._use_windows
    ll_full = im_full.E_step()

    monkeypatch.setenv("SMCPP_JAX_ESTREAM_BYTES", "1")
    im_tiny = _make_im(data)
    ll_tiny = im_tiny.E_step()
    assert np.isclose(ll_tiny, ll_full, rtol=1e-6)
    # the two configs round the alpha stream differently (stored bf16 per
    # window vs bf16 snapshot + f32 recompute), so entries agree only to
    # kernel noise; exact equivalence is pinned in f64 in
    # tests/test_window_kernel.py::test_estep_direct_alpha_remat_matches
    for a, b in zip(im_full._stats, im_tiny._stats):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6)


def test_m1_save_gamma_closed_form():
    """save_gamma at M = 1 (trivial hidden states) returns each row's span
    directly — no kernel decode runs (none is staged at M = 1, and under
    host-local ingestion the span-kernel mesh staging does not exist)."""
    from smcpp_jax.inference.manager import OnePopInferenceManager
    from smcpp_jax.models import SMCModel

    rng = np.random.RandomState(4)
    n_rows = 50
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 2000, n_rows)
    data[5, 0] = 200000  # split by pack_observations
    data[:, 1] = rng.randint(0, 2, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)

    m = SMCModel([0.01, 3.0], 20000.0, "piecewise")
    m.y[:] = 0.0
    im = OnePopInferenceManager(
        2, [data], np.array([0.0, np.inf]), ("pop1",), 0.5
    )
    im.set_model(m)
    im.theta = 1e-4
    im.rho = 1e-4
    im.alpha = 1
    im.save_gamma = True
    ll = im.E_step()
    assert np.isfinite(ll)
    g = im.gammas[0]
    assert g.shape == (n_rows, 1)
    np.testing.assert_array_equal(g[:, 0], data[:, 0])


def test_hbm_budget_sources(monkeypatch):
    """The window-stream budget derives from the DEVICE's memory
    (0.375 x memory_stats()['bytes_limit']), with SMCPP_JAX_ESTREAM_BYTES
    overriding everything, a 6 GB budget on CPU devices (which report no
    limit), and an error for an accelerator that reports none."""
    from smcpp_jax.inference.manager import OnePopInferenceManager

    monkeypatch.delenv("SMCPP_JAX_ESTREAM_BYTES", raising=False)

    class _Dev:
        platform = "gpu"

        @staticmethod
        def memory_stats():
            return {"bytes_limit": 60e9}

    class _IM:
        _hbm_budget = OnePopInferenceManager._hbm_budget
        _device = _Dev()

    assert _IM()._hbm_budget() == 0.375 * 60e9
    # decode gate fraction: same device memory, larger share
    assert _IM()._hbm_budget(0.70) == 0.70 * 60e9
    _IM._device = None  # falls through to jax.devices()[0]: forced-host CPU
    assert _IM()._hbm_budget() == 6e9

    class _NoStats(_Dev):
        @staticmethod
        def memory_stats():
            return None

    _IM._device = _NoStats()
    with pytest.raises(RuntimeError, match="memory_stats"):
        _IM()._hbm_budget()

    monkeypatch.setenv("SMCPP_JAX_ESTREAM_BYTES", "123456.0")
    assert _IM()._hbm_budget() == 123456.0  # the override needs no stats
    _IM._device = _Dev()
    assert _IM()._hbm_budget() == 123456.0
    # the env override is ABSOLUTE: every gate fraction sees the same value
    assert _IM()._hbm_budget(0.70) == 123456.0


def test_budget_gates_flip_at_boundary(monkeypatch):
    """The decode/Viterbi fit gates must flip exactly at the configured
    budget (two synthetic levels around the actual stream size)."""
    rng = np.random.RandomState(11)
    n_rows = 80
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 20, n_rows)
    data[:, 1] = rng.randint(0, 2, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    im = _make_im(data)
    assert im._use_windows
    need = im._window_stream_bytes(12)
    assert need > 0
    monkeypatch.setenv("SMCPP_JAX_ESTREAM_BYTES", str(need * 1.01))
    assert im._window_decode_fits() and im._window_viterbi_fits()
    monkeypatch.setenv("SMCPP_JAX_ESTREAM_BYTES", str(need * 0.99))
    assert not im._window_decode_fits()
    # the Viterbi stream is 6x smaller (2 B vs 12 B per window-state)
    assert im._window_viterbi_fits()
    monkeypatch.setenv(
        "SMCPP_JAX_ESTREAM_BYTES", str(im._window_stream_bytes(2) * 0.99)
    )
    assert not im._window_viterbi_fits()


def test_viterbi_blocked_matches_full():
    """Streaming the phase-C backpointers per block (the over-budget MAP
    mode) must reproduce the full-stream window Viterbi exactly — the
    forward recompute from block-entry snapshots is bit-identical
    arithmetic, only the storage schedule differs."""
    from smcpp_jax.ops import window_kernel as wk

    rng = np.random.RandomState(5)
    M, nK = 5, 7
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.01, 1.0, (nK, M))
    S, L = 6, 64
    keys = rng.randint(0, nK, (S, L)).astype(np.int32)
    valid = np.ones((S, L), bool)
    valid[2, -17:] = False  # ragged padding
    valid[5, -3:] = False
    soc = np.array([[0, 1, -1], [2, 3, 4], [5, -1, -1]])
    spans = [np.ones(int(v.sum()), np.int64) for v in
             (valid[:2].ravel(), valid[2:5].ravel(), valid[5:].ravel())]
    ends = wk.pack_window_row_ends(spans, L, soc)
    args = (jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(keys), jnp.asarray(valid), soc, jnp.asarray(ends))
    full = np.asarray(wk.viterbi_windows(*args))
    for block in (8, 16, 64):
        blk = np.asarray(wk.viterbi_windows(*args, block=block))
        np.testing.assert_array_equal(full, blk)


def test_manager_viterbi_budget_streams_blocks(monkeypatch, caplog):
    """With the budget squeezed between the full int8 backpointer stream
    and the blocked one, map_paths must stream per block — and produce
    the same paths as the in-budget kernel (NOT fall back to the
    row-level CPU decoder)."""
    import logging

    rng = np.random.RandomState(13)
    n_rows = 150
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 25, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)

    im = _make_im(data)
    assert im._use_windows
    im.E_step()
    full = im.map_paths()

    L = im._wkeys.shape[1]
    from smcpp_jax.ops import window_kernel as wk

    block = wk.remat_block_size(L)
    eff = (block + 4.0 * (L // block)) / L
    assert eff < 2.0  # the blocked stream must actually be smaller
    lo = im._window_stream_bytes(eff)
    hi = im._window_stream_bytes(2)
    monkeypatch.setenv(
        "SMCPP_JAX_ESTREAM_BYTES", str((lo + hi) / 2.0)
    )
    im2 = _make_im(data)
    im2.E_step()
    assert not im2._window_viterbi_fits()
    with caplog.at_level(logging.INFO, logger="smcpp_jax.inference.manager"):
        blocked = im2.map_paths()
    assert im2._wvit_block == block  # took the streamed window path
    for a, b in zip(full, blocked):
        np.testing.assert_array_equal(a, b)


def test_window_decode_matches_row_decode():
    """The window-kernel decode (per-window gammas + on-device segment
    sum) must agree with the row-level decode on the same manager."""
    rng = np.random.RandomState(21)
    n_rows = 300
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 40, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    im = _make_im(data)
    assert im._use_windows and im._window_decode_fits()
    im.save_gamma = True
    im.E_step()
    g_win = im.gammas[0]
    assert g_win.shape == (n_rows, 6 - 1)
    np.testing.assert_allclose(g_win.sum(axis=1), data[:, 0], rtol=1e-3)

    # force the row-level decode on the same tensors
    pi, T, E = im.tensors()
    import jax.numpy as jnp

    dt = im._estep_dtype
    args = tuple(
        jax.device_put(jnp.asarray(np.asarray(x), dt), im._cpu)
        for x in (pi, T, E)
    )
    im2 = _make_im(data)
    im2._use_windows = False  # route _compute_gammas to the row decode
    g_row = im2._compute_gammas(*args)[0]
    # the decode forces exact-f32 carries (tf32 rung) precisely so the
    # boundary vectors don't carry bf16 noise into user-facing posteriors
    np.testing.assert_allclose(g_win, g_row, rtol=2e-3, atol=1e-3)


def test_decode_transfer_f16_rounding_bounded(monkeypatch):
    """The default f16 device->host gamma pull (manager._transfer_dtype)
    halves the transfer; its rounding must stay below the documented
    2^-12-per-unit-mass bound relative to the exact f32 pull."""
    rng = np.random.RandomState(33)
    n_rows = 200
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 40, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    im = _make_im(data)
    im.save_gamma = True
    monkeypatch.setenv("SMCPP_JAX_DECODE_TRANSFER", "f32")
    im.E_step()
    g32 = im.gammas[0]
    monkeypatch.setenv("SMCPP_JAX_DECODE_TRANSFER", "f16")
    im.E_step()
    g16 = im.gammas[0]
    spans = data[:, 0].astype(np.float64)
    # per-row mass = span; f16 quantization <= ~2.5e-4 of the row mass
    assert np.max(np.abs(g16 - g32) / spans[:, None]) < 5e-4
    np.testing.assert_allclose(g16.sum(axis=1), spans, rtol=1e-3)


def test_window_decode_single_device_matches_mesh(monkeypatch):
    "The cumsum+take (1-device) and segment-sum (mesh) decodes agree."
    # exact f32 pull: this oracle compares the two aggregation paths at
    # 1e-4, below the default f16 transfer rounding
    monkeypatch.setenv("SMCPP_JAX_DECODE_TRANSFER", "f32")
    rng = np.random.RandomState(31)
    n_rows = 250
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 25, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)
    im_mesh = _make_im(data)
    assert im_mesh._mesh is not None and im_mesh._use_windows
    im_one = _make_im(data, devices=[jax.devices()[0]])
    assert im_one._mesh is None and im_one._use_windows
    for im in (im_mesh, im_one):
        im.save_gamma = True
        im.E_step()
    g_m, g_1 = im_mesh.gammas[0], im_one.gammas[0]
    np.testing.assert_allclose(g_1.sum(axis=1), data[:, 0], rtol=1e-4)
    np.testing.assert_allclose(g_1, g_m, rtol=1e-4, atol=1e-5)


def test_window_viterbi_matches_row_viterbi():
    """map_paths through the window max-plus kernel (mesh + single device)
    must agree with the f64 row-level Viterbi."""
    rng = np.random.RandomState(41)
    n_rows = 220
    data = np.zeros((n_rows, 4), dtype=np.int32)
    data[:, 0] = rng.randint(1, 30, n_rows)
    data[:, 1] = rng.randint(0, 3, n_rows)
    data[:, 3] = 2
    data[:, 2] = rng.randint(0, 3, n_rows)

    im = _make_im(data)  # 8-device mesh
    assert im._use_windows and im._window_decode_fits()
    p_mesh = im.map_paths()[0]

    im1 = _make_im(data, devices=[jax.devices()[0]])
    p_one = im1.map_paths()[0]

    # f64 row-level oracle
    pi, T, E = (np.asarray(x, np.float64) for x in im.tensors())
    ref = np.asarray(
        hmm.viterbi_path(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            np.asarray(im._spans[0]), np.asarray(im._keys[0]), im._nbits,
        )
    )
    nsub = int(im._row_reps[0].sum())
    ends = np.cumsum(im._row_reps[0]) - 1
    ref_rows = ref[:nsub][ends]
    assert p_mesh.shape == (n_rows,)
    # f32 max-plus vs f64: allow rare near-tie flips
    assert (p_mesh == ref_rows).mean() > 0.99
    np.testing.assert_array_equal(p_mesh, p_one)
