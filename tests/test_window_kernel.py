"""Window-resolution kernel must agree with the span-compressed kernel and
the brute-force oracle."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from smcpp_jax.ops import hmm, window_kernel as wk


def make_problem(seed=0, C=3, rows=40):
    rng = np.random.RandomState(seed)
    M, nk = 5, 7
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.1, 1.0, (nk, M))
    data = []
    for _ in range(C):
        spans = rng.randint(1, 30, size=rows).astype(np.int32)
        keys = rng.randint(0, nk, size=rows).astype(np.int32)
        d = np.c_[spans, keys]  # fake (span, key-tuple) rows: key cols = 1
        data.append(d)
    return pi, T, E, data


def test_matches_span_kernel():
    pi, T, E, data = make_problem()
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    ll_w = float(
        wk.loglik_windows(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(keys), jnp.asarray(valid), soc,
        )
    )
    # span-compressed path
    C = len(data)
    Lmax = max(len(d) for d in data)
    Lmax = -(-Lmax // 8) * 8
    spans = np.zeros((C, Lmax), np.int32)
    ks = np.zeros((C, Lmax), np.int32)
    for i, d in enumerate(data):
        spans[i, : len(d)] = d[:, 0]
        ks[i, : len(d)] = d[:, 1]
    nbits = int(spans.max()).bit_length()
    ll_s = float(
        hmm.loglik(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(ks), nbits, 8,
        )
    )
    assert np.isclose(ll_w, ll_s, rtol=1e-10), (ll_w, ll_s)


def test_estep_stats_match():
    pi, T, E, data = make_problem(seed=1)
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    args = (jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E))
    ll_w, g_w, x_w, gs_w = wk.estep_windows(
        *args, jnp.asarray(keys), jnp.asarray(valid), soc
    )
    C = len(data)
    Lmax = -(-max(len(d) for d in data) // 8) * 8
    spans = np.zeros((C, Lmax), np.int32)
    ks = np.zeros((C, Lmax), np.int32)
    for i, d in enumerate(data):
        spans[i, : len(d)] = d[:, 0]
        ks[i, : len(d)] = d[:, 1]
    nbits = int(spans.max()).bit_length()
    ll_s, g_s, x_s, gs_s = hmm.estep(
        *args, jnp.asarray(spans), jnp.asarray(ks), nbits, 8
    )
    assert np.isclose(float(ll_w), float(ll_s), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g_w), np.asarray(g_s), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(x_w), np.asarray(x_s), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(gs_w), np.asarray(gs_s), rtol=1e-7)


def test_rare_key_dense_f32_backward():
    """Regression (round 2): rare-key-dense streams drove within-block
    products to the 1e-35 floor, biasing the forward ll AND overflowing the
    f32 backward into NaN statistics.  Per-step rescaling fixes both: the
    f32 E-step must be finite and match the f64 E-step."""
    rng = np.random.RandomState(7)
    M, nk = 8, 15
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    # emission table with genuinely rare keys (down to 1e-8, like high-b
    # CSFS entries), drawn uniformly so rare keys cluster
    E = 10.0 ** rng.uniform(-8, 0, (nk, M))
    data = []
    for _ in range(3):
        rows = rng.randint(30, 70)
        d = np.c_[rng.randint(1, 12, rows), rng.randint(0, nk, rows)]
        data.append(d.astype(np.int64))
    key_id = {(k,): k for k in range(nk)}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    outs = {}
    for dt in (jnp.float32, jnp.float64):
        out = wk.estep_windows(
            jnp.asarray(pi, dt), jnp.asarray(T, dt), jnp.asarray(E, dt),
            jnp.asarray(keys), jnp.asarray(valid), soc,
        )
        for o in out[1:]:
            assert np.all(np.isfinite(np.asarray(o))), dt
        outs[dt] = out
    assert np.isclose(
        float(outs[jnp.float32][0]), float(outs[jnp.float64][0]), rtol=1e-3
    )
    # f64 window kernel must agree with the f64 span kernel (which rescales
    # at every squaring) — guards against floor-induced forward bias
    C = len(data)
    Lmax = -(-max(len(d) for d in data) // 8) * 8
    spans = np.zeros((C, Lmax), np.int32)
    ks = np.zeros((C, Lmax), np.int32)
    for i, d in enumerate(data):
        spans[i, : len(d)] = d[:, 0]
        ks[i, : len(d)] = d[:, 1]
    nbits = int(spans.max()).bit_length()
    ll_s = float(
        hmm.loglik(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(spans), jnp.asarray(ks), nbits, 8,
        )
    )
    assert np.isclose(float(outs[jnp.float64][0]), ll_s, rtol=1e-9)


def test_f32_consistency():
    pi, T, E, data = make_problem(seed=2, C=2, rows=200)
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=64)
    ll64 = float(
        wk.loglik_windows(
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(keys), jnp.asarray(valid), soc,
        )
    )
    args32 = (
        jnp.asarray(pi, jnp.float32), jnp.asarray(T, jnp.float32),
        jnp.asarray(E, jnp.float32),
        jnp.asarray(keys), jnp.asarray(valid), soc,
    )
    ll32 = float(wk.loglik_windows(*args32))
    assert np.isclose(ll32, ll64, rtol=2e-4)
    # the escalation rungs keep exact-f32 carries/lookups
    for p in ("tensorfloat32", "highest"):
        llp = float(wk.loglik_windows(*args32, precision=p))
        assert np.isclose(llp, ll64, rtol=2e-5), p


def test_estep_direct_matches_ad():
    """The direct (AD-free) two-pass Baum-Welch kernel must reproduce the
    gradient-identity statistics to machine precision in f64, across
    multi-segment contigs, single-window contigs, and segment padding."""
    for seed, C, rows, st in [(1, 3, 40, 16), (5, 1, 3, 16), (11, 2, 1, 8)]:
        pi, T, E, data = make_problem(seed=seed, C=C, rows=rows)
        key_id = {(k,): k for k in range(E.shape[0])}
        keys, valid, soc = wk.pack_windows(data, key_id, seg_target=st)
        args = (
            jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
            jnp.asarray(keys), jnp.asarray(valid), soc,
        )
        ad = wk.estep_windows(*args)
        dr = wk.estep_direct(*args)
        assert np.isclose(float(ad[0]), float(dr[0]), rtol=1e-12)
        for a, d in zip(ad[1:], dr[1:]):
            np.testing.assert_allclose(
                np.asarray(d), np.asarray(a), rtol=1e-12, atol=1e-15
            )


def test_estep_direct_rare_keys_f32():
    """f32 direct kernel on rare-key-dense streams: finite, near the f64
    oracle, and with exactly-conserved totals (f64 accumulators — sum of
    gamma_sums/xisum equals the window count, sum of the pi-stat equals the
    contig count)."""
    rng = np.random.RandomState(7)
    M, nk = 8, 15
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = 10.0 ** rng.uniform(-8, 0, (nk, M))
    data = []
    for _ in range(3):
        rows = rng.randint(30, 70)
        d = np.c_[rng.randint(1, 12, rows), rng.randint(0, nk, rows)]
        data.append(d.astype(np.int64))
    key_id = {(k,): k for k in range(nk)}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    n_windows = float(sum(d[:, 0].sum() for d in data))
    f64 = wk.estep_direct(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(keys), jnp.asarray(valid), soc,
    )
    f32 = wk.estep_direct(
        jnp.asarray(pi, jnp.float32), jnp.asarray(T, jnp.float32),
        jnp.asarray(E, jnp.float32), jnp.asarray(keys),
        jnp.asarray(valid), soc,
    )
    for o in f32[1:]:
        assert np.all(np.isfinite(np.asarray(o)))
    assert np.isclose(float(f32[0]), float(f64[0]), rtol=1e-3)
    np.testing.assert_allclose(float(np.sum(np.asarray(f32[1]))), 3.0,
                               rtol=1e-6)
    np.testing.assert_allclose(float(np.sum(np.asarray(f32[2]))), n_windows,
                               rtol=1e-6)
    np.testing.assert_allclose(float(np.sum(np.asarray(f32[3]))), n_windows,
                               rtol=1e-6)
    for a, d, tol in zip(f64[1:], f32[1:], (2e-2, 1e-2, 1e-2)):
        np.testing.assert_allclose(
            np.asarray(d, np.float64), np.asarray(a), rtol=tol, atol=1e-8
        )


def test_stats_pass_without_e_all():
    """stats_pass's one-hot-rebuild fallback (e_all=None) must agree with
    the emission-stream path to machine precision in f64."""
    pi, T, E, data = make_problem(seed=3)
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    Tj, Ej = jnp.asarray(T), jnp.asarray(E)
    kj, vj = jnp.asarray(keys), jnp.asarray(valid)
    ops, logs, e_all = wk.segment_operators(Tj, Ej, kj, vj, emit_e=True)
    seg_has = jnp.any(vj, axis=1)
    ll, A_in, Q_end, cvalid = wk.contig_boundaries(
        jnp.asarray(pi), ops, logs, soc, seg_has
    )
    with_e = wk.stats_pass(Tj, Ej, kj, vj, A_in, Q_end, e_all)
    without = wk.stats_pass(Tj, Ej, kj, vj, A_in, Q_end, None)
    # alpha_end / xo / gsum are scale-free and must match exactly;
    # u_start carries per-window emission scalings that differ between the
    # paths but cancel in the boundary stats — checked below end-to-end
    for i in (0, 2, 3):
        np.testing.assert_allclose(
            np.asarray(without[i], np.float64),
            np.asarray(with_e[i], np.float64), rtol=1e-12, atol=1e-15,
        )
    outs = []
    for ae, us, xo in (with_e[:3], without[:3]):
        xob, pist = wk.boundary_stats(
            jnp.asarray(pi), Tj, ae, us, jnp.asarray(xo, jnp.float64),
            soc, cvalid,
        )
        outs.append((np.asarray(xob, np.float64), np.asarray(pist, np.float64)))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-12)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-12)


def test_estep_direct_many_keys_gather_path(monkeypatch):
    "n_keys > ONEHOT_MAX_KEYS exercises the gather/scatter branch."
    monkeypatch.setattr(wk, "ONEHOT_MAX_KEYS", 4)
    pi, T, E, data = make_problem(seed=4)
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    args = (
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(keys), jnp.asarray(valid), soc,
    )
    dr = wk.estep_direct(*args)
    ad = wk.estep_windows(*args)
    assert np.isclose(float(ad[0]), float(dr[0]), rtol=1e-12)
    for a, d in zip(ad[1:], dr[1:]):
        np.testing.assert_allclose(
            np.asarray(d), np.asarray(a), rtol=1e-11, atol=1e-14
        )


def test_estep_direct_no_stream():
    "The e_stream=False memory fallback must be exactly equivalent."
    pi, T, E, data = make_problem(seed=6)
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    args = (
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(keys), jnp.asarray(valid), soc,
    )
    a = wk.estep_direct(*args)
    b = wk.estep_direct(*args, e_stream=False)
    assert np.isclose(float(a[0]), float(b[0]), rtol=1e-13)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(x), rtol=1e-12, atol=1e-15
        )


def test_estep_direct_alpha_remat_matches():
    """The alpha-remat path (blocked recompute from snapshots) must
    reproduce the stored-alpha statistics to machine precision in f64,
    with and without the emission stream, across block sizes."""
    pi, T, E, data = make_problem(seed=9, C=3, rows=40)
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    args = (
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(keys), jnp.asarray(valid), soc,
    )
    base = wk.estep_direct(*args)
    L = keys.shape[1]
    blocks = sorted({wk.remat_block_size(L), wk.RESCALE_EVERY, L})
    for estream in (True, False):
        for blk in blocks:
            if L % blk:
                continue
            out = wk.estep_direct(
                *args, e_stream=estream, alpha_remat=blk
            )
            assert np.isclose(float(out[0]), float(base[0]), rtol=1e-12), (
                estream, blk,
            )
            for a, b in zip(base[1:], out[1:]):
                np.testing.assert_allclose(
                    np.asarray(b), np.asarray(a), rtol=1e-11, atol=1e-14
                )


def test_sharded_direct_estep_alpha_remat():
    "Remat flag through the segment-sharded mesh path == single device."
    from smcpp_jax.parallel import mesh as mesh_mod

    pi, T, E, data = make_problem(seed=10, C=4, rows=30)
    key_id = {(k,): k for k in range(E.shape[0])}
    keys, valid, soc = wk.pack_windows(data, key_id, seg_target=16)
    mesh = mesh_mod.make_mesh()
    keys_p, valid_p = mesh_mod.pad_segments(keys, valid, mesh.devices.size)
    fn = mesh_mod.make_sharded_direct_estep(
        mesh, soc, alpha_remat=wk.remat_block_size(keys.shape[1])
    )
    sh = fn(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(keys_p), jnp.asarray(valid_p),
    )
    base = wk.estep_direct(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(keys), jnp.asarray(valid), soc,
    )
    assert np.isclose(float(sh[0]), float(base[0]), rtol=1e-12)
    for a, b in zip(base[1:], sh[1:]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-11, atol=1e-14
        )
