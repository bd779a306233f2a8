"""Multi-chip data parallelism over contigs.

The reference's only scaling axis is OpenMP threads over per-contig HMMs
(src/inference_manager.cpp:89-106).  The accelerator equivalent: a
``('data',)`` device mesh; the padded (C, L) span/key arrays are sharded on
the contig axis, pi/T/E are replicated, and the E-step sufficient statistics
(which are gradients of the summed log-likelihood w.r.t. the replicated
tensors) are all-reduced by XLA automatically — the psum falls out of
differentiating a sharded-sum loss w.r.t. replicated inputs.

Multi-host execution uses the same code path after ``jax.distributed``
initialization: jax.jit global arrays span hosts transparently.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import hmm


def compute_devices(max_devices=None):
    """Devices for the E-step, in production-default order.

    All devices of the default backend, optionally capped by ``max_devices``
    or the ``SMCPP_JAX_DEVICES`` environment variable.  This is the device
    equivalent of the reference's ``--cores`` -> ``omp_set_num_threads``
    control (smcpp/_smcpp.pyx:61-64)."""
    import os

    devs = jax.devices()
    cap = max_devices
    if cap is None:
        env = os.environ.get("SMCPP_JAX_DEVICES")
        cap = int(env) if env else None
    if cap is not None:
        devs = devs[: max(1, cap)]
    return list(devs)


def make_mesh(devices=None):
    "1-D ('data',) mesh over the given (default: all) devices."
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("data",))


def shard_batch(mesh, spans, keys):
    """Pad the contig axis to a multiple of the mesh size and place the
    arrays with contig-sharded layout."""
    n = mesh.devices.size
    C = spans.shape[0]
    pad = (-C) % n
    if pad:
        spans = np.concatenate(
            [spans, np.zeros((pad, spans.shape[1]), spans.dtype)]
        )
        keys = np.concatenate(
            [keys, np.zeros((pad, keys.shape[1]), keys.dtype)]
        )
    sh = NamedSharding(mesh, P("data", None))
    return jax.device_put(spans, sh), jax.device_put(keys, sh)


def make_sharded_estep(mesh, nbits, chunk, precision=None):
    """Jitted E-step with contig-data-parallel sharding.

    Returns f(pi, T, E, spans, keys) -> (ll, gamma0, xisum, gamma_sums),
    everything replicated on output.
    """
    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    fn = partial(hmm.estep, nbits=nbits, chunk=chunk)
    if precision is not None:
        base = fn

        def fn(pi, T, E, spans, keys):
            with jax.default_matmul_precision(precision):
                return base(pi, T, E, spans, keys)

    return jax.jit(
        fn,
        in_shardings=(repl, repl, repl, data_sh, data_sh),
        out_shardings=(repl, repl, repl, repl),
    )


def make_sharded_decode(mesh, nbits, chunk):
    """Contig-sharded posterior decode (ops/hmm.py:decode_gammas).

    f(pi, T, E, spans, keys) -> (C, L, M) row-resolution gammas, contig
    axis sharded in and out — each device decodes its own contigs; there
    is no cross-device reduction (unlike the E-step statistics)."""
    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    local = jax.shard_map(
        partial(hmm.decode_gammas, nbits=nbits, chunk=chunk),
        mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None), P("data", None)),
        out_specs=P("data", None, None),
        check_vma=False,
    )
    # replicated output: the caller reads the whole array on every process
    # (np.asarray on a contig-sharded global array is not addressable from
    # one host in a multi-host job); the all-gather is one decode's worth
    return jax.jit(
        local,
        in_shardings=(repl, repl, repl, data_sh, data_sh),
        out_shardings=repl,
    )


def make_sharded_viterbi(mesh, nbits):
    """Contig-sharded MAP decode (ops/hmm.py:viterbi_paths) -> (C, L) int32."""
    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    local = jax.shard_map(
        partial(hmm.viterbi_paths, nbits=nbits),
        mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None), P("data", None)),
        out_specs=P("data", None),
        check_vma=False,
    )
    return jax.jit(
        local,
        in_shardings=(repl, repl, repl, data_sh, data_sh),
        out_shardings=repl,
    )


def make_sharded_loglik(mesh, nbits, chunk):
    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    return jax.jit(
        partial(hmm.loglik, nbits=nbits, chunk=chunk),
        in_shardings=(repl, repl, repl, data_sh, data_sh),
        out_shardings=repl,
    )


# ---------------------------------------------------------------------------
# Window-kernel parallelism: shard the SEGMENT axis.
#
# The expensive part of the window kernel is the per-segment transfer
# operators (ops/window_kernel.py:segment_operators) — embarrassingly
# parallel over equal-length segments, so sharding that axis is perfectly
# load-balanced AND gives sequence parallelism: a single long contig is cut
# into segments that spread over every chip (the reference's HMM recurrence
# is strictly sequential, src/hmm.cpp:61-96).  The tiny per-contig scan over
# (S, M, M) operators runs replicated after an all-gather (ops are ~KB-scale;
# the gather is the transpose of a reduce_scatter in the backward pass).
# ---------------------------------------------------------------------------

def pad_segments(keys, valid, n_devices):
    """Pad the segment axis to a multiple of the mesh size.

    Padding segments are all-invalid: they produce identity operators with
    zero log-scale and are never referenced by seg_of_contig."""
    S = keys.shape[0]
    pad = (-S) % n_devices
    if pad:
        keys = np.concatenate(
            [keys, np.zeros((pad, keys.shape[1]), keys.dtype)]
        )
        valid = np.concatenate(
            [valid, np.zeros((pad, valid.shape[1]), valid.dtype)]
        )
    return keys, valid


def make_sharded_direct_estep(mesh, seg_of_contig, precision=None,
                              e_stream=True, alpha_remat=None, unroll=None,
                              sweep="xla"):
    """Segment-sharded direct (AD-free) window E-step.

    Same contract as ``make_sharded_window_estep`` but built from the
    two-pass Baum-Welch kernel (ops/window_kernel.py:estep_direct): the
    segment-operator pass and the lockstep alpha/beta statistic sweeps run
    shard_map'd over the segment axis with xisum/gamma_sums psum'd across
    the mesh; the tiny contig-level boundary scans and cross-boundary
    statistics run replicated.  ``e_stream=False`` skips the (L, M, S)
    emission stream, ``alpha_remat`` trades the alpha stream for per-block
    recompute (memory-budget fallbacks, see estep_direct); ``sweep``
    picks the statistic-sweep implementation (window_kernel.choose_sweep,
    at the per-device segment count)."""
    from ..ops import window_kernel as wk

    op_out = (P("data", None, None), P("data"))
    if e_stream:
        op_out = op_out + (P(None, None, "data"),)
    op_local = jax.shard_map(
        partial(wk.segment_operators, precision=precision,
                emit_e=e_stream, unroll=unroll),
        mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None)),
        out_specs=op_out,
        check_vma=False,
    )
    stats_in = (P(), P(), P("data", None), P("data", None),
                P("data", None), P("data", None))
    if e_stream:
        stats_in = stats_in + (P(None, None, "data"),)
    stats_local = jax.shard_map(
        partial(wk.stats_pass, precision=precision, axis_name="data",
                alpha_remat=alpha_remat, unroll=unroll, sweep=sweep),
        mesh=mesh,
        in_specs=stats_in,
        out_specs=(P("data", None), P("data", None), P(), P()),
        check_vma=False,
    )

    def estep(pi, T, E, keys, valid):
        if e_stream:
            ops, logs, e_all = op_local(T, E, keys, valid)
        else:
            ops, logs = op_local(T, E, keys, valid)
        seg_has = jnp.any(valid, axis=1)
        ll, A_in, Q_end, cvalid = wk.contig_boundaries(
            pi, ops, logs, seg_of_contig, seg_has
        )
        args = (T, E, keys, valid, A_in, Q_end)
        if e_stream:
            args = args + (e_all,)
        alpha_end, u_start, xo, gsum = stats_local(*args)
        xo, pi_stat = wk.boundary_stats(
            pi, T, alpha_end, u_start, xo, seg_of_contig, cvalid
        )
        return ll, pi_stat, xo * T.astype(xo.dtype), gsum

    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    return jax.jit(
        estep,
        in_shardings=(repl, repl, repl, data_sh, data_sh),
        out_shardings=(repl, repl, repl, repl),
    )


def make_sharded_window_decode(mesh, seg_of_contig, n_rows, precision=None,
                               unroll=None):
    """Segment-sharded window-kernel posterior decode
    (ops/window_kernel.py:decode_gammas_windows): each shard sweeps its
    segments, emits its per-window gamma stream locally, aggregates it to
    rows with a local segment-sum, and the (n_rows, M) partials psum over
    the mesh.  f(pi, T, E, keys, valid, row_ids) -> (ll, gammas).
    Precision defaults to tf32 (exact f32 carries) — bf16 operator-carry
    noise is visible in user-facing per-row posteriors; see
    decode_gammas_windows."""
    from ..ops import window_kernel as wk

    if precision is None:
        precision = "tensorfloat32"

    op_local = jax.shard_map(
        partial(wk.segment_operators, precision=precision, unroll=unroll),
        mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None)),
        out_specs=(P("data", None, None), P("data")),
        check_vma=False,
    )

    def stats_gamma_local(T, E, keys, valid, A_in, Q_end, row_ids):
        _, _, _, _, gam = wk.stats_pass(
            T, E, keys, valid, A_in, Q_end, None, precision,
            emit_gamma=True, unroll=unroll,
        )
        Mdim = T.shape[0]
        # segment-major flattening: locally sorted row ids (see
        # ops/window_kernel.py:decode_gammas_windows)
        flat = jnp.transpose(gam, (2, 0, 1)).reshape(-1, Mdim).astype(
            jnp.float32
        )
        ids = row_ids.reshape(-1)
        g = jax.ops.segment_sum(
            flat, ids, num_segments=n_rows, indices_are_sorted=True
        )
        return jax.lax.psum(g, "data")

    stats_local = jax.shard_map(
        stats_gamma_local,
        mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None),
                  P("data", None), P("data", None), P("data", None)),
        out_specs=P(),
        check_vma=False,
    )

    def decode(pi, T, E, keys, valid, row_ids):
        ops, logs = op_local(T, E, keys, valid)
        seg_has = jnp.any(valid, axis=1)
        ll, A_in, Q_end, cvalid = wk.contig_boundaries(
            pi, ops, logs, seg_of_contig, seg_has
        )
        g = stats_local(T, E, keys, valid, A_in, Q_end, row_ids)
        return ll, g

    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    return jax.jit(
        decode,
        in_shardings=(repl, repl, repl, data_sh, data_sh, data_sh),
        out_shardings=(repl, repl),
    )


def make_sharded_window_viterbi(mesh, seg_of_contig, block=None):
    """Segment-sharded window-kernel MAP decode
    (ops/window_kernel.py:viterbi_windows): phase A (segment max-plus
    operators) and phase C (interior backpointers + backtrace) run
    shard_map'd over segments; the tiny per-contig boundary chains run
    replicated.  f(pi, T, E, keys, valid, row_ends) -> (n_rows,) int32.
    ``block`` streams phase C's backpointers per block (the over-budget
    mode; ops/window_kernel.py:viterbi_segment_paths)."""
    from ..ops import window_kernel as wk

    opsA = jax.shard_map(
        wk.viterbi_segment_ops,
        mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None)),
        out_specs=P("data", None, None),
        check_vma=False,
    )

    def local_paths(T, E, keys, valid, seg_entry, seg_exit, row_ends):
        path = wk.viterbi_segment_paths(
            T, E, keys, valid, seg_entry, seg_exit, block=block
        )
        S_local, L = keys.shape
        flat = path.T.reshape(-1)
        base = jax.lax.axis_index("data") * (S_local * L)
        rel = row_ends - base
        ok = (rel >= 0) & (rel < S_local * L)
        vals = jnp.where(
            ok, jnp.take(flat, jnp.clip(rel, 0, S_local * L - 1)), 0
        )
        return jax.lax.psum(vals, "data")

    pc = jax.shard_map(
        local_paths,
        mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None),
                  P("data"), P("data"), P()),
        out_specs=P(),
        check_vma=False,
    )

    def vit(pi, T, E, keys, valid, row_ends):
        Wops = opsA(T, E, keys, valid)
        seg_entry, seg_exit = wk.viterbi_boundary_states(
            pi, Wops, seg_of_contig
        )
        return pc(T, E, keys, valid, seg_entry, seg_exit, row_ends)

    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    return jax.jit(
        vit,
        in_shardings=(repl, repl, repl, data_sh, data_sh, repl),
        out_shardings=repl,
    )


def make_sharded_window_estep(mesh, seg_of_contig, precision=None,
                              unroll=None):
    """Segment-sharded window-kernel E-step.

    f(pi, T, E, keys, valid) -> (ll, gamma0, xisum, gamma_sums) with
    keys/valid (S, L) sharded on the segment axis (S a multiple of the mesh
    size; see pad_segments).  Gradients of the replicated (pi, T, E) through
    the shard_map transpose come out psum'd across the mesh automatically.
    """
    from ..ops import window_kernel as wk

    op_local = jax.shard_map(
        partial(wk.segment_operators, precision=precision, unroll=unroll),
        mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None)),
        out_specs=(P("data", None, None), P("data")),
        check_vma=False,
    )

    def total_ll(pi, T, E, keys, valid, seg_has):
        ops, logs = op_local(T, E, keys, valid)
        return wk.contig_scan(pi, ops, logs, seg_of_contig, seg_has)

    def estep(pi, T, E, keys, valid):
        seg_has = jnp.any(valid, axis=1)
        ll, grads = jax.value_and_grad(total_ll, argnums=(0, 1, 2))(
            pi, T, E, keys, valid, seg_has
        )
        return ll, pi * grads[0], T * grads[1], E * grads[2]

    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P("data", None))
    return jax.jit(
        estep,
        in_shardings=(repl, repl, repl, data_sh, data_sh),
        out_shardings=(repl, repl, repl, repl),
    )
