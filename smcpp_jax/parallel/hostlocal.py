"""Host-local data ingestion for multi-host (pod) jobs.

The replicated-driver multi-host path (parallel/distributed.py) is correct
but every process loads, filters, and stages the ENTIRE dataset — at pod
scale (SURVEY.md C5: n = 200, 100+ contigs, ~25 Gbp) that replicates the
whole host pipeline per host.  This module makes each process ingest only
its own contiguous shard of the input files and assemble the GLOBAL
picture from three ingredients:

* cheap header-only reads of every file (population structure, sample
  sizes — data/format.py:load_header), so no collective is needed for
  the model setup;
* a handful of tiny setup-time collectives
  (``jax.experimental.multihost_utils.process_allgather``) for the
  aggregate statistics the fit needs globally (Watterson theta, windowed
  mutation counts, the emission-key union, span/key totals);
* ``jax.make_array_from_process_local_data`` to place each process's
  packed window segments directly into the global segment-sharded arrays
  the mesh E-step consumes (parallel/mesh.py) — no host ever
  materializes another host's observations.

The reference is single-node by construction
(/root/reference/src/inference_manager.cpp:89-106); there is nothing to
mirror — the sharding plan follows SURVEY.md §2.3.

CRITICAL invariant: every process must execute the same sequence of
collectives.  All helpers here run unconditionally on every process (an
empty local shard participates with zero-length contributions); callers
must never gate a collective on local data contents.

File assignment is CONTIGUOUS (``np.array_split`` order), not strided, so
process-order concatenation of any per-contig gathered quantity
reproduces the exact ordering a single-process driver would see — this
keeps order-sensitive consumers (the empirical-TMRCA GMM) bit-identical
to the replicated path.
"""

import logging
import os

import jax
import numpy as np

logger = logging.getLogger(__name__)


def active():
    """True when multi-process execution is live and host-local ingestion
    has not been disabled (SMCPP_JAX_REPLICATED_DATA=1 or
    --replicated-data)."""
    if os.environ.get("SMCPP_JAX_REPLICATED_DATA") == "1":
        return False
    return jax.process_count() > 1


def shard_files(files):
    "This process's contiguous shard of the (globally ordered) file list."
    parts = np.array_split(np.asarray(files, dtype=object),
                           jax.process_count())
    return [str(f) for f in parts[jax.process_index()]]


def shard_ingestion(all_files):
    """One-line headers of ALL files + this process's contiguous file
    shard — the shared entry of every host-local command (estimate /
    split via BaseAnalysis, posterior directly), so file assignment and
    header parsing can never diverge between them."""
    from ..data import format as fmt

    headers = [fmt.load_header(str(f)) for f in all_files]
    local = shard_files(all_files)
    logger.info(
        "host-local ingestion: process %d/%d loads %d of %d files",
        jax.process_index(), jax.process_count(),
        len(local), len(all_files),
    )
    return headers, local


# ---------------------------------------------------------------------------
# Tiny setup-time collectives.  process_allgather requires equal shapes on
# every process, so variable-length contributions are padded to the global
# max (one extra scalar gather for the lengths).
# ---------------------------------------------------------------------------

def _gather_stacked(x):
    """(P, ...) stack of every process's equal-shaped array, as NumPy.

    Every gather is preceded by a fixed-size fingerprint collective
    asserting that all processes contribute the same shape AND dtype: a
    mismatch (e.g. np.bincount returning int64 on an EMPTY shard while the
    others send float64 — a real bug this caught) makes the gloo transport
    silently deliver corrupt bytes instead of failing, so it must be
    detected before the payload collective."""
    from jax.experimental import multihost_utils as mu

    x = np.asarray(x)
    fp = np.zeros(8, np.int64)
    fp[0] = x.ndim
    fp[1] = x.dtype.num
    fp[2 : 2 + min(x.ndim, 6)] = x.shape[:6]
    fps = np.asarray(mu.process_allgather(fp))
    if not (fps == fps[0]).all():
        raise RuntimeError(
            "host-local collective mismatch: processes contributed "
            f"different shapes/dtypes — fingerprints {fps.tolist()} "
            f"(this process: shape={x.shape}, dtype={x.dtype})"
        )
    return np.asarray(mu.process_allgather(x))


def allreduce_sum(x):
    "Global sum of a scalar/array contributed by every process."
    return _gather_stacked(x).sum(axis=0)


def allreduce_max(x):
    "Global max of a scalar/array contributed by every process."
    return _gather_stacked(x).max(axis=0)


def allgather_concat(a, ncols=None):
    """Concatenate every process's (n_p, ...) array along axis 0 in process
    order.  Row counts may differ; trailing dims must agree where nonempty
    (``ncols`` pins the trailing dim for processes with 0 rows)."""
    a = np.asarray(a)
    if a.ndim == 1:
        a = a[:, None]
        squeeze = True
    else:
        squeeze = False
    if ncols is None:
        ncols = int(allreduce_max(np.int64(a.shape[1] if a.size else 0)))
    if a.shape[0] == 0:
        a = a.reshape(0, ncols)
    assert a.shape[1] == ncols, (a.shape, ncols)
    counts = _gather_stacked(np.int64(a.shape[0]))
    nmax = int(counts.max())
    if a.shape[0] < nmax:
        pad = np.zeros((nmax - a.shape[0], ncols), a.dtype)
        a = np.concatenate([a, pad], axis=0)
    g = _gather_stacked(a)  # (P, nmax, ncols)
    out = np.concatenate(
        [g[p, : int(counts[p])] for p in range(g.shape[0])], axis=0
    )
    return out[:, 0] if squeeze else out


def global_unique_rows(rows, ncols=None):
    "Global np.unique(axis=0) of every process's (n_p, w) int rows."
    return np.unique(allgather_concat(rows, ncols=ncols), axis=0)


# ---------------------------------------------------------------------------
# Window packing: local segments -> global segment-sharded arrays.
# ---------------------------------------------------------------------------

def owned_rows(sharding, global_shape):
    """Global row indices owned by THIS process under ``sharding``, in the
    sorted order ``jax.make_array_from_process_local_data`` maps local rows
    to (its docstring: addressable slices map to local rows in global-index
    order)."""
    imap = sharding.addressable_devices_indices_map(tuple(global_shape))
    slices = sorted(
        {(idx[0].start or 0, idx[0].stop) for idx in imap.values()}
    )
    out = []
    for start, stop in slices:
        stop = global_shape[0] if stop is None else stop
        out.append(np.arange(start, stop, dtype=np.int64))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def pack_windows_local(data_list, key_id, mesh, pad_key=0, seg_target=8192,
                       min_seg_len=64, max_seg_len=16384):
    """Pack THIS process's contigs into its shard of the global
    segment-sharded window arrays.

    Returns (keys, valid, seg_of_contig) where keys/valid are GLOBAL
    jax.Arrays placed with NamedSharding(mesh, P('data', None)) via
    make_array_from_process_local_data (each process materializes only its
    own rows), and seg_of_contig is the gathered (C_global, NS) map with
    GLOBAL segment ids — identical on every process, so the jitted E-step
    program (which closes over it) is identical too.

    Single-process semantics match ops/window_kernel.py:pack_windows up to
    segment-row ordering and padding (all-invalid padding rows are never
    referenced by seg_of_contig and contribute identity operators).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import window_kernel as wk

    win = wk.decompress_to_windows(data_list, key_id)
    W_local = sum(len(w) for w in win)
    W = int(allreduce_sum(np.int64(W_local)))
    L = wk.window_segment_length(W, seg_target, min_seg_len, max_seg_len)
    segs, seg_ids = wk.cut_segments(win, L)
    S_local = len(segs)

    # Global sizing: every process contributes an equal block of
    # ldc * per_dev rows (ldc = this process's device count in the mesh,
    # assumed homogeneous), sized for the largest local shard.
    n_dev = int(mesh.devices.size)
    pidx = jax.process_index()
    ldc = sum(1 for d in mesh.devices.flat if d.process_index == pidx)
    n_proc = jax.process_count()
    assert ldc * n_proc == n_dev, (
        f"mesh has {n_dev} devices over {n_proc} processes but this "
        f"process addresses {ldc} — host-local packing needs a homogeneous "
        "process-spanning mesh"
    )
    S_max = int(allreduce_max(np.int64(S_local)))
    per_dev = -(-max(S_max, 1) // ldc)
    block = ldc * per_dev
    S_global = n_dev * per_dev

    keys_l = np.full((block, L), pad_key, dtype=np.int32)
    valid_l = np.zeros((block, L), dtype=bool)
    for i, seg in enumerate(segs):
        keys_l[i, : len(seg)] = seg
        valid_l[i, : len(seg)] = True

    sh = NamedSharding(mesh, P("data", None))
    gshape = (S_global, L)
    rows = owned_rows(sh, gshape)
    assert len(rows) == block, (len(rows), block)
    # real local segments must land on an ASCENDING run of global rows:
    # decode row ids and Viterbi row ends rely on local stream order
    # mapping to increasing global flat positions (true whenever the mesh
    # device order groups processes, which make_mesh's id sort gives)
    assert np.all(np.diff(rows) > 0)
    gkeys = jax.make_array_from_process_local_data(sh, keys_l, gshape)
    gvalid = jax.make_array_from_process_local_data(sh, valid_l, gshape)

    # seg_of_contig with GLOBAL segment ids, gathered over processes in
    # process (= file) order.  -1 padding survives the mapping.
    NS_local = max((len(i) for i in seg_ids), default=0)
    NS = int(allreduce_max(np.int64(NS_local)))
    NS = max(NS, 1)
    soc_l = np.full((len(seg_ids), NS), -1, dtype=np.int64)
    for c, ids in enumerate(seg_ids):
        soc_l[c, : len(ids)] = rows[np.asarray(ids, dtype=np.int64)]
    soc = allgather_concat(soc_l, ncols=NS)
    logger.info(
        "host-local window packing: process %d/%d packed %d contigs / %d "
        "segments (L=%d) into rows %s..%s of the (%d, %d) global arrays",
        pidx, n_proc, len(seg_ids), S_local, L,
        rows[0] if len(rows) else "-", rows[-1] if len(rows) else "-",
        S_global, L,
    )
    import types

    local = types.SimpleNamespace(
        rows=rows, seg_ids=seg_ids, block=block, L=L, sharding=sh,
        gshape=gshape,
    )
    return gkeys, gvalid, soc, local


# ---------------------------------------------------------------------------
# Window -> row decode placement (posterior / Viterbi under host-local).
# ---------------------------------------------------------------------------

def decode_row_placement(spans_list, local):
    """Row-id / row-end staging for the window decodes when each process
    packed only its own contigs (pack_windows_local).

    Rows are numbered process-major (= global file order, since file
    shards are contiguous).  Returns
    (row_ids, n_rows, row_offset, ends_global):

    * row_ids: GLOBAL (S_global, L) int32 jax.Array, placed per process
      (make_array_from_process_local_data) — window -> global row id;
      padding maps to the preceding row (zero gamma) inside real
      segments and to ``n_rows`` (dropped by segment_sum) on the
      all-padding rows, preserving per-shard sortedness.
    * n_rows: global compressed-row total.
    * row_offset: first global row id owned by THIS process.
    * ends_global: (n_rows,) int64 host array — each row's LAST window's
      flat segment-major position (order-free consumers only: the mesh
      Viterbi picks by position with a psum, it never assumes
      monotonicity across processes)."""
    counts = _gather_stacked(
        np.int64(sum(len(s) for s in spans_list))
    )
    off = int(counts[: jax.process_index()].sum())
    n_rows = int(counts.sum())
    L, block = local.L, local.block
    rows, seg_ids = local.rows, local.seg_ids
    rid_l = np.full((block, L), n_rows, np.int32)
    ends = []
    o = off
    for c, spans in enumerate(spans_list):
        spans = np.asarray(spans, dtype=np.int64)
        ids = np.repeat(
            np.arange(o, o + len(spans), dtype=np.int32), spans
        )
        segs = np.asarray(seg_ids[c], dtype=np.int64)
        for j, sl in enumerate(segs):
            chunk = ids[j * L : (j + 1) * L]
            rid_l[sl, : len(chunk)] = chunk
            if len(chunk) < L and len(chunk):
                rid_l[sl, len(chunk):] = chunk[-1]
        w_end = np.cumsum(spans) - 1
        ends.append(rows[segs[w_end // L]] * L + (w_end % L))
        o += len(spans)
    ends_l = (
        np.concatenate(ends).astype(np.int64)
        if ends else np.zeros(0, np.int64)
    )
    ends_global = allgather_concat(ends_l)
    row_ids = jax.make_array_from_process_local_data(
        local.sharding, rid_l, local.gshape
    )
    return row_ids, n_rows, off, ends_global
