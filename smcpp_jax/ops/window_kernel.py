"""Window-resolution E-step kernel (the accelerator throughput path).

The span-compressed kernel (ops/hmm.py) runs batched MxM matmuls with a
*different* matrix per row — many tiny products that no matrix unit tiles
well.  This kernel instead decompresses the
observation stream to unit windows and advances many genome *segments* in
lockstep:

    X[j, s, k] <- e[s, i] * sum_j T^T[i, j] X[j, s, k]

Each step is ONE (M x M) @ (M x S*M) matmul with the shared transition
matrix — the S*M dimension is huge, so the contraction tiles well.
Per-segment transfer operators come out after L_seg steps;
a short batched scan over segments per contig finishes the forward pass.

Cost: 2 M^3 per window — the same order as the span-compressed kernel on
typical data (which pays ~2 bit_length(max_span) M^3 per compressed row),
at a far higher achieved FLOP/s.  Numerical control: every step floors
at ~1e-35 and renormalizes each segment block to unit max, tracking log
scales (cf. the reference's per-position normalization + 1e-10 alpha floor,
hmm.cpp:86-94).

E-step statistics, two ways:

* ``estep_direct`` (production): classical two-pass Baum-Welch.  The
  operator pass doubles as the forward sweep (and emits the per-window
  emission stream), tiny contig-level scans over the (S, M, M) operators
  produce per-segment boundary alpha/beta vectors, and two lockstep
  sweeps with only (M, S) state accumulate xisum / per-key posterior
  masses into f64 carries; cross-boundary transitions are added
  vectorized afterwards.  Every normalizer is window-local
  (Z = alpha . beta), so no global likelihood constant is threaded and
  scale factors cancel exactly.  Replaces the reference's span_Qs
  backward (src/hmm.cpp:97-153).
* ``estep_windows`` (fallback, SMCPP_JAX_ESTEP=ad): the same statistics
  as gradients of the forward log-likelihood via ``jax.value_and_grad``
  (identities as in ops/hmm.py), with a two-level remat through the scan
  (``RESCALE_EVERY``-sized checkpointed blocks).  Slower: the generic
  backward carries (M, S, M) cotangents.
"""

from functools import partial

import os

import jax
import jax.numpy as jnp
import numpy as np

RESCALE_EVERY = 8
FLOOR = 1e-35

# Matmul precision of the E-step: 'default' runs f32 dots at the backend's
# default rate (TF32 on an H100; see docs/DESIGN.md §2 for what each rung
# computes), 'tensorfloat32' and 'highest' escalate.  EM is robust to
# statistic noise at the 'default' level, and the optimizer escalates one
# rung whenever the likelihood decreases (manager.PRECISION_LADDER).  Set
# SMCPP_JAX_MATMUL_PRECISION to override.
MATMUL_PRECISION = os.environ.get("SMCPP_JAX_MATMUL_PRECISION", "default")


def choose_sweep(platform, S, L, M, n_keys, dtype=jnp.float32):
    """Statistic-sweep implementation for an E-step lowered for
    ``platform`` with (S, L) segment windows: the Pallas kernel
    (ops/pallas_sweeps.py) on a GPU at the shapes it serves, XLA's scans
    everywhere else.  Only the one-hot configuration of ``stats_pass``
    (no emission stream, no alpha-remat) can take the kernel."""
    from . import pallas_sweeps as ps

    if (platform == "gpu" and jnp.dtype(dtype) == jnp.float32
            and n_keys <= ONEHOT_MAX_KEYS and ps.supported(S, L, M, n_keys)):
        return "pallas"
    return "xla"

# Storage dtype of the statistic sweeps' per-window alpha stream.  'auto'
# ties the choice to the matmul precision (bf16 only at 'default'), so the
# optimizer's precision-escalation ladder also restores exact f32 storage.
# Set SMCPP_JAX_CARRY to 'float32'/'bfloat16' to pin.  The operator pass's
# (M, S, M) carry stays in the compute dtype at every rung: rounding the
# segment operators to bf16 every window put a relative log-likelihood
# error of ~1e-3 and statistic errors above 100% of the largest xisum entry
# on binned one- and two-population data, where a bf16 alpha stream costs
# ~3e-5.
CARRY = os.environ.get("SMCPP_JAX_CARRY", "auto")

# lax.scan unroll factor for the per-window loops (the operator pass's
# inner block scan and both statistic sweeps).  Each lockstep step does
# only a handful of small (M, S)-shaped ops, so fixed per-step scan
# overhead (loop bookkeeping, fusion boundaries) is a real fraction of
# step time at L ~ 16k windows; unrolling fuses UNROLL steps per loop
# iteration.  Set SMCPP_JAX_UNROLL=1 to disable.
#
# Both unroll knobs are IMPORT-TIME settings: they are read once here and
# baked into jit caches; changing the env vars mid-process has no effect
# on already-compiled configs.
def _env_unroll(name, default):
    raw = os.environ.get(name, default)
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer (got {raw!r})"
        ) from None
    return max(1, val)


UNROLL = _env_unroll("SMCPP_JAX_UNROLL", "8")
UNROLL_OUTER = _env_unroll("SMCPP_JAX_UNROLL_OUTER", "1")

# Compile-time/run-time tradeoff: unrolling inflates the HLO ~UNROLL-fold,
# and on small inputs (where per-step overhead is NOT the bottleneck) the
# only effect is a several-fold longer XLA compile — the dominant term of
# a tiny `estimate`'s cold start.  The kernels below accept
# ``unroll=None`` (use the tuned module default) or an
# explicit caller override; the manager passes 1 for small problems
# (manager._kernel_unroll).
def _eff_unroll(unroll):
    return UNROLL if unroll is None else max(1, int(unroll))


def _carry_dtype(precision, base_dtype):
    if base_dtype != jnp.float32:
        return base_dtype  # f64 paths (CPU oracle tests) keep f64 carries
    if CARRY == "auto":
        return jnp.bfloat16 if precision in ("default", "bfloat16") else base_dtype
    return jnp.dtype(CARRY)


ONEHOT_MAX_KEYS = 384


@jax.custom_vjp
def _lookup(E, k):
    """(M, S) emission columns E[k].T for one window row of keys k (S,).

    A gather going forward: exact at every precision rung (a one-hot
    product under TF32 rounds every emission probability to 10 mantissa
    bits, which alone put ~4e-4 relative error on an H100's
    log-likelihood).  Going backward the cotangent is accumulated by a
    one-hot product rather than the gather's scatter-add transpose."""
    return E[k].T


def _lookup_fwd(E, k):
    return E[k].T, (E, k)


def _lookup_bwd(res, g):
    E, k = res
    ohT = (jnp.arange(E.shape[0], dtype=k.dtype)[:, None] == k[None, :])
    dE = jnp.matmul(ohT.astype(g.dtype), g.T,
                    precision=jax.lax.Precision.HIGHEST)  # (n_keys, M)
    return dE.astype(E.dtype), None


_lookup.defvjp(_lookup_fwd, _lookup_bwd)


def _steps_block(Tt, E, X, logs, keys_blk, valid_blk, precision,
                 emit_e=False, unroll=None):
    """Advance ``X`` (M, S, M) through a block of window steps.

    keys_blk, valid_blk: (B, S).  Numerical control in two layers (together
    matching the reference's per-position alpha normalization + floor,
    hmm.cpp:86-94):

    * per step, each emission row is normalized to unit max and its log
      absorbed into ``logs`` — an (S, M)-sized op, M-times cheaper than
      rescaling the (M, S, M) state.  This removes the emission-driven
      within-block decay: un-normalized rare-key runs (e entries ~1e-8)
      decayed products to the 1e-35 floor, which both biased the forward
      likelihood (the floor bound as an absolute clamp) and overflowed the
      f32 backward cotangents into NaN statistics.
    * per block, the (M, S, M) state is renormalized to unit max.  The
      residual within-block decay is only transition mixing (bounded by the
      floored T column masses), which f32 absorbs over a block.

    The emission lookup (``_lookup``) is a gather whose transpose is a
    one-hot matmul when the key table is small, and a plain gather (with
    a scatter-add transpose) otherwise.
    """
    Mdim, S, _ = X.shape
    n_keys = E.shape[0]
    use_onehot = n_keys <= ONEHOT_MAX_KEYS
    cdt = X.dtype  # carry storage dtype
    tiny = jnp.finfo(E.dtype).tiny

    def step(carry, kv):
        X, logs = carry
        k, v = kv  # (S,) int, (S,) bool
        eT = _lookup(E, k) if use_onehot else E[k].T  # (M, S)
        with jax.default_matmul_precision(precision):
            Y = jnp.einsum("ij,jsk->isk", Tt, X)  # accumulates in E.dtype
        em = jnp.maximum(jnp.max(eT, axis=0), tiny)  # (S,)
        eT = eT / em[None, :]
        Y = Y * eT[:, :, None]
        Y = jnp.maximum(Y, FLOOR)
        X = jnp.where(v[None, :, None], Y, X).astype(cdt)
        logs = logs + jnp.where(v, jnp.log(em), 0.0)
        # e_all stays in E.dtype: its values are already matmul-tier-rounded
        # E rows, and a second (storage) rounding of the normalized quotient
        # measurably perturbs EM fits; the extra f32 traffic costs ~3%.
        return (X, logs), (eT if emit_e else None)

    (X, logs), e_blk = jax.lax.scan(
        step, (X, logs), (keys_blk, valid_blk),
        unroll=min(_eff_unroll(unroll), RESCALE_EVERY),
    )
    Xf = X.astype(E.dtype)
    m = jnp.maximum(jnp.max(jnp.abs(Xf), axis=(0, 2)), tiny)  # (S,)
    return (Xf / m[None, :, None]).astype(cdt), logs + jnp.log(m), e_blk


def segment_operators(T, E, keys, valid, precision=None, emit_e=False,
                      unroll=None):
    """Transfer operators for S segments of L windows each.

    keys, valid: (S, L) with L a multiple of RESCALE_EVERY.
    Returns ops (S, M, M) [ops[s] = product over the segment, applied as
    alpha_out = ops[s] @ alpha_in] and logs (S,).  With ``emit_e`` also
    returns the per-window normalized emission stream e_all (L, M, S) —
    lane-friendly (M, S) slices — a free by-product that saves the
    statistic sweeps (stats_pass) from rebuilding one-hot emission
    lookups per step (the one-hot materialization was ~half their HBM
    traffic)."""
    if precision is None:
        precision = MATMUL_PRECISION
    S, L = keys.shape
    Mdim = T.shape[0]
    assert L % RESCALE_EVERY == 0
    nblk = L // RESCALE_EVERY
    Tt = T.T
    cdt = T.dtype
    # X starts as S identity matrices, laid out (j, s, k)
    X0 = jnp.broadcast_to(
        jnp.eye(Mdim, dtype=cdt)[:, None, :], (Mdim, S, Mdim)
    )
    keys_b = keys.T.reshape(nblk, RESCALE_EVERY, S)
    valid_b = valid.T.reshape(nblk, RESCALE_EVERY, S)

    block = jax.checkpoint(
        lambda X, logs, kb, vb: _steps_block(
            Tt, E, X, logs, kb, vb, precision, emit_e, unroll
        ),
        prevent_cse=False,
    )

    def outer(carry, kv):
        X, logs = carry
        kb, vb = kv
        X, logs, e_blk = block(X, logs, kb, vb)
        return (X, logs), e_blk

    (X, logs), e_all = jax.lax.scan(
        outer, (X0, jnp.zeros(S, T.dtype)), (keys_b, valid_b),
        unroll=UNROLL_OUTER,
    )
    # X[i, s, k] = (product of step operators applied to basis vector k)_i,
    # so ops[s][i, k] = X[i, s, k] maps alpha_in -> alpha_out directly.
    # Cast back up so the contig scan's log-sum stays exact (one (S, M, M)
    # pass — negligible next to the L per-step carry passes).
    ops = jnp.transpose(X, (1, 0, 2)).astype(T.dtype)  # (S, i, k)
    if emit_e:
        return ops, logs, e_all.reshape(L, Mdim, S)
    return ops, logs


def contig_scan(pi, ops, logs, seg_of_contig, seg_has):
    """Per-contig scaled-forward scan over precomputed segment operators.

    ops (S, M, M), logs (S,), seg_has (S,) bool = segment has any valid
    window.  seg_of_contig: static (C, max_nseg) int array of segment ids in
    genomic order per contig, padded with -1.  Returns summed loglik."""
    C, NS = seg_of_contig.shape
    Mdim = ops.shape[-1]
    pad = np.asarray(seg_of_contig) < 0  # static
    idx = np.maximum(np.asarray(seg_of_contig), 0)
    eye = jnp.eye(Mdim, dtype=ops.dtype)
    ops_c = jnp.where(
        pad[:, :, None, None], eye[None, None], ops[idx]
    )  # (C, NS, M, M)
    logs_c = jnp.where(pad, 0.0, logs[idx])
    # mask padding contigs (no valid window anywhere) so their ll — and
    # hence every gradient statistic — is exactly zero under contig-axis
    # padding for mesh sharding
    cvalid = jnp.any(jnp.where(pad, False, seg_has[idx]), axis=1)  # (C,)

    def step(carry, x):
        alpha, ll = carry
        Mc, lg = x
        v = jnp.einsum("cij,cj->ci", Mc, alpha)
        c = jnp.sum(v, axis=1)
        dll = (jnp.log(c) + lg).astype(jnp.float64)
        dll = jnp.where(cvalid, dll, 0.0)
        return (v / c[:, None], ll + dll), None

    alpha0 = jnp.broadcast_to(pi.astype(ops.dtype), (C, Mdim))
    init = (alpha0, jnp.zeros(C, jnp.float64))
    (_, ll), _ = jax.lax.scan(
        step,
        init,
        (jnp.moveaxis(ops_c, 1, 0), jnp.moveaxis(logs_c, 1, 0)),
    )
    return jnp.sum(ll)


def loglik_windows(pi, T, E, keys, valid, seg_of_contig, precision=None,
                   unroll=None):
    """Log-likelihood over contigs from window-level segments.

    keys/valid: (S, L).  seg_of_contig: static (C, max_nseg) int array of
    segment ids in genomic order per contig, padded with -1.
    """
    ops, logs = segment_operators(T, E, keys, valid, precision, unroll=unroll)
    return contig_scan(pi, ops, logs, seg_of_contig, jnp.any(valid, axis=1))


def estep_windows(pi, T, E, keys, valid, seg_of_contig, precision=None,
                  unroll=None):
    "E-step statistics via the gradient identities (see ops/hmm.py)."

    def total_ll(pi, T, E):
        return loglik_windows(pi, T, E, keys, valid, seg_of_contig, precision,
                              unroll=unroll)

    ll, grads = jax.value_and_grad(total_ll, argnums=(0, 1, 2))(pi, T, E)
    return ll, pi * grads[0], T * grads[1], E * grads[2]


# ---------------------------------------------------------------------------
# Direct (AD-free) E-step: two-pass sequence-parallel Baum-Welch
#
# ``estep_windows`` obtains the statistics as gradients of the forward
# log-likelihood — correct, but the generic scan backward carries (M, S, M)
# cotangents and recomputes forward blocks under remat.  The statistics
# have a classical direct form (Baum-Welch xi/gamma
# accumulation, reference src/hmm.cpp:97-153) that only needs (S, M)
# alpha/beta state per lockstep segment:
#
#   pass 1   segment operators (unchanged) -> boundary alphas / betas per
#            segment via tiny contig-level scans over the (S, M, M) ops;
#   pass 2a  lockstep ascending alpha recursion, storing normalized
#            per-window alphas (L, S, M) in the carry dtype;
#   pass 2b  lockstep descending beta recursion reading the stored alphas,
#            accumulating xisum (M, M) and per-key posterior mass
#            (n_keys, M) in f64 scan carries via per-step matmuls;
#   finally  the O(S + C) transitions that cross segment/contig boundaries,
#            vectorized outside the scans.
#
# Per-window normalizers are local (Z = alpha . beta per window), so no
# global likelihood constant is threaded through — scale factors cancel
# exactly.  Device-memory traffic drops ~4x vs the AD backward;
# accumulation is f64 (better than the f32 cotangent accumulators of the
# AD path).
# ---------------------------------------------------------------------------


def contig_boundaries(pi, ops, logs, seg_of_contig, seg_has):
    """Total loglik + per-segment boundary vectors from segment operators.

    Forward direction mirrors ``contig_scan``; a reverse scan over the
    transposed operators produces the backward vectors.  Returns
    (ll, A_in (S, M), Q_end (S, M), cvalid (C,)) where A_in[s] is the
    normalized forward vector at the START of segment s (pi for a contig's
    first segment) and Q_end[s] the normalized backward vector at the END
    of segment s (ones for a contig's last segment)."""
    C, NS = seg_of_contig.shape
    Mdim = ops.shape[-1]
    S = ops.shape[0]
    socn = np.asarray(seg_of_contig)
    pad = socn < 0  # static
    idx = np.maximum(socn, 0)
    tiny = jnp.finfo(ops.dtype).tiny
    eye = jnp.eye(Mdim, dtype=ops.dtype)
    ops_c = jnp.where(pad[:, :, None, None], eye[None, None], ops[idx])
    logs_c = jnp.where(pad, 0.0, logs[idx])
    cvalid = jnp.any(jnp.where(pad, False, seg_has[idx]), axis=1)  # (C,)

    def fstep(carry, x):
        alpha, ll = carry
        Mc, lg = x
        v = jnp.einsum("cij,cj->ci", Mc, alpha)
        c = jnp.sum(v, axis=1)
        dll = (jnp.log(c) + lg).astype(jnp.float64)
        dll = jnp.where(cvalid, dll, 0.0)
        return (v / c[:, None], ll + dll), alpha

    alpha0 = jnp.broadcast_to(pi.astype(ops.dtype), (C, Mdim))
    ops_t = jnp.moveaxis(ops_c, 1, 0)  # (NS, C, M, M)
    (_, llc), a_pre = jax.lax.scan(
        fstep, (alpha0, jnp.zeros(C, jnp.float64)),
        (ops_t, jnp.moveaxis(logs_c, 1, 0)),
    )

    def bstep(q, Mc):
        qn = jnp.einsum("cij,ci->cj", Mc, q)
        qn = qn / jnp.maximum(jnp.max(qn, axis=1, keepdims=True), tiny)
        return qn, q

    _, q_post = jax.lax.scan(
        bstep, jnp.ones((C, Mdim), ops.dtype), ops_t, reverse=True
    )
    # a_pre[t, c] = forward vector BEFORE segment soc[c, t];
    # q_post[t, c] = backward vector at the END of segment soc[c, t].
    m = ~pad  # static (C, NS)
    rows = socn[m]
    A_in = jnp.zeros((S, Mdim), ops.dtype).at[rows].set(
        jnp.moveaxis(a_pre, 0, 1)[m]
    )
    Q_end = jnp.zeros((S, Mdim), ops.dtype).at[rows].set(
        jnp.moveaxis(q_post, 0, 1)[m]
    )
    return jnp.sum(llc), A_in, Q_end, cvalid


def stats_pass(T, E, keys, valid, A_in, Q_end, e_all=None, precision=None,
               axis_name=None, alpha_remat=None, emit_gamma=False,
               unroll=None, sweep="xla"):
    """Lockstep alpha/beta sweeps accumulating within-segment statistics.

    All per-window state lives in the transposed (M, S) layout so the big
    segment axis is the minor (contiguous) dimension.  ``e_all`` (L, M, S):
    per-window emission stream from ``segment_operators(..., emit_e=True)``
    (any per-window scaling is fine — all normalizers are window-local); if
    None it is rebuilt here via one-hot lookups.  Returns
    (alpha_end (S, M), u_start (S, M), xo (M, M) f64, gsum (n_keys, M)
    f64) where ``xo`` is the raw outer-product accumulator (multiply
    elementwise by T to get the xisum contribution) and ``u_start[s] =
    e_first ⊙ beta_first`` feeds the boundary transitions.  With
    ``axis_name``, xo/gsum are psum'd across that mesh axis (for
    shard_map over the segment axis).

    ``alpha_remat`` (int block size dividing L, or None): instead of
    materializing the full (L, M, S) alpha stream, store only one (M, S)
    snapshot per block and recompute each block's alphas on the fly during
    the backward sweep — O(L/B + B) state instead of O(L), at the cost of
    one extra forward sweep (the memory lever the reference gets from its
    compressed-row float32 alpha_hat, src/hmm.cpp:59).

    ``emit_gamma``: also return the per-window posterior stream (L, M, S)
    in the carry dtype (each valid window's gamma sums to 1) — the
    window-resolution decode the posterior command aggregates to rows
    (``decode_gammas_windows``); mutually exclusive with alpha_remat.

    ``sweep``: 'xla' (``lax.scan`` sweeps) or 'pallas' (the kernel of
    ops/pallas_sweeps.py, compiled for a GPU; see ``choose_sweep``)."""
    if precision is None:
        precision = MATMUL_PRECISION
    S, L = keys.shape
    Mdim = T.shape[0]
    n_keys = E.shape[0]
    dt = E.dtype
    tiny = jnp.finfo(dt).tiny
    use_onehot = n_keys <= ONEHOT_MAX_KEYS
    key_iota = jnp.arange(n_keys, dtype=jnp.int32)
    keysT = keys.T  # (L, S)
    validT = valid.T
    vnextT = jnp.concatenate(
        [validT[1:], jnp.zeros((1, S), bool)], axis=0
    )
    cdt = _carry_dtype(precision, jnp.dtype(dt))
    u = _eff_unroll(unroll)

    if sweep == "pallas":
        if e_all is not None or alpha_remat is not None or emit_gamma:
            raise ValueError("the Pallas sweeps serve the one-hot "
                             "configuration only (see choose_sweep)")
        from . import pallas_sweeps as ps

        alpha_end, u_start, xo, gsum = ps.sweeps(
            T, E, keysT, validT, A_in, Q_end, alpha_dtype=cdt,
            precision=precision,
        )
        if axis_name is not None:
            xo = jax.lax.psum(xo, axis_name)
            gsum = jax.lax.psum(gsum, axis_name)
        return alpha_end.astype(dt), u_start.astype(dt), xo, gsum

    def asc(aT, kv):
        ek, v = kv  # keys row when e_all is None, else the (M, S) e slice
        with jax.default_matmul_precision(precision):
            eT = E[ek].T if e_all is None else ek.astype(dt)
            anew = eT * (T.T @ aT)  # anew[i,s] = e[i,s] sum_j T[j,i] a[j,s]
        anew = anew / jnp.maximum(
            jnp.max(anew, axis=0, keepdims=True), tiny
        )
        aT = jnp.where(v[None, :], anew, aT)
        return aT, aT.astype(cdt)

    def asc_nosave(aT, kv):
        aT, _ = asc(aT, kv)
        return aT, None

    def dsc(carry, xs):
        qT, uT, xo, gsum = carry
        aT, e_l, k, v, vn = xs
        aT = aT.astype(dt)
        with jax.default_matmul_precision(precision):
            eT = E[k].T if e_l is None else e_l.astype(dt)
            tv = T @ uT  # tv[j,s] = sum_i T[j,i] u[i,s]
        qun = jnp.where(vn[None, :], tv, qT)
        Z = jnp.maximum(jnp.sum(aT * qun, axis=0), tiny)  # (S,)
        gamma = (aT * qun / Z[None, :]) * v[None, :]
        ascale = (aT / Z[None, :]) * (v & vn)[None, :]
        with jax.default_matmul_precision(precision):
            if use_onehot:
                # f32 one-hot: keeps the per-key masses exactly conservative
                # (a bf16 gamma operand costs ~4e-5 total-mass drift).
                ohT = (key_iota[:, None] == k[None, :]).astype(dt)
                g_k = jax.lax.dot_general(
                    gamma, ohT, (((1,), (1,)), ((), ()))
                )  # (M, n_keys)
            else:
                g_k = jnp.zeros((n_keys, Mdim), dt).at[k].add(gamma.T).T
            xi_c = jax.lax.dot_general(
                ascale, uT, (((1,), (1,)), ((), ()))
            )  # (M_j, M_i), T ⊙ applied at the end
        gsum = gsum + g_k.astype(jnp.float64)
        xo = xo + xi_c.astype(jnp.float64)
        qn = qun / jnp.maximum(jnp.max(qun, axis=0, keepdims=True), tiny)
        qT = jnp.where(v[None, :], qn, qT)
        uT = jnp.where(v[None, :], eT * qT, uT)
        # gamma stream stays in the compute dtype: a bf16 stream rounds
        # each window's posterior at ~4e-3 — visible in decoded row masses
        return (qT, uT, xo, gsum), (gamma if emit_gamma else None)

    def dsc_noe(carry, xs):
        a_l, k, v, vn = xs
        return dsc(carry, (a_l, None, k, v, vn))

    init = (
        Q_end.T.astype(dt),
        jnp.zeros((Mdim, S), dt),
        jnp.zeros((Mdim, Mdim), jnp.float64),
        jnp.zeros((Mdim, n_keys), jnp.float64),
    )

    ekT = keysT if e_all is None else e_all

    if alpha_remat is None:
        alpha_end_T, alphas = jax.lax.scan(
            asc, A_in.T.astype(dt), (ekT, validT), unroll=u,
        )
        if e_all is None:
            (_, u_start_T, xo, gsum), gam = jax.lax.scan(
                dsc_noe, init, (alphas, keysT, validT, vnextT),
                reverse=True, unroll=u,
            )
        else:
            (_, u_start_T, xo, gsum), gam = jax.lax.scan(
                dsc, init, (alphas, e_all, keysT, validT, vnextT),
                reverse=True, unroll=u,
            )
    else:
        assert not emit_gamma, "emit_gamma requires alpha_remat=None"
        B = int(alpha_remat)
        assert L % B == 0, (L, B)
        nblk = L // B
        ek_b = ekT.reshape(nblk, B, *ekT.shape[1:])
        keys_b = keysT.reshape(nblk, B, S)
        valid_b = validT.reshape(nblk, B, S)
        vnext_b = vnextT.reshape(nblk, B, S)

        def asc_block(aT, xs_blk):
            aT2, _ = jax.lax.scan(asc_nosave, aT, xs_blk, unroll=u)
            return aT2, aT.astype(cdt)  # emit the alpha BEFORE this block

        alpha_end_T, snaps = jax.lax.scan(
            asc_block, A_in.T.astype(dt), (ek_b, valid_b)
        )

        def dsc_block(carry, xs_blk):
            snap, ekb, kb, vb, vnb = xs_blk
            # recompute this block's per-window alphas from the snapshot
            _, alphas_blk = jax.lax.scan(
                asc, snap.astype(dt), (ekb, vb), unroll=UNROLL
            )
            if e_all is None:
                carry, _ = jax.lax.scan(
                    dsc_noe, carry, (alphas_blk, kb, vb, vnb),
                    reverse=True, unroll=u,
                )
            else:
                carry, _ = jax.lax.scan(
                    dsc, carry, (alphas_blk, ekb, kb, vb, vnb),
                    reverse=True, unroll=u,
                )
            return carry, None

        (_, u_start_T, xo, gsum), _ = jax.lax.scan(
            dsc_block, init, (snaps, ek_b, keys_b, valid_b, vnext_b),
            reverse=True,
        )

    if axis_name is not None:
        xo = jax.lax.psum(xo, axis_name)
        gsum = jax.lax.psum(gsum, axis_name)
    if emit_gamma:
        return alpha_end_T.T, u_start_T.T, xo, gsum.T, gam
    return alpha_end_T.T, u_start_T.T, xo, gsum.T


def boundary_stats(pi, T, alpha_end, u_start, xo, seg_of_contig, cvalid):
    """Transitions crossing segment boundaries + each contig's initial
    transition out of pi.  Returns (xo with boundary outer products added,
    pi_stat (M,))."""
    socn = np.asarray(seg_of_contig)
    dt = alpha_end.dtype
    tiny = jnp.finfo(dt).tiny
    a, b = socn[:, :-1], socn[:, 1:]
    m = (a >= 0) & (b >= 0)  # static adjacency
    if m.any():
        ae = alpha_end[a[m]]
        us = u_start[b[m]]
        tv = us @ T.T
        Z = jnp.maximum(jnp.sum(ae * tv, axis=1), tiny)
        xo = xo + ((ae / Z[:, None]).T @ us).astype(xo.dtype)
    first = socn[:, 0]
    has_first = jnp.asarray(first >= 0)
    uf = u_start[np.maximum(first, 0)]
    tvc = uf @ T.T
    piB = jnp.broadcast_to(pi.astype(dt), uf.shape)
    Zc = jnp.maximum(jnp.sum(piB * tvc, axis=1), tiny)
    w = (has_first & cvalid).astype(dt)[:, None]
    scale = piB / Zc[:, None] * w
    pi_stat = jnp.sum(scale * tvc, axis=0)
    xo = xo + (scale.T @ uf).astype(xo.dtype)
    return xo, pi_stat


def estep_direct(pi, T, E, keys, valid, seg_of_contig, precision=None,
                 e_stream=None, alpha_remat=None, unroll=None, sweep="xla"):
    """Direct Baum-Welch E-step: same contract as ``estep_windows``
    (ll, pi-stat, xisum, gamma_sums), computed without autodiff.

    ``e_stream``: materialize the (L, M, S) emission stream in pass 1 for
    the sweeps to read.  Default (None) = only when the key table is too
    large for the one-hot rebuild (> ONEHOT_MAX_KEYS): the f32 stream's
    write and read cost more device-memory traffic than the one-hot
    compute they save.  ``alpha_remat`` trades the (L, M, S) alpha stream
    for per-block recompute (see stats_pass).  The manager's device-memory
    budget gate selects both; ``sweep`` picks the statistic-sweep
    implementation (``choose_sweep``)."""
    if precision is None:
        precision = MATMUL_PRECISION
    if e_stream is None:
        e_stream = E.shape[0] > ONEHOT_MAX_KEYS
    if e_stream:
        ops, logs, e_all = segment_operators(
            T, E, keys, valid, precision, emit_e=True, unroll=unroll
        )
    else:
        ops, logs = segment_operators(
            T, E, keys, valid, precision, unroll=unroll
        )
        e_all = None
    seg_has = jnp.any(valid, axis=1)
    ll, A_in, Q_end, cvalid = contig_boundaries(
        pi, ops, logs, seg_of_contig, seg_has
    )
    alpha_end, u_start, xo, gsum = stats_pass(
        T, E, keys, valid, A_in, Q_end, e_all, precision,
        alpha_remat=alpha_remat, unroll=unroll, sweep=sweep,
    )
    xo, pi_stat = boundary_stats(
        pi, T, alpha_end, u_start, xo, seg_of_contig, cvalid
    )
    return ll, pi_stat, xo * T.astype(xo.dtype), gsum


def decode_gammas_windows(pi, T, E, keys, valid, seg_of_contig, row_ends,
                          precision=None, unroll=None):
    """Row-resolution posterior masses THROUGH the window kernel.

    The backward statistic sweep already computes each window's normalized
    posterior (M, S); this emits that stream and aggregates windows ->
    compressed rows as a PREFIX-SUM DIFFERENCE: the segment-major flat
    order is genomic order (pack_windows assigns segment ids sequentially
    per contig, padding only at contig tails where gamma is exactly zero),
    so each row's mass is C[end_r] - C[end_{r-1}] of one cumulative sum,
    which stays a streaming pass where a segment-sum would scatter.  The
    accumulation is
    f64: a 55M-window f32 prefix reaches ~5e7, burying O(1) row masses in
    rounding.  This is the production posterior decode whenever the E-step
    itself runs on windows and the (L, M, S) gamma stream fits device
    memory; the
    row-level ``ops/hmm.py:decode_gammas`` covers the rest.  Reference
    analogue: gammas materialized inside the E-step,
    src/hmm.cpp:48-49,147-148.

    row_ends: (n_rows,) int32 flat (segment-major) index of each row's
    LAST window, strictly increasing (pack_window_row_ends).  Returns
    (ll, gammas (n_rows, M) f32): each row's gamma sums to its span in
    windows.

    Default precision is 'tensorfloat32', NOT the E-step's 'default': a
    bf16 alpha stream would round each user-facing per-row posterior;
    tf32 keeps exact-f32 storage (see CARRY); the decode runs once, so the
    extra kernel cost is immaterial.
    """
    if precision is None:
        precision = "tensorfloat32"
    ops, logs = segment_operators(T, E, keys, valid, precision,
                                  unroll=unroll)
    seg_has = jnp.any(valid, axis=1)
    ll, A_in, Q_end, cvalid = contig_boundaries(
        pi, ops, logs, seg_of_contig, seg_has
    )
    _, _, _, _, gam = stats_pass(
        T, E, keys, valid, A_in, Q_end, None, precision, emit_gamma=True,
        unroll=unroll,
    )  # (L, M, S)
    Mdim = T.shape[0]
    flat = jnp.transpose(gam, (2, 0, 1)).reshape(-1, Mdim)
    # two-level prefix sum: f32 within blocks (prefix <= B, exact enough),
    # f64 only across the tiny block-total stream (a flat f64 cumsum would
    # double the stream's traffic)
    B = 1024
    while flat.shape[0] % B:
        B //= 2
    nb = flat.shape[0] // B
    within = jnp.cumsum(flat.reshape(nb, B, Mdim), axis=1)  # f32
    btot = within[:, -1, :].astype(jnp.float64)
    bbase = jnp.cumsum(btot, axis=0) - btot  # exclusive block prefixes
    blk, off = row_ends // B, row_ends % B
    picked = jnp.take(bbase, blk, axis=0) + jnp.take(
        within.reshape(-1, Mdim), blk * B + off, axis=0
    ).astype(jnp.float64)
    g = jnp.diff(picked, axis=0, prepend=jnp.zeros((1, Mdim), jnp.float64))
    return ll, jnp.maximum(g, 0.0).astype(jnp.float32)


def viterbi_windows(pi, T, E, keys, valid, seg_of_contig, row_ends,
                    block=None):
    """MAP (Viterbi) decode through the window kernel.

    Two-level max-plus analogue of the decode: (A) a lockstep sweep builds
    per-segment max-plus transfer operators W[i, s, k] (best path score
    entry-k -> state-i), carries normalized per segment (a uniform offset
    never changes argmaxes); (B) tiny per-contig forward/backtrace scans
    over the segment operators pin the optimal state at every segment
    boundary; (C) each segment then recovers its interior path
    independently — a second lockstep sweep from the known entry state
    storing per-window backpointers, and a lockstep reverse backtrace.
    Sequential depth is O(L + NS), not O(total windows); everything is
    batched over segments like the statistic sweeps.  Scores are f32 with
    per-window max-normalization, so state-ranking differences stay O(1)
    (the row-level CPU decoder needs f64 because it accumulates absolute
    scores ~ -1e5 in one scalar).  The reference has no MAP decoder.

    Returns (n_rows,) int32: the MAP state at each compressed row's END
    (``row_ends`` as in decode_gammas_windows).
    """
    Wops = viterbi_segment_ops(T, E, keys, valid)
    seg_entry, seg_exit = viterbi_boundary_states(pi, Wops, seg_of_contig)
    path = viterbi_segment_paths(
        T, E, keys, valid, seg_entry, seg_exit, block=block
    )
    flat = path.T.reshape(-1)  # segment-major = genomic order
    return jnp.take(flat, row_ends).astype(jnp.int32)


def _mp_neg(dt):
    return jnp.asarray(-1e30, dt)


def viterbi_segment_ops(T, E, keys, valid):
    """Phase A: per-segment max-plus transfer operators (S, i, k) — best
    path score from entry state k to state i; per-segment normalized (a
    uniform offset never changes any argmax downstream)."""
    S, L = keys.shape
    Mdim = T.shape[0]
    dt = E.dtype
    logT_t = jnp.log(T).T.astype(dt)  # [i, j] = log T[j, i]
    logE = jnp.log(E).astype(dt)
    eyemp = jnp.where(jnp.eye(Mdim, dtype=bool), 0.0, _mp_neg(dt)).astype(dt)

    def step(W, kv):
        # W (M_i, S, M_k); scores[j, i, s, k] = logT[j, i] + W[j, s, k]
        k, v = kv
        le = logE[k].T  # (M, S)
        sc = logT_t.T[:, :, None, None] + W[:, None, :, :]  # (j, i, s, k)
        W2 = jnp.max(sc, axis=0) + le[:, :, None]
        W2 = W2 - jnp.max(W2, axis=(0, 2), keepdims=True)
        W = jnp.where(v[None, :, None], W2, W)
        return W, None

    W0 = jnp.broadcast_to(eyemp[:, None, :], (Mdim, S, Mdim))
    W, _ = jax.lax.scan(
        step, W0, (keys.T, valid.T), unroll=min(UNROLL, 4)
    )
    return jnp.transpose(W, (1, 0, 2))  # (S, i, k)


def viterbi_boundary_states(pi, Wops, seg_of_contig):
    """Phase B: MAP state at every segment boundary via tiny per-contig
    max-plus scans over the segment operators.  Returns (seg_entry (S,),
    seg_exit (S,)) int32 — the optimal state entering/leaving each
    segment."""
    socn = np.asarray(seg_of_contig)
    C, NS = socn.shape
    S, Mdim, _ = Wops.shape
    dt = Wops.dtype
    eyemp = jnp.where(jnp.eye(Mdim, dtype=bool), 0.0, _mp_neg(dt)).astype(dt)
    pad = socn < 0
    idx = np.maximum(socn, 0)
    ops_c = jnp.where(pad[:, :, None, None], eyemp[None, None], Wops[idx])
    ops_t = jnp.moveaxis(ops_c, 1, 0)  # (NS, C, i, k)

    def fstep(Vc, Wc):
        sc = Wc + Vc[:, None, :]  # (C, i, k)
        V2 = jnp.max(sc, axis=2)
        bp = jnp.argmax(sc, axis=2).astype(jnp.int32)  # entry given exit
        V2 = V2 - jnp.max(V2, axis=1, keepdims=True)
        return V2, bp

    # zero-probability initial states must carry the max-plus 'impossible'
    # sentinel, not log(tiny) ~ -87 — per-segment operator spreads exceed
    # that, which would let a MAP path start in a pi == 0 state
    logpi = jnp.where(pi > 0, jnp.log(jnp.maximum(pi, 1e-300)), _mp_neg(dt))
    V0 = jnp.broadcast_to(logpi.astype(dt), (C, Mdim))
    Vend, bps = jax.lax.scan(fstep, V0, ops_t)  # bps (NS, C, M)
    exit_last = jnp.argmax(Vend, axis=1).astype(jnp.int32)  # (C,)

    def btrace(state, bp):
        prev = jnp.take_along_axis(bp, state[:, None], axis=1)[:, 0]
        return prev, state  # emit the EXIT state of this segment

    _, exit_states = jax.lax.scan(btrace, exit_last, bps, reverse=True)
    # entry of segment t = exit of t-1; first segment's entry from bps[0]
    entry_states = jnp.concatenate(
        [
            jnp.take_along_axis(
                bps[0], exit_states[0][:, None], axis=1
            ).T,
            exit_states[:-1],
        ],
        axis=0,
    )  # (NS, C)
    m = ~pad
    rows = socn[m]
    seg_entry = jnp.zeros((S,), jnp.int32).at[rows].set(
        jnp.moveaxis(entry_states, 0, 1)[m]
    )
    seg_exit = jnp.zeros((S,), jnp.int32).at[rows].set(
        jnp.moveaxis(exit_states, 0, 1)[m]
    )
    return seg_entry, seg_exit


def viterbi_segment_paths(T, E, keys, valid, seg_entry, seg_exit,
                          block=None):
    """Phase C: interior MAP paths per segment, given boundary states —
    a forward lockstep sweep storing (L, M, S) int8 backpointers, then a
    lockstep reverse backtrace.  Returns path (L, S) int32: the MAP state
    after each window (padding windows repeat the adjacent state).

    With ``block`` set (a divisor of L), the backpointer stream is never
    materialized whole: the forward sweep stores only (L/block, M, S) V
    snapshots at block entries, and the backtrace recomputes each block's
    (block, M, S) backpointers from its snapshot just before consuming
    them — the Viterbi analogue of the E-step's alpha remat, O(sqrt L)
    memory at block ~ sqrt(L) for one extra forward sweep of compute (the
    over-budget MAP decode used to fall back to the row-level CPU
    path)."""
    S, L = keys.shape
    Mdim = T.shape[0]
    dt = E.dtype
    logT_t = jnp.log(T).T.astype(dt)
    logE = jnp.log(E).astype(dt)

    def step(V, kv):
        k, v = kv
        le = logE[k].T  # (M, S)
        sc = logT_t.T[:, :, None] + V[:, None, :]  # (j, i, s)
        V2 = jnp.max(sc, axis=0) + le
        bp = jnp.argmax(sc, axis=0).astype(jnp.int8)  # (i, s)
        V2 = V2 - jnp.max(V2, axis=0, keepdims=True)
        ident = jnp.broadcast_to(
            jnp.arange(Mdim, dtype=jnp.int8)[:, None], bp.shape
        )
        V = jnp.where(v[None, :], V2, V)
        bp = jnp.where(v[None, :], bp, ident)
        return V, bp

    def back(state, bp):
        nxt = jnp.take_along_axis(
            bp, state[None, :].astype(jnp.int32), axis=0
        )[0].astype(jnp.int32)
        return nxt, state  # emit state AFTER this window

    Vin = jnp.where(
        jnp.arange(Mdim)[:, None] == seg_entry[None, :], 0.0, _mp_neg(dt)
    ).astype(dt)

    if block is None:
        _, bp_all = jax.lax.scan(
            step, Vin, (keys.T, valid.T), unroll=min(UNROLL, 4)
        )  # (L, M, S) int8
        _, path = jax.lax.scan(back, seg_exit, bp_all, reverse=True)
        return path

    assert L % block == 0, (L, block)
    nb = L // block
    keys_b = keys.T.reshape(nb, block, S)
    valid_b = valid.T.reshape(nb, block, S)

    def fwd_block(V, xs):
        Vout, _ = jax.lax.scan(
            lambda c, kv: (step(c, kv)[0], None), V, xs,
            unroll=min(UNROLL, 4),
        )
        return Vout, V  # emit the V ENTERING this block

    _, Vsnap = jax.lax.scan(fwd_block, Vin, (keys_b, valid_b))  # (nb, M, S)

    def bwd_block(state, xs):
        Vb, kb, vb = xs
        _, bp_blk = jax.lax.scan(
            step, Vb, (kb, vb), unroll=min(UNROLL, 4)
        )  # (block, M, S) int8 — only ONE block live at a time
        nxt, path_blk = jax.lax.scan(back, state, bp_blk, reverse=True)
        return nxt, path_blk

    _, path = jax.lax.scan(
        bwd_block, seg_exit, (Vsnap, keys_b, valid_b), reverse=True
    )  # (nb, block, S), stacked in original block order
    return path.reshape(L, S)


def pack_window_row_ids(spans_list, L, seg_of_contig):
    """(S, L) global compressed-row index per window, matching the
    segmentation ``pack_windows`` produced (same L, same segment order).
    ``spans_list``: one int array of row spans per contig.  Padding
    windows get the id of the row they follow (harmless: their gamma is
    exactly zero).  Returns (row_ids, n_rows_total).  Used by the
    mesh decode (per-shard segment-sum)."""
    socn = np.asarray(seg_of_contig)
    S = int(socn.max()) + 1
    rid = np.zeros((S, L), dtype=np.int32)
    off = 0
    for c, spans in enumerate(spans_list):
        spans = np.asarray(spans, dtype=np.int64)
        ids = np.repeat(
            np.arange(off, off + len(spans), dtype=np.int32), spans
        )
        for j, seg in enumerate(socn[c]):
            if seg < 0:
                break
            chunk = ids[j * L : (j + 1) * L]
            rid[seg, : len(chunk)] = chunk
            if len(chunk) < L:
                rid[seg, len(chunk):] = chunk[-1] if len(chunk) else off
        off += len(spans)
    return rid, off


def pack_window_row_ends(spans_list, L, seg_of_contig):
    """(n_rows,) int32 flat segment-major index of each row's LAST window,
    strictly increasing — the gather points of the prefix-sum decode
    (``decode_gammas_windows``).  Segment ids are assigned sequentially
    per contig by pack_windows, so contig c's windows occupy the flat
    range [first_seg_c * L, ...] with padding only at the contig's tail."""
    socn = np.asarray(seg_of_contig)
    ends = []
    for c, spans in enumerate(spans_list):
        base = int(socn[c, 0]) * L
        within = np.cumsum(np.asarray(spans, dtype=np.int64)) - 1
        ends.append(base + within)
    out = np.concatenate(ends)
    assert out[-1] < np.iinfo(np.int32).max
    assert np.all(np.diff(out) > 0)
    return out.astype(np.int32)


def remat_block_size(L):
    """Alpha-remat block size: the divisor of L nearest sqrt(L) that is a
    multiple of RESCALE_EVERY (L is always padded to one).  Balances the
    snapshot stream (L/B) against the per-block recompute scratch (B)."""
    target = max(RESCALE_EVERY, int(np.sqrt(L)))
    best = RESCALE_EVERY
    for b in range(RESCALE_EVERY, L + 1, RESCALE_EVERY):
        if L % b == 0 and abs(b - target) < abs(best - target):
            best = b
    return best


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------

def rows_to_key_ids(obs, key_id):
    """Vectorized observation-row -> key-id mapping: dict lookups only on
    the (few hundred) distinct rows instead of every row (a Python loop
    over ~15M rows is minutes of host time at raw C3 scale)."""
    uniq, inv = np.unique(obs, axis=0, return_inverse=True)
    lut = np.array([key_id[tuple(r)] for r in uniq], dtype=np.int32)
    return lut[inv]


def decompress_to_windows(data_list, key_id):
    "Per-contig unit-window key-id streams from span-compressed rows."
    win = []
    for d in data_list:
        s = d[:, 0].astype(np.int64)
        k = rows_to_key_ids(np.asarray(d)[:, 1:], key_id)
        win.append(np.repeat(k, s))
    return win


def window_segment_length(W, seg_target=8192, min_seg_len=64,
                          max_seg_len=16384):
    """Segment length L for a total of W windows (see pack_windows).

    Factored out so multi-host packing (parallel/hostlocal.py) can compute
    the SAME L on every process from the global window count."""
    L = int(2 ** np.ceil(np.log2(max(W / seg_target, 1.0))))
    L = int(np.clip(L, min_seg_len, max_seg_len))
    return -(-L // RESCALE_EVERY) * RESCALE_EVERY


def cut_segments(win, L):
    """Cut per-contig window streams into length-<=L pieces.

    Returns (segs, seg_ids): the flat segment list and, per contig, the
    indices of its segments in stream order."""
    segs = []
    seg_ids = []
    for w in win:
        ids = []
        for off in range(0, len(w), L):
            ids.append(len(segs))
            segs.append(w[off : off + L])
        seg_ids.append(ids)
    return segs, seg_ids


def pack_windows(data_list, key_id, pad_key=0, seg_target=8192,
                 min_seg_len=64, max_seg_len=16384):
    """Decompress span-compressed contigs to unit windows and cut into
    fixed-length segments.

    Returns (keys (S, L) int32, valid (S, L) bool, seg_of_contig (C, NS)).

    ``seg_target`` ~ the target segment count: more, shorter segments
    mean fewer sequential scan steps (L) across more lockstep lanes (S).
    Per-step scan overhead dominates at long L, per-segment boundary
    overhead at short L; the H100 optimum is not measured yet (ROADMAP
    A4).
    """
    win = decompress_to_windows(data_list, key_id)
    W = sum(len(w) for w in win)
    L = window_segment_length(W, seg_target, min_seg_len, max_seg_len)
    segs, seg_ids = cut_segments(win, L)
    S = len(segs)
    keys = np.full((S, L), pad_key, dtype=np.int32)
    valid = np.zeros((S, L), dtype=bool)
    for i, seg in enumerate(segs):
        keys[i, : len(seg)] = seg
        valid[i, : len(seg)] = True
    NS = max(len(i) for i in seg_ids)
    seg_of_contig = np.full((len(win), NS), -1, dtype=np.int64)
    for c, ids in enumerate(seg_ids):
        seg_of_contig[c, : len(ids)] = ids
    return keys, valid, seg_of_contig
