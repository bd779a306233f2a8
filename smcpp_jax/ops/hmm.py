"""HMM forward pass and E-step sufficient statistics — the span kernel.

Design (replaces the reference's per-key eigensystems, span_Qs
divided-difference algebra and hand-written backward pass,
src/hmm.cpp + src/transition_bundle.cpp, with a single differentiable
forward program):

* Observations are span-compressed rows (span_l, key_l).  Each row's
  transfer operator A_l = (diag(E[key_l]) @ T^T)^{span_l} is computed by
  **binary exponentiation with per-step rescaling** — a fixed number of
  batched MxM matmuls, perfectly batched over rows (matrix-unit work, no data
  dependence).  Long spans are pre-split at pack time so the exponent depth
  is small (inference/manager.py:_best_max_span).
* Rows are grouped into chunks of G; each chunk's operator product is
  computed by a **tree reduction** (log2 G batched matmul levels).  Chunks
  from all contigs are processed through one ``lax.map`` with a bounded
  batch size, so peak memory is O(batch * G * M^2) regardless of genome
  length.  The only sequential pass is a single scan over chunk products,
  batched across contigs (depth L/G instead of L).
* The log-likelihood is the only forward output.  All E-step sufficient
  statistics fall out of ``jax.grad`` via the exponential-family identities

      xisum      = T  * d logL / d T        (expected transition counts)
      gamma_sums = E  * d logL / d E        (expected per-key state counts)
      gamma0     = pi * d logL / d pi       (posterior at position 0)

  which are exactly the quantities the reference's backward pass accumulates
  (hmm.cpp:97-153).  jax.checkpoint over chunks keeps backward memory at
  O(n_chunks * M^2) + recompute.

Rows with span == 0 are exact no-ops (A = I) and serve as padding — both for
ragged contig lengths and for ragged contig counts under data-parallel
sharding.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _rescale(mat, logs):
    "Normalize by the max-abs entry, tracking log scale.  (..., M, M)"
    m = jnp.max(jnp.abs(mat), axis=(-2, -1), keepdims=True)
    m = jnp.maximum(m, jnp.finfo(mat.dtype).tiny)
    return mat / m, logs + jnp.log(m[..., 0, 0])


def _row_operator(B, span, nbits):
    "(diag(e) T^T)^span by binary exponentiation with rescaling.  B: (M, M)."
    M = B.shape[-1]
    eye = jnp.eye(M, dtype=B.dtype)
    zero = jnp.zeros((), dtype=B.dtype)

    def body(i, st):
        R, logR, Bc, logBc = st
        bit = ((span >> i) & 1) == 1
        Rn = jnp.where(bit, Bc @ R, R)
        logRn = jnp.where(bit, logR + logBc, logR)
        Rn, logRn = _rescale(Rn, logRn)
        Bc2, logBc2 = _rescale(Bc @ Bc, 2.0 * logBc)
        return Rn, logRn, Bc2, logBc2

    R, logR, _, _ = jax.lax.fori_loop(0, nbits, body, (eye, zero, B, zero))
    return R, logR


def _tree_reduce(As, logs):
    """Ordered product As[G-1] @ ... @ As[0] by pairwise tree reduction.

    As: (G, M, M) with G a power of two.  Returns ((M, M), scalar log).
    """
    G, M = As.shape[0], As.shape[-1]
    assert G & (G - 1) == 0, "chunk size must be a power of two"
    while G > 1:
        pair = As.reshape(G // 2, 2, M, M)
        lp = logs.reshape(G // 2, 2)
        As, logs = _rescale(pair[:, 1] @ pair[:, 0], lp[:, 0] + lp[:, 1])
        G //= 2
    return As[0], logs[0]


@partial(jax.checkpoint, static_argnums=(4,), prevent_cse=False)
def _chunk_product(T, E, spans, keys, nbits):
    "Transfer-operator product over one chunk of compressed rows."
    Tt = T.T
    B = E[keys][:, :, None] * Tt[None]  # (G, M, M)
    As, logs = jax.vmap(lambda b, s: _row_operator(b, s, nbits))(B, spans)
    return _tree_reduce(As, logs)


def _batch_size(chunk, M, budget_bytes=1 << 28):
    "How many chunks to process at once (peak ~6 f32 buffers per element)."
    per = chunk * M * M * 4 * 6
    return max(8, budget_bytes // per)


def _all_chunk_products(T, E, spans, keys, nbits, chunk):
    """Chunk-operator products for a whole (C, L) batch of contigs.

    Returns Ms (C, n_chunks, M, M) and logs (C, n_chunks).  Memory-bounded
    via lax.map batching over the flattened chunk axis.
    """
    C, L = spans.shape
    M = T.shape[0]
    n_chunks = L // chunk
    sp = spans.reshape(C * n_chunks, chunk)
    ky = keys.reshape(C * n_chunks, chunk)
    bs = min(_batch_size(chunk, M), C * n_chunks)

    def f(xs):
        return _chunk_product(T, E, xs[0], xs[1], nbits)

    Ms, logs = jax.lax.map(f, (sp, ky), batch_size=bs)
    return (
        Ms.reshape(C, n_chunks, M, M),
        logs.reshape(C, n_chunks),
    )


def _scan_chunks(pi, Ms, logs, cvalid=None):
    """Batched scaled-forward scan over chunk products.  Returns (C,) loglik.

    ``cvalid`` (C,) bool masks out padding contigs (added when the contig
    axis is padded to a mesh-size multiple): their log-likelihood — and
    hence every gradient statistic — is exactly zero, so sharded and
    single-device runs agree."""
    C, n_chunks, M, _ = Ms.shape
    Ms_t = jnp.moveaxis(Ms, 1, 0)  # (n_chunks, C, M, M)
    logs_t = jnp.moveaxis(logs, 1, 0)

    def step(carry, x):
        alpha, ll = carry
        Mc, lg = x
        v = jnp.einsum("cij,cj->ci", Mc, alpha)
        c = jnp.sum(v, axis=1)
        dll = (jnp.log(c) + lg).astype(jnp.float64)
        if cvalid is not None:
            dll = jnp.where(cvalid, dll, 0.0)
        return (v / c[:, None], ll + dll), None

    alpha0 = jnp.broadcast_to(pi.astype(Ms.dtype), (C, M))
    init = (alpha0, jnp.zeros(C, jnp.float64))
    (_, ll), _ = jax.lax.scan(step, init, (Ms_t, logs_t))
    return ll


def loglik(pi, T, E, spans, keys, nbits, chunk):
    "Total log-likelihood over a batch of contigs.  spans/keys: (C, L)."
    Ms, logs = _all_chunk_products(T, E, spans, keys, nbits, chunk)
    cvalid = jnp.any(spans > 0, axis=1)
    return jnp.sum(_scan_chunks(pi, Ms, logs, cvalid))


def forward_loglik(pi, T, E, spans, keys, nbits, chunk):
    "Scaled-forward log-likelihood of one contig (spans/keys: (L,))."
    return loglik(pi, T, E, spans[None], keys[None], nbits, chunk)


def estep(pi, T, E, spans, keys, nbits, chunk):
    """E-step over a batch of contigs: log-likelihood + sufficient statistics.

    spans, keys: (C, L) padded with span == 0 rows.
    Returns (ll, gamma0 (M,), xisum (M, M), gamma_sums (n_keys, M)) where the
    statistics are summed over contigs (the only form the M-step needs;
    reference: HMM::Q, hmm.cpp:155-193).
    """

    def total_ll(pi, T, E):
        return loglik(pi, T, E, spans, keys, nbits, chunk)

    ll, grads = jax.value_and_grad(total_ll, argnums=(0, 1, 2))(pi, T, E)
    gamma0 = pi * grads[0]
    xisum = T * grads[1]
    gamma_sums = E * grads[2]
    return ll, gamma0, xisum, gamma_sums


def _chunk_gammas(T, E, spans, keys, a0, bG, nbits):
    """Per-row span-summed posterior masses for ONE chunk of rows.

    a0: normalized forward vector entering the chunk; bG: normalized
    backward vector leaving it.  Row l's gamma is the gradient of
    log(alpha_{l-1}^T A_l(log e) beta_l) with respect to a per-state log
    scale on the emission vector — binary exponentiation is a
    re-association of the span product, so AD through ``_row_operator``
    yields exactly the per-position posterior sum over the span (the
    quantity the reference's span_Qs divided-difference algebra
    accumulates, src/hmm.cpp:108-128) with no hand-derived algebra.
    Normalization is automatic: each row's gamma sums to its span.
    """
    Tt = T.T
    dt = T.dtype
    tiny = jnp.finfo(dt).tiny
    B = E[keys][:, :, None] * Tt[None]  # (G, M, M)
    As, _ = jax.vmap(lambda b, s: _row_operator(b, s, nbits))(B, spans)

    def fstep(a, A):
        v = A @ a
        v = v / jnp.maximum(jnp.sum(v), tiny)
        return v, a  # emit alpha BEFORE this row

    _, a_pre = jax.lax.scan(fstep, a0, As)

    def bstep(b, A):
        u = A.T @ b
        u = u / jnp.maximum(jnp.max(u), tiny)
        return u, b  # emit beta AFTER this row

    _, b_post = jax.lax.scan(bstep, bG, As, reverse=True)

    def row_gamma(a_before, b_after, e, s):
        def f(log_scale):
            Br = (e * jnp.exp(log_scale))[:, None] * Tt
            A, lg = _row_operator(Br, s, nbits)
            return jnp.log(jnp.maximum(b_after @ (A @ a_before), tiny)) + lg

        return jax.grad(f)(jnp.zeros_like(e))

    return jax.vmap(row_gamma)(a_pre, b_post, E[keys], spans)


def decode_gammas(pi, T, E, spans, keys, nbits, chunk):
    """Row-resolution posterior decode for a padded (C, L) contig batch.

    Two-level direct decode (the batched, parallel replacement for the
    per-contig ``posterior_gammas`` loop): chunk transfer operators via the
    shared tree-reduction machinery, two O(L/chunk)-depth boundary scans,
    then every chunk decodes independently (vmapped via lax.map) from its
    boundary alpha/beta.  Returns (C, L, M); padding rows decode to zeros.
    Matches ``posterior_gammas`` exactly (same mathematical definition).
    """
    C, L = spans.shape
    Mdim = T.shape[0]
    n_chunks = L // chunk
    tiny = jnp.finfo(T.dtype).tiny
    Ms, _ = _all_chunk_products(T, E, spans, keys, nbits, chunk)
    Ms_t = jnp.moveaxis(Ms, 1, 0)  # (n_chunks, C, M, M)

    def fstep(a, Mc):
        v = jnp.einsum("cij,cj->ci", Mc, a)
        v = v / jnp.maximum(jnp.sum(v, axis=1, keepdims=True), tiny)
        return v, a

    alpha0 = jnp.broadcast_to(pi.astype(Ms.dtype), (C, Mdim))
    _, a_pre = jax.lax.scan(fstep, alpha0, Ms_t)

    def bstep(b, Mc):
        u = jnp.einsum("cij,ci->cj", Mc, b)
        u = u / jnp.maximum(jnp.max(u, axis=1, keepdims=True), tiny)
        return u, b

    _, b_post = jax.lax.scan(
        bstep, jnp.ones((C, Mdim), Ms.dtype), Ms_t, reverse=True
    )

    sp = spans.reshape(C * n_chunks, chunk)
    ky = keys.reshape(C * n_chunks, chunk)
    a0 = jnp.moveaxis(a_pre, 0, 1).reshape(C * n_chunks, Mdim)
    bG = jnp.moveaxis(b_post, 0, 1).reshape(C * n_chunks, Mdim)
    # the AD tape holds ~nbits (M, M) residuals per row
    per = chunk * Mdim * Mdim * 4 * (6 + 2 * nbits)
    bs = max(8, min((1 << 28) // per, C * n_chunks))

    g = jax.lax.map(
        lambda xs: _chunk_gammas(T, E, xs[0], xs[1], xs[2], xs[3], nbits),
        (sp, ky, a0, bG),
        batch_size=bs,
    )
    # posterior masses are nonnegative; f32 AD rounding can land ~-1e-8
    return jnp.maximum(g.reshape(C, L, Mdim), 0.0)


def posterior_gammas(pi, T, E, spans, keys, nbits, chunk):
    """Per-row posterior state masses for one contig, summed over each row's
    span: gamma[l, m] = sum over the span of row l of P(state = m | data).

    Obtained as the gradient of logL with respect to a per-row log-scale on
    the emission vector (each position's emission contributes one factor, so
    the derivative counts posterior mass).  Matches the reference's
    save_gamma output up to its per-row normalization (commands/posterior.py
    normalizes columns anyway)."""
    L = spans.shape[0]
    Mdim = pi.shape[0]
    n_chunks = L // chunk

    def ll_fn(logd):
        Escaled = E[keys] * jnp.exp(logd)  # (L, M) per-row emission vectors
        spans_c = spans.reshape(n_chunks, chunk)
        Ec = Escaled.reshape(n_chunks, chunk, Mdim)

        @partial(jax.checkpoint, static_argnums=(3,), prevent_cse=False)
        def chunk_prod(T, Erows, sp, nbits):
            Tt = T.T
            B = Erows[:, :, None] * Tt[None]
            As, logs = jax.vmap(lambda b, s: _row_operator(b, s, nbits))(B, sp)
            return _tree_reduce(As, logs)

        bs = min(_batch_size(chunk, Mdim), n_chunks)
        Ms, logs = jax.lax.map(
            lambda xs: chunk_prod(T, xs[0], xs[1], nbits),
            (Ec, spans_c),
            batch_size=bs,
        )
        ll = _scan_chunks(pi, Ms[None], logs[None])
        return jnp.sum(ll)

    return jax.grad(ll_fn)(jnp.zeros((L, Mdim), dtype=T.dtype))


# ---------------------------------------------------------------------------
# MAP (Viterbi) decoding — max-plus analogue of the forward kernel.
# ---------------------------------------------------------------------------

def _mp_matmul(A, B):
    "Max-plus matrix product: C[i,j] = max_k A[i,k] + B[k,j]."
    return jnp.max(A[:, :, None] + B[None, :, :], axis=1)


def _mp_power(A, s, nbits):
    "Max-plus s-th power by binary exponentiation (s == 0 -> identity)."
    M = A.shape[0]
    ident = jnp.where(jnp.eye(M, dtype=bool), 0.0, -jnp.inf).astype(A.dtype)
    result, base = ident, A

    def body(carry, b):
        result, base = carry
        take = (s >> b) & 1
        result = jnp.where(take > 0, _mp_matmul(result, base), result)
        return (result, _mp_matmul(base, base)), None

    (result, _), _ = jax.lax.scan(
        body, (result, base), jnp.arange(nbits, dtype=s.dtype)
    )
    return result


def viterbi_path(pi, T, E, spans, keys, nbits):
    """Row-resolution MAP (Viterbi) hidden-state path for one contig.

    Max-plus counterpart of the forward kernel: a compressed row of span s
    and key k contributes the max-plus s-th power of
    A[i, j] = log T[i, j] + log E[k, j], and back-pointers are recorded at
    row boundaries, so the returned path is the MAP state at the END of
    each row (within-row switches are collapsed into the row operator —
    the same resolution as the posterior gammas).  Runs in the setup
    precision (float64 on CPU): Viterbi scores reach ~-1e5 and float32
    would misrank close paths.  The reference has no MAP decoder; this
    extends its posterior command (smcpp/commands/posterior.py).

    Returns (L,) int32; padding rows (span 0) repeat the previous state.
    """
    logT = jnp.log(T)
    logE = jnp.log(E)

    def step(V, row):
        s, k = row
        A = logT + logE[k][None, :]  # A[i, j] = log T[i,j] + log E[k, j]
        W = _mp_power(A, s, nbits)
        scores = V[:, None] + W  # (i, j)
        V2 = jnp.max(scores, axis=0)
        bp = jnp.argmax(scores, axis=0).astype(jnp.int32)
        return V2, bp

    V, bps = jax.lax.scan(step, jnp.log(pi), (spans, keys))
    last = jnp.argmax(V).astype(jnp.int32)

    def back(state, bp):
        prev = bp[state]
        return prev, state

    _, path = jax.lax.scan(back, last, bps, reverse=True)
    return path


def viterbi_paths(pi, T, E, spans, keys, nbits):
    """Batched MAP decode over a padded (C, L) contig batch: one jitted
    program instead of a per-contig dispatch loop.  Returns (C, L) int32.

    Padding rows (span 0) contribute identity max-plus operators, so the
    backtrace through them repeats the adjacent real state."""
    return jax.vmap(
        lambda s, k: viterbi_path(pi, T, E, s, k, nbits)
    )(spans, keys)
