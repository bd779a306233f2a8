"""Pallas kernel (Triton route) for the statistic sweeps of the direct E-step.

``window_kernel.estep_direct`` spends its post-operator time in two lockstep
sweeps over the L windows of every segment: an ascending alpha recursion
that stores the per-window alpha stream, and a descending beta recursion
that accumulates the xisum outer products and the per-key posterior
masses.  Under XLA each window is one ``lax.scan`` iteration made of
several small fusions and dots, so a sweep costs L times a handful of
kernel launches whatever the segment count.

Here segments are independent, so each program owns a tile of
``BLOCK_SEGMENTS`` segments and walks all L windows inside one launch: the (M, BS)
carries stay in registers, T and E are read once (E by a gather of the
tile's keys), and only the alpha stream goes through device memory.  Each
program keeps its xo / gsum partial sums in f64 and the caller adds the
programs' partials.

Numerics follow ``stats_pass`` step for step (the same per-window
normalization, floors and masks).  Under ``precision='default'`` the
recursion dots run in TF32, as XLA's do on the card; every other rung runs
exact-f32 dots.  The per-key mass dot always takes exact-f32 operands (the
one-hot is exact, and a rounded gamma would break mass conservation).

Hidden states are padded to a power of two of at least 16 (Triton's
smallest dot tile): padded states start at zero and have zero transition
mass, so they stay zero through both recursions and are sliced off.

Scope (``supported``): the one-hot emission configuration of stats_pass
(no emission stream, no alpha-remat, no gamma emission), M <= 32 (the
widths measured on the card) and at most ``MAX_KEYS`` emission keys (the
per-program (M, keys) f64 mass accumulator lives in registers).
Everything else stays on the XLA sweeps; ``window_kernel.choose_sweep``
makes the choice.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_KEYS = 128
MAX_STATES = 32
# Segments per program.  On an H100 at C3 widths 16 is the fastest tile;
# 32 and 64 spill registers (up to ~25x slower at M = 16, 2 warps).
BLOCK_SEGMENTS = 16
_KEY_MASK = np.int32((1 << 16) - 1)
_V_BIT = np.int32(1 << 16)
_VN_BIT = np.int32(1 << 17)


def supported(S, L, M, n_keys):
    "Static-shape eligibility of the kernel (see module docstring)."
    return 2 <= M <= MAX_STATES and 0 < n_keys <= MAX_KEYS and S > 0 and L > 0


def padded_states(M):
    "States the kernel runs: a power of two of at least 16."
    return max(16, int(pl.next_power_of_2(M)))


def num_warps(Mp, nk):
    """Warps per program for Mp (padded) states and nk (padded) keys.

    The per-program (Mp, nk) f64 mass accumulator dominates the register
    budget: two warps hold it at Mp * nk = 2048 (M = 16, 128 keys), and
    twice as many states need twice the warps — on an H100 two warps at
    M = 32 spill and run ~12x slower, and wider segment tiles spill too
    (see ``BLOCK_SEGMENTS``)."""
    return int(np.clip(Mp * nk // 1024, 2, 8))


def _dot_precision(precision):
    if precision == "default":
        return jax.lax.Precision.DEFAULT  # TF32 on the card
    return jax.lax.Precision.HIGHEST


def _unpack(row):
    "One (BS,) int32 stream row -> (key, valid, next-window valid)."
    return row & _KEY_MASK, (row & _V_BIT) != 0, (row & _VN_BIT) != 0


def _asc_kernel(enc_ref, tT_ref, eT_ref, a_in_ref, alphas_ref, aend_ref, *,
                n_win, nk, tiny, prec):
    M, BS = a_in_ref.shape
    Tt = tT_ref[...]
    gidx = jax.lax.broadcasted_iota(jnp.int32, (M, BS), 0) * nk

    def body(i, aT):
        k, v, _ = _unpack(enc_ref[i, :])
        eT = eT_ref[gidx + k[None, :]]  # (M, BS) gather of E[k].T
        anew = eT * pl.dot(Tt, aT, precision=prec)
        anew = anew / jnp.maximum(jnp.max(anew, axis=0, keepdims=True), tiny)
        aT = jnp.where(v[None, :], anew, aT)
        alphas_ref[i, :, :] = aT.astype(alphas_ref.dtype)
        return aT

    aT = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_win), body, a_in_ref[...])
    aend_ref[...] = aT


def _dsc_kernel(enc_ref, alphas_ref, t_ref, eT_ref, q_end_ref,
                u_ref, xo_ref, gsum_ref, *, n_win, nk, tiny, prec):
    M, BS = q_end_ref.shape
    T = t_ref[...]
    gidx = jax.lax.broadcasted_iota(jnp.int32, (M, BS), 0) * nk
    kiota = jax.lax.broadcasted_iota(jnp.int32, (BS, nk), 1)

    def body(j, carry):
        qT, uT, xo, gsum = carry
        i = jnp.int32(n_win - 1) - j
        k, v, vn = _unpack(enc_ref[i, :])
        aT = alphas_ref[i, :, :].astype(jnp.float32)
        eT = eT_ref[gidx + k[None, :]]
        tv = pl.dot(T, uT, precision=prec)  # tv[j,s] = sum_i T[j,i] u[i,s]
        qun = jnp.where(vn[None, :], tv, qT)
        Z = jnp.maximum(jnp.sum(aT * qun, axis=0, keepdims=True), tiny)
        gamma = jnp.where(v[None, :], aT * qun / Z, 0.0)
        ascale = jnp.where((v & vn)[None, :], aT / Z, 0.0)
        oh = (k[:, None] == kiota).astype(jnp.float32)  # (BS, nk)
        # f64 running sums: an f32 sum over ~1e4 windows drifts ~1e-4
        g_k = pl.dot(gamma, oh, precision=jax.lax.Precision.HIGHEST)
        gsum = gsum + g_k.astype(jnp.float64)
        xo = xo + pl.dot(ascale, uT, trans_b=True,
                         precision=prec).astype(jnp.float64)
        qn = qun / jnp.maximum(jnp.max(qun, axis=0, keepdims=True), tiny)
        qT = jnp.where(v[None, :], qn, qT)
        uT = jnp.where(v[None, :], eT * qT, uT)
        return qT, uT, xo, gsum

    init = (
        q_end_ref[...],
        jnp.zeros((M, BS), jnp.float32),
        jnp.zeros((M, M), jnp.float64),
        jnp.zeros((M, nk), jnp.float64),
    )
    _, uT, xo, gsum = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(n_win), body, init
    )
    u_ref[...] = uT
    xo_ref[0, :, :] = xo
    gsum_ref[0, :, :] = gsum


def sweeps(T, E, keysT, validT, A_in, Q_end, alpha_dtype=jnp.float32,
           precision="default", interpret=False):
    """Both statistic sweeps as two Pallas launches.

    Inputs follow ``window_kernel.stats_pass`` in its transposed layout:
    ``keysT``/``validT`` (L, S), ``A_in``/``Q_end`` (S, M), T (M, M),
    E (n_keys, M).  Returns (alpha_end (S, M) f32, u_start (S, M) f32,
    xo (M, M) f64, gsum (n_keys, M) f64): the contract of stats_pass.
    ``alpha_dtype`` is the storage dtype of the alpha stream (the carry
    dtype stats_pass would use)."""
    L, S = keysT.shape
    m_in = T.shape[0]
    M = padded_states(m_in)
    n_keys = E.shape[0]
    BS = BLOCK_SEGMENTS
    Sp = -(-S // BS) * BS
    n_prog = Sp // BS
    nk = max(16, int(pl.next_power_of_2(n_keys)))
    tiny = float(np.finfo(np.float32).tiny)
    prec = _dot_precision(precision)

    def pad_s(x, axis):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, Sp - S)
        return jnp.pad(x, widths)

    # keys, valid and next-window valid travel as one int32 stream; padded
    # segments are invalid everywhere, so every carry passes through them
    valid_i = pad_s(jnp.asarray(validT).astype(jnp.int32), 1)
    vnext_i = jnp.concatenate(
        [valid_i[1:], jnp.zeros((1, Sp), jnp.int32)], axis=0
    )
    enc = (pad_s(jnp.asarray(keysT, jnp.int32), 1)
           | (valid_i << 16) | (vnext_i << 17))
    dm = M - m_in
    Tf = jnp.pad(jnp.asarray(T, jnp.float32), ((0, dm), (0, dm)))
    eT_flat = jnp.pad(
        jnp.asarray(E, jnp.float32).T, ((0, dm), (0, nk - n_keys))
    ).reshape(-1)  # [m * nk + key]
    A_inT = pad_s(jnp.pad(jnp.asarray(A_in, jnp.float32).T, ((0, dm), (0, 0))), 1)
    Q_endT = pad_s(jnp.pad(jnp.asarray(Q_end, jnp.float32).T, ((0, dm), (0, 0))), 1)

    whole = lambda shape: pl.BlockSpec(shape, lambda p: (0,) * len(shape))
    enc_spec = pl.BlockSpec((L, BS), lambda p: (0, p))
    carry_spec = pl.BlockSpec((M, BS), lambda p: (0, p))
    alphas_spec = pl.BlockSpec((L, M, BS), lambda p: (0, 0, p))
    params = plgpu.CompilerParams(
        num_warps=num_warps(M, nk), num_stages=1
    )
    kw = dict(n_win=L, nk=nk, tiny=tiny, prec=prec)

    alphas, aend = pl.pallas_call(
        partial(_asc_kernel, **kw),
        grid=(n_prog,),
        in_specs=[enc_spec, whole((M, M)), whole((M * nk,)), carry_spec],
        out_specs=(alphas_spec, carry_spec),
        out_shape=(
            jax.ShapeDtypeStruct((L, M, Sp), alpha_dtype),
            jax.ShapeDtypeStruct((M, Sp), jnp.float32),
        ),
        compiler_params=params,
        backend="triton",
        interpret=interpret,
        name="stat_sweep_alpha",
    )(enc, Tf.T, eT_flat, A_inT)

    u, xo_p, gsum_p = pl.pallas_call(
        partial(_dsc_kernel, **kw),
        grid=(n_prog,),
        in_specs=[enc_spec, alphas_spec, whole((M, M)), whole((M * nk,)),
                  carry_spec],
        out_specs=(
            carry_spec,
            pl.BlockSpec((1, M, M), lambda p: (p, 0, 0)),
            pl.BlockSpec((1, M, nk), lambda p: (p, 0, 0)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((M, Sp), jnp.float32),
            jax.ShapeDtypeStruct((n_prog, M, M), jnp.float64),
            jax.ShapeDtypeStruct((n_prog, M, nk), jnp.float64),
        ),
        compiler_params=params,
        backend="triton",
        interpret=interpret,
        name="stat_sweep_beta",
    )(enc, alphas, Tf, eT_flat, Q_endT)

    xo = jnp.sum(xo_p, axis=0)[:m_in, :m_in]
    gsum = jnp.sum(gsum_p, axis=0)[:m_in, :n_keys].T
    return aend[:m_in, :S].T, u[:m_in, :S].T, xo, gsum
