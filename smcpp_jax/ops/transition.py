"""SMC' transition matrix over hidden TMRCA intervals.

The 3-state recombination process (0 = linked, 1 = floating lineage,
2 = re-coalesced below) is advanced across the time grid with closed-form
3x3 matrix exponentials (sinh/cosh form, reference src/transition.cpp:112-130)
and prefix products.

Fixed-precision reformulation of the reference's 256-bit MPFR prefix products
(src/transition.cpp:133-169): the below-diagonal entries need *differences*
of the absorbing-state probability P_i(0,2) between consecutive hidden
states.  Rather than differencing nearly-equal prefix products (the reason
the reference needs MPFR), we accumulate the per-piece increments

    P_i(0,2) - P_{i-1}(0,2) = P_{i-1}(0,0) E_i(0,2) + P_{i-1}(0,1) E_i(1,2)

which are sums of nonnegative terms — no cancellation, float64 suffices.
Any residual error below ~1e-15 is swamped by the reference's own 1e-20
floor and beta=1e-5 uniform smoothing.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .. import defaults
from . import ratefunc
from .grid import TimeGrid


def expm_recomb(c_rho, c_eta):
    """Closed-form expm of c_rho*A_rho + c_eta*A_eta (broadcasts over leading
    dims; returns (..., 3, 3)).  Reference: src/transition.cpp:112-130."""
    sq = jnp.sqrt(4.0 * c_eta * c_eta + c_rho * c_rho)
    sq = jnp.maximum(sq, 1e-300)
    # sinh(x)/x is stable for small x via the sq floor; c_rho >= 0 always > 0
    # in practice (rho > 0), but guard anyway.
    s = jnp.sinh(0.5 * sq) / sq
    c = jnp.cosh(0.5 * sq)
    e = jnp.exp(-c_eta - c_rho / 2.0)
    q00 = e * (c + (2.0 * c_eta - c_rho) * s)
    q01 = 2.0 * e * c_rho * s
    q02 = 1.0 - q00 - q01
    q10 = 2.0 * e * c_eta * s
    q11 = e * (c - (2.0 * c_eta - c_rho) * s)
    q12 = 1.0 - q10 - q11
    z = jnp.zeros_like(q00)
    o = jnp.ones_like(q00)
    return jnp.stack(
        [
            jnp.stack([q00, q01, q02], axis=-1),
            jnp.stack([q10, q11, q12], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )


def _piece_expms(ada, rho, grid: TimeGrid):
    """Per-piece 3x3 expm; identity for zero-width pieces; absorbing matrix
    for the terminal piece (exp of an infinite interval)."""
    # xp-generic over grid.dt so traced-width grids (the traced JCSFS's
    # apart dual grid, ops/jcsfs_traced.py) lower through; for static
    # grids everything below constant-folds.
    is_last = np.zeros(grid.K, dtype=bool)
    is_last[-1] = True
    dtj = jnp.asarray(grid.dt)
    zero_piece = jnp.where(jnp.asarray(is_last), False, dtj <= 0.0)
    # The closed form overflows (sinh/cosh of ~1e250) on the terminal piece,
    # which would poison gradients through the select: mask dt first.
    dt = jnp.where(jnp.asarray(is_last), 1.0, dtj)
    c_eta = ada * dt
    c_rho = rho * dt
    E = expm_recomb(c_rho, c_eta)  # (K,3,3)
    # terminal piece: everything is eventually absorbed -> rows (0,0,1)
    absorbing = jnp.array([[0.0, 0.0, 1.0]] * 3, dtype=E.dtype)
    E = jnp.where(is_last[:, None, None], absorbing[None], E)
    ident = jnp.eye(3, dtype=E.dtype)
    return jnp.where(zero_piece[:, None, None], ident[None], E)


def _prefix_products(E):
    """P_i = E_0 @ E_1 @ ... @ E_{i-1} for i = 0..K (left-to-right order,
    P_0 = I).  Returns (K+1, 3, 3)."""

    def step(carry, e):
        new = carry @ e
        return new, new

    _, prods = jax.lax.scan(step, jnp.eye(3, dtype=E.dtype), E)
    return jnp.concatenate([jnp.eye(3, dtype=E.dtype)[None], prods], axis=0)


def transition_matrix(a, rho, grid: TimeGrid):
    """The (M, M) transition kernel Phi between hidden TMRCA intervals.

    Reference: HJTransition (src/transition.cpp:171-253), with the
    mathematically-exact cumulative-rate bookkeeping (the reference has two
    small off-by-one quirks in its piece loops at transition.cpp:210-223 that
    we do not reproduce; differences are far below the beta smoothing).
    """
    M = grid.M
    ada = ratefunc.ada_on_grid(a, grid)
    Rr = ratefunc.cumulative_rate(ada, grid)
    E = _piece_expms(ada, rho, grid)
    P = _prefix_products(E)  # (K+1,3,3)

    H = grid.hs_indices  # (M+1,) static
    R_hs = Rr[H]  # (M+1,); last is huge-finite

    # --- below-diagonal: increments of P(0,2) between hidden states,
    # accumulated as nonnegative per-piece terms.
    inc = P[:-1, 0, 0] * E[:, 0, 2] + P[:-1, 0, 1] * E[:, 1, 2]  # (K,)
    cum = jnp.concatenate([jnp.zeros(1, inc.dtype), jnp.cumsum(inc)])
    expm_diff = cum[H[1:-1]] - cum[H[:-2]]  # (M-1,): k = 1..M-1

    # --- average coalescence times and their enclosing pieces
    act = ratefunc.average_coal_times(a, grid)  # (M,)
    act_safe = jnp.nan_to_num(act, nan=0.0)
    rct_ip = jnp.clip(
        jnp.searchsorted(jnp.asarray(grid.ts), act_safe, side="right") - 1,
        0,
        grid.K - 1,
    )  # (M,) traced index

    # B_j = P[rct_ip] @ expm(partial piece up to rct)  — prob. row 0 -> state 1
    delta = act_safe - jnp.asarray(grid.ts)[rct_ip]
    ada_r = ada[rct_ip]
    Epart = expm_recomb(rho * delta, ada_r * delta)  # (M,3,3)
    B = jnp.einsum("mij,mjk->mik", P[rct_ip], Epart)
    R_rct = Rr[rct_ip] + ada_r * delta
    # survival of the floating state from rct to the top of its interval
    p_float = B[:, 0, 1] * jnp.exp(-(R_hs[1:] - R_rct))  # (M,), row j uses j-1

    # --- coalescence of the floating lineage in a higher interval k > j:
    # p_coal(j,k) = exp(-(R_{hs_{k-1}} - R_{hs_j})) * (-expm1(-(R_{hs_k}-R_{hs_{k-1}})))
    # (the -expm1 factor degrades to 1 automatically on the terminal interval).
    Rk0 = R_hs[1:-1]  # R at hs_k-1 boundaries... build (M,M) with masks below
    j_idx = np.arange(1, M + 1)  # hidden-state boundary index of row j
    k_idx = np.arange(1, M + 1)
    Rj = R_hs[j_idx]  # (M,)
    Rkm1 = R_hs[k_idx - 1]  # (M,) R at lower edge of interval k
    Rk = R_hs[k_idx]  # (M,)
    dRk = Rk - Rkm1
    upper = k_idx[None, :] > j_idx[:, None]  # static mask, k > j
    # mask the exponent BEFORE exp: entries with k <= j would have huge
    # positive arguments (row j = M has R_hs[M] ~ 1e250) whose inf would
    # poison gradients through the where.
    arg = jnp.where(upper, -(Rkm1[None, :] - Rj[:, None]), -1.0)
    pc = jnp.exp(arg) * (-jnp.expm1(-dRk))[None, :]
    upper_part = jnp.where(upper, p_float[:, None] * pc, 0.0)

    # --- assemble
    lower = (np.arange(M)[None, :] < np.arange(M)[:, None])  # cols k-1 < j-1
    ed = jnp.concatenate([expm_diff, jnp.zeros(1, expm_diff.dtype)])
    lower_part = jnp.where(lower, ed[None, :], 0.0)
    Phi = lower_part + upper_part
    rowsum = jnp.sum(Phi, axis=1)
    Phi = Phi + jnp.diag(1.0 - rowsum)
    Phi = jnp.maximum(Phi, defaults.transition_floor)
    beta = defaults.transition_beta
    # reference divides beta by (number of hidden boundaries) = M + 1
    return Phi * (1.0 - beta) + beta / (M + 1)
