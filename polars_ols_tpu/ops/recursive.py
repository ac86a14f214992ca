"""Recursive least squares (exponentially-forgetting Kalman filter), batched.

The reference updates a K x K covariance state sequentially per sample
(src/least_squares.rs:494-598): ``r = 1 + x'Px/ff; k = Px/(r ff);
coef += k (y - x'coef); P = P/ff - k k' r`` — a true O(N) sequential scan.

Parallel reformulation: that recursion is exactly the recursive solution
of discounted ridge regression. With M_0 = P0^{-1} = (1/c) I and
``M_t = lam_t M_{t-1} + v_t x_t x_t'``, ``b_t = lam_t b_{t-1} + v_t x_t y_t``
(lam_t = forgetting factor on valid rows, 1 on skipped rows — invalid rows
leave the state untouched, :586-590), the RLS coefficient state satisfies
``coef_t = M_t^{-1} b_t`` identically. First-order linear recurrences are
associative, so the whole state trajectory is a parallel
``associative_scan`` over (lam, U, u), followed by one *batched* Cholesky
solve per row — O(log N) depth instead of O(N). Chunked to bound memory
at chunk * K^2.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .linalg import solve_psd

F64 = jnp.float64


def _combine(a, b):
    """(lam_a, S_a) then (lam_b, S_b): S = lam_b * S_a + S_b."""
    la, Ua, ua = a
    lb, Ub, ub = b
    return la * lb, lb[:, None, None] * Ua + Ub, lb[:, None] * ua + ub


def _rls_chunk(carry, chunk, inv_cov: float, mean0: jnp.ndarray, discounted: bool):
    disc_c, S_c, b_c = carry
    lam, U, u = chunk
    if discounted:
        lam_t, S_t, b_t = lax.associative_scan(_combine, (lam, U, u))
    else:
        lam_t = jnp.ones_like(lam)
        S_t = jnp.cumsum(U, axis=0)
        b_t = jnp.cumsum(u, axis=0)
    # merge chunk-local scan with running carry
    S_t = lam_t[:, None, None] * S_c + S_t
    b_t = lam_t[:, None] * b_c + b_t
    disc_t = disc_c * lam_t
    k = S_t.shape[-1]
    A = S_t + (disc_t * inv_cov)[:, None, None] * jnp.eye(k, dtype=F64)
    rhs = b_t + (disc_t * inv_cov)[:, None] * mean0
    coef = solve_psd(A, rhs)
    return (disc_t[-1], S_t[-1], b_t[-1]), coef


def _rls_single(
    X: jnp.ndarray,  # [R, K] zero-filled
    y: jnp.ndarray,  # [R]
    v: jnp.ndarray,  # [R] bool
    ff: float,
    inv_cov: float,
    mean0: jnp.ndarray,  # [K]
    chunk: int,
) -> jnp.ndarray:
    R, k = X.shape
    vf = v.astype(F64)
    lam = jnp.where(v, ff, 1.0) if ff != 1.0 else jnp.ones(R, dtype=F64)
    U = jnp.einsum("rk,rl->rkl", X * vf[:, None], X, preferred_element_type=F64)
    u = X * (vf * y)[:, None]

    n_chunks = R // chunk
    shape = lambda a: a.reshape((n_chunks, chunk) + a.shape[1:])
    carry0 = (jnp.asarray(1.0, F64), jnp.zeros((k, k), F64), jnp.zeros(k, F64))
    body = partial(_rls_chunk, inv_cov=inv_cov, mean0=mean0, discounted=(ff != 1.0))
    _, coefs = lax.scan(body, carry0, (shape(lam), shape(U), shape(u)))
    return coefs.reshape(R, k)


# above this feature count the chunked associative-scan solves (chunk*K^2
# state) stop paying for themselves: the per-row Sherman-Morrison scan —
# the reference's own K^2-per-row recursion (src/least_squares.rs:531-540)
# — needs no K^3 solves. The cutoff predates the GPU port and has not been
# re-measured there.
_SM_MIN_K = 33


def _rls_sm_single(X, y, v, ff: float, inv_cov: float, mean0: jnp.ndarray):
    """Per-row Sherman-Morrison RLS scan (reference least_squares.rs:
    494-546): P propagation, invalid rows leave the state untouched
    (:586-590) so coefficients forward-fill automatically."""
    K = X.shape[-1]

    def body(carry, xyv):
        P, coef = carry
        x, yt, vt = xyv
        vf = vt.astype(F64)
        Px = P @ x
        r = 1.0 + jnp.dot(x, Px) / ff
        k = Px / (r * ff)
        coef_new = coef + k * (yt - jnp.dot(x, coef))
        P_new = P / ff - jnp.outer(k, k) * r
        coef = jnp.where(vf > 0, coef_new, coef)
        P = jnp.where(vf > 0, P_new, P)
        return (P, coef), coef

    P0 = jnp.eye(K, dtype=F64) / inv_cov
    (_, _), coefs = lax.scan(body, (P0, mean0), (X, y, v))
    return coefs


@partial(
    jax.jit,
    static_argnames=("half_life", "initial_state_covariance", "initial_state_mean", "chunk"),
)
def solve_recursive_least_squares(
    Xp: jnp.ndarray,  # [G, R, K]
    yp: jnp.ndarray,  # [G, R]
    vp: jnp.ndarray,  # [G, R] bool — valid rows update the state
    half_life: Optional[float],
    initial_state_covariance: float,
    initial_state_mean: Optional[Tuple[float, ...]],
    chunk: int = 512,
) -> jnp.ndarray:
    """Batched RLS coefficient paths [G, R, K].

    forgetting_factor = exp(ln(0.5) / half_life), 1.0 when half_life is None
    (src/least_squares.rs:513-517); initial state P = I * c, coef = mean0 or 0
    (:519-522). Rows before the first valid observation yield exactly mean0.
    """
    import math

    G, R, k = Xp.shape
    ff = math.exp(math.log(0.5) / half_life) if half_life else 1.0
    c = initial_state_covariance if initial_state_covariance is not None else 10.0
    inv_cov = 1.0 / c
    if initial_state_mean is None:
        mean0 = jnp.zeros(k, dtype=F64)
    else:
        m = jnp.asarray(initial_state_mean, dtype=F64)
        mean0 = jnp.broadcast_to(m, (k,)) if m.ndim else jnp.full(k, m, dtype=F64)

    if k >= _SM_MIN_K:
        fn = partial(_rls_sm_single, ff=ff, inv_cov=inv_cov, mean0=mean0)
        return jax.vmap(fn)(Xp.astype(F64), yp.astype(F64), vp)

    chunk = min(chunk, R)
    pad = (-R) % chunk
    if pad:
        Xp = jnp.pad(Xp, ((0, 0), (0, pad), (0, 0)))
        yp = jnp.pad(yp, ((0, 0), (0, pad)))
        vp = jnp.pad(vp, ((0, 0), (0, pad)))

    fn = partial(_rls_single, ff=ff, inv_cov=inv_cov, mean0=mean0, chunk=chunk)
    coefs = jax.vmap(fn)(Xp.astype(F64), yp.astype(F64), vp)
    return coefs[:, :R]
