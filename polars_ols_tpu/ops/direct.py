"""Batched direct solvers (OLS / WLS / Ridge / multi-target).

The reference solves each group independently with faer/LAPACK
(src/least_squares.rs:93-371). Here every solver is batched over the group
axis G: moments are accumulated with batched matmuls over a split-padded
row layout, factorizations run as XLA batched kernels, and the solver
dispatch table (src/expressions.rs:361-388, defaults least_squares.rs:
220-231) is resolved statically at trace time.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .linalg import qr_lstsq, solve_lu, solve_psd, svd_lstsq

F64 = jnp.float64


# --------------------------------------------------------------------------- #
# moment accumulation
# --------------------------------------------------------------------------- #
@partial(jax.jit, static_argnames=("num_groups",))
def grouped_moments(
    Xp: jnp.ndarray,  # [S, R, K] split-padded features (masked rows zeroed)
    yp: jnp.ndarray,  # [S, R] or [S, R, M]
    wp: jnp.ndarray,  # [S, R] bool fit mask
    block_group: jnp.ndarray,  # [S] block -> group
    num_groups: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Accumulate per-group XtX [G,K,K], Xty [G,K(,M)] and valid counts [G].

    Heavy groups arrive pre-split into multiple blocks; partial moments are
    segment-summed — the associativity that also makes multi-chip psum
    merges exact (SURVEY §2.3).
    """
    w = wp.astype(Xp.dtype)
    Xm = Xp * w[..., None]
    xtx_blocks = jnp.einsum("srk,srl->skl", Xm, Xp, preferred_element_type=F64)
    if yp.ndim == 2:
        xty_blocks = jnp.einsum("srk,sr->sk", Xm, yp, preferred_element_type=F64)
    else:
        xty_blocks = jnp.einsum("srk,srm->skm", Xm, yp, preferred_element_type=F64)
    counts = jax.ops.segment_sum(w.sum(axis=1), block_group, num_segments=num_groups)
    XtX = jax.ops.segment_sum(xtx_blocks, block_group, num_segments=num_groups)
    Xty = jax.ops.segment_sum(xty_blocks, block_group, num_segments=num_groups)
    return XtX, Xty, counts


# --------------------------------------------------------------------------- #
# solver dispatch
# --------------------------------------------------------------------------- #
def resolve_solve_method(
    solve_method: Optional[str],
    alpha: float,
    l1_ratio: Optional[float],
    positive: bool,
    n_rows: int,
    n_features: int,
) -> str:
    """Static resolution of the reference's dispatch table
    (src/expressions.rs:361-388; OLS default QR if n>k else SVD,
    least_squares.rs:220-231; ridge default Cholesky, :342-371).

    Amendment: for overdetermined unregularized fits the auto default
    is the fused normal-equation path ('chol') rather than QR — one
    moment pass + the vectorized batched Cholesky, with the eigh-pinv
    fallback covering rank deficiency (minimum-norm like the reference's
    fallbacks). Explicitly requested 'qr'/'svd' are always honored.
    """
    assert alpha >= 0.0, "regularization alpha must be non-negative"
    l1 = l1_ratio or 0.0
    if positive or l1 > 0.0:
        # coordinate descent needs a strictly positive penalty, matching
        # the reference's CD precondition (src/least_squares.rs:409)
        assert alpha > 0.0, (
            "lasso / elastic_net / nnls require alpha > 0 "
            "(use ols/ridge for an unpenalized fit)"
        )
        m = solve_method or "cd"
        assert m in ("cd", "cd_active_set"), m
        return m
    if alpha > 0.0:  # ridge
        m = solve_method or "chol"
        assert m in ("chol", "lu", "svd", "cd", "cd_active_set", "qr"), m
        return m
    m = solve_method
    if m is None:
        # overdetermined auto-dispatch -> fused normal-equation path (the
        # vectorized Cholesky's eigh-pinv fallback covers rank deficiency
        # with minimum-norm solutions); underdetermined -> SVD minimum-norm
        # (numpy-lstsq parity). The reference defaults to QR here
        # (least_squares.rs:220-231) — same estimates, different factorization.
        m = "chol" if n_rows > n_features else "svd"
    assert m in ("qr", "svd", "chol", "lu", "cd", "cd_active_set"), m
    return m


@partial(jax.jit, static_argnames=("method",))
def solve_from_moments(
    XtX: jnp.ndarray, Xty: jnp.ndarray, alpha: float, method: str
) -> jnp.ndarray:
    """Normal-equation solves: 'chol' (Cholesky w/ fallback) or 'lu'."""
    k = XtX.shape[-1]
    A = XtX + jnp.asarray(alpha, F64) * jnp.eye(k, dtype=F64)
    if method == "lu":
        return solve_lu(A, Xty)
    return solve_psd(A, Xty)


@partial(jax.jit, static_argnames=("method", "rcond"))
def solve_from_rows(
    Xp: jnp.ndarray,  # [G, R, K] padded, fit-masked rows zeroed
    yp: jnp.ndarray,  # [G, R] or [G, R, M]
    alpha: float,
    method: str,
    rcond: Optional[float],
    n_valid: Optional[jnp.ndarray] = None,  # [G] valid-row counts
) -> jnp.ndarray:
    """Row-space solves: 'qr' (rank-tolerant QR) or 'svd' (minimum-norm with
    numpy-lstsq rcond semantics — per-group valid-row counts, not the padded
    row dimension — optionally ridge-shrunk)."""
    if method == "qr":
        return qr_lstsq(Xp, yp)
    return svd_lstsq(Xp, yp, alpha=alpha, rcond=rcond, n_valid=n_valid)
