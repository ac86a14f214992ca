"""Batched linear-algebra primitives with data-dependent fallbacks.

Batched replacements for the reference's faer/LAPACK layer
(src/least_squares.rs:20-371): everything is *batched* over a leading group
axis and expressed as whole-batch XLA operations. The reference's
Cholesky -> SVD/LU/QR failure fallbacks (least_squares.rs:287-328) are
reproduced data-dependently inside jit with `lax.cond` + `where` selects.

All factorizations run in f64, so fp64 coefficient parity with
numpy.linalg.lstsq is preserved end-to-end.

Several small-K tiers below (unrolled Cholesky, gather-free LU, unrolled
Householder, lane-major QR and Jacobi SVD) replace XLA's batched
factorization calls. They predate the GPU port; they are plain JAX and
run on the GPU as they stand. Whether each still beats `jnp.linalg`
(cuSOLVER) on the GPU has not been measured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

F64 = jnp.float64
_EPS64 = float(jnp.finfo(jnp.float64).eps)


# --------------------------------------------------------------------------- #
# PSD solves (normal equations)
# --------------------------------------------------------------------------- #
def eigh_pinv_solve(A: jnp.ndarray, b: jnp.ndarray, rcond: float | None = None) -> jnp.ndarray:
    """Pseudo-inverse solve of symmetric A via eigh, batched.

    Robust fallback for singular normal equations: mirrors the reference's
    graceful degradation (zero coefficients on empty/degenerate input,
    src/expressions.rs:356-359) since eigh of a zero matrix yields a zero
    pseudo-inverse.
    """
    w, v = jnp.linalg.eigh(A)
    k = A.shape[-1]
    cut = (rcond if rcond is not None else _EPS64 * k) * jnp.max(
        jnp.abs(w), axis=-1, keepdims=True
    )
    w_inv = jnp.where(jnp.abs(w) > cut, 1.0 / jnp.where(w == 0, 1.0, w), 0.0)
    # A^+ b = V diag(w_inv) V^T b   (b may be [..., K] or [..., K, M])
    if b.ndim == A.ndim - 1:
        vtb = jnp.einsum("...ij,...i->...j", v, b)
        return jnp.einsum("...ij,...j->...i", v, w_inv * vtb)
    vtb = jnp.einsum("...ij,...im->...jm", v, b)
    return jnp.einsum("...ij,...jm->...im", v, w_inv[..., None] * vtb)


# K at or below this uses the unrolled register-level Cholesky. Above it the
# K^2 unrolled op count stops paying for itself vs the XLA batched kernel.
_UNROLL_MAX_K = 32


def chol_factor_vectorized(A: jnp.ndarray):
    """Right-looking batched Cholesky factorization with O(K) fused ops.

    The fully unrolled variant emits ~K^2 scalar-lane ops; on backends with
    high per-op launch cost that dominates. This version keeps whole
    trailing submatrices per step — one rank-1 update, one scaled column and
    one sqrt per elimination step (~4K ops total), all shaped [batch, K, K]
    so XLA fuses them into a handful of kernels.

    Returns (L [..., K, K] lower triangular — NaN columns on non-PD lanes,
    ok [...] bool finite-factor lanes).
    """
    K = A.shape[-1]
    S = A
    L_cols = []
    for j in range(K):
        d = jnp.sqrt(S[..., j, j])  # NaN/0 on non-PD lanes
        col = S[..., :, j] / jnp.where(d == 0, 1.0, d)[..., None]
        col = col * (jnp.arange(K) >= j)  # zero above the diagonal
        col = jnp.where((d == 0)[..., None], jnp.nan, col)
        L_cols.append(col)
        S = S - col[..., :, None] * col[..., None, :]
    L = jnp.stack(L_cols, axis=-1)  # [..., K, K] lower triangular
    ok = jnp.isfinite(L).all(axis=(-2, -1))
    return L, ok


def chol_substitute_vectorized(L: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Forward + back substitution against a batched lower factor (the
    substitution half of `_chol_solve_vectorized`; reusable for repeated
    right-hand sides against one factorization)."""
    K = L.shape[-1]
    # forward substitution: L z = rhs
    z = rhs
    zs = []
    for j in range(K):
        zj = z[..., j, :] / L[..., j, j][..., None]
        zs.append(zj)
        z = z - L[..., :, j][..., None] * zj[..., None, :]
    z = jnp.stack(zs, axis=-2)  # [..., K, M]
    # back substitution: L^T x = z
    x = z
    xs = [None] * K
    for j in range(K - 1, -1, -1):
        xj = x[..., j, :] / L[..., j, j][..., None]
        xs[j] = xj
        x = x - L[..., j, :][..., :, None] * xj[..., None, :]
    return jnp.stack(xs, axis=-2)


def _chol_solve_vectorized(A: jnp.ndarray, rhs: jnp.ndarray):
    """Batched Cholesky solve: `chol_factor_vectorized` + substitution.

    Args:
        A: [..., K, K] symmetric.
        rhs: [..., K, M].
    Returns:
        (solution [..., K, M], ok [...] bool finite-factor lanes)
    """
    L, ok = chol_factor_vectorized(A)
    return chol_substitute_vectorized(L, rhs), ok


def _chol_solve_unrolled(A: jnp.ndarray, rhs: jnp.ndarray):
    """Fully unrolled batched Cholesky solve for small static K.

    Unrolling the K^2/2 multiply-adds into plain elementwise ops over the
    batch lanes turns the whole solve into a few fused elementwise kernels
    in place of batched factorization calls. Negative
    or zero pivots produce NaN/Inf naturally (sqrt/div), which the caller's
    finite-check turns into the eigh fallback — the same failure semantics
    as the reference's Cholesky error path (src/least_squares.rs:287-328).

    Args:
        A: [..., K, K] symmetric.
        rhs: [..., K, M].
    Returns:
        (solution [..., K, M], ok [...] bool lanes where the factor is finite)
    """
    K = A.shape[-1]
    a = [[A[..., i, j] for j in range(i + 1)] for i in range(K)]
    L = [[None] * (i + 1) for i in range(K)]
    inv_d = [None] * K
    for j in range(K):
        s = a[j][j]
        for m in range(j):
            s = s - L[j][m] * L[j][m]
        d = jnp.sqrt(s)  # NaN if not PD — caught by the finite check
        L[j][j] = d
        inv_d[j] = 1.0 / d
        for i in range(j + 1, K):
            s = a[i][j]
            for m in range(j):
                s = s - L[i][m] * L[j][m]
            L[i][j] = s * inv_d[j]
    ok = jnp.isfinite(L[K - 1][K - 1])
    for i in range(K - 1):
        for j in range(i + 1):
            ok = ok & jnp.isfinite(L[i][j])

    e = lambda x: x[..., None]  # broadcast a [...] factor over the M axis
    b = [rhs[..., i, :] for i in range(K)]
    z = [None] * K
    for i in range(K):
        s = b[i]
        for m in range(i):
            s = s - e(L[i][m]) * z[m]
        z[i] = s * e(inv_d[i])
    x = [None] * K
    for i in range(K - 1, -1, -1):
        s = z[i]
        for m in range(i + 1, K):
            s = s - e(L[m][i]) * x[m]
        x[i] = s * e(inv_d[i])
    return jnp.stack(x, axis=-2), ok


def chol_factor(A: jnp.ndarray):
    """(L, ok): the vectorized column recurrence at small static K, the
    batched Cholesky custom call otherwise."""
    if A.shape[-1] <= _UNROLL_MAX_K:
        return chol_factor_vectorized(A)
    L = jnp.linalg.cholesky(A)
    return L, jnp.isfinite(L).all(axis=(-2, -1))


def psd_solver(A: jnp.ndarray):
    """Factor A ONCE and return `solve(b)` for repeated right-hand sides.

    Iterative-refinement loops (CSNE sweeps, engine/fit.py) solve against
    the same normal matrix several times; re-running `solve_psd` per sweep
    re-factorizes A each time — at K=100 that is 4 extra Cholesky
    factorizations per query. Failed (non-PD) lanes take the
    eigh-pinv fallback on every call, under `lax.cond` exactly like
    `solve_psd` (the factor is identity-substituted on those lanes so the
    substitution stays finite)."""
    k = A.shape[-1]
    L, ok = chol_factor(A)
    Ls = jnp.where(ok[..., None, None], L, jnp.eye(k, dtype=A.dtype))
    small = k <= _UNROLL_MAX_K

    def solve(b: jnp.ndarray) -> jnp.ndarray:
        rhs = b[..., None] if b.ndim == A.ndim - 1 else b
        if small:
            sol = chol_substitute_vectorized(Ls, rhs)
        else:
            sol = jax.scipy.linalg.cho_solve((Ls, True), rhs)
        sol = jnp.where(jnp.isfinite(sol), sol, 0.0)

        def with_fallback(_):
            fb = eigh_pinv_solve(A, rhs)
            return jnp.where(ok[..., None, None], sol, fb)

        out = lax.cond(ok.all(), lambda _: sol, with_fallback, operand=None)
        return out[..., 0] if b.ndim == A.ndim - 1 else out

    return solve


def _solve_psd_inner(A: jnp.ndarray, rhs: jnp.ndarray):
    """Shared core of solve_psd/solve_psd_cond: returns (sol, ok, d2) where
    d2 are the squared Cholesky pivots L_jj^2 (NaN on failed lanes) — the
    conditioning estimate comes from the SAME factorization as the solve
    (a second pivot pass used to cost an extra K=100 f64 factorization)."""
    k = A.shape[-1]
    if k <= _UNROLL_MAX_K:
        L, ok = chol_factor_vectorized(A)
        sol = chol_substitute_vectorized(L, rhs)
    else:
        L, ok = chol_factor(A)
        sol = jax.scipy.linalg.cho_solve(
            (L, True), jnp.where(ok[..., None, None], rhs, 0.0)
        )
    sol = jnp.where(jnp.isfinite(sol), sol, 0.0)

    def with_fallback(_):
        fb = eigh_pinv_solve(A, rhs)
        return jnp.where(ok[..., None, None], sol, fb)

    out = lax.cond(ok.all(), lambda _: sol, with_fallback, operand=None)
    d2 = jnp.square(jnp.diagonal(L, axis1=-2, axis2=-1))
    return out, ok, d2


def solve_psd(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched Cholesky solve of PSD systems with eigh-pinv fallback.

    Equivalent of the reference's `solve_normal_equations` (Cholesky default
    with LU/SVD fallback on failure, src/least_squares.rs:277-337), made
    branchless per batch element: lanes whose Cholesky produced non-finite
    values take the eigh pseudo-solve result instead. The fallback pass only
    runs (via lax.cond) when at least one lane failed. Small K uses the
    unrolled elementwise factorization (no XLA custom call).
    """
    rhs = b[..., None] if b.ndim == A.ndim - 1 else b
    out, _, _ = _solve_psd_inner(A, rhs)
    return out[..., 0] if b.ndim == A.ndim - 1 else out


def solve_psd_cond(A: jnp.ndarray, b: jnp.ndarray):
    """solve_psd plus a cheap per-lane condition estimate of A (see
    solve_psd_cond_ok)."""
    sol, cond_est, _ = solve_psd_cond_ok(A, b)
    return sol, cond_est


def solve_psd_cond_ok(A: jnp.ndarray, b: jnp.ndarray):
    """solve_psd plus a cheap per-lane condition estimate of A.

    The estimate is the squared ratio of extreme Cholesky pivots,
    ``(max_j L_jj / min_j L_jj)^2`` — a lower bound on cond_2(A) that is
    tight for the near-collinear-column failure mode of normal equations.
    Failed lanes (handled by the eigh fallback) report estimate 1 so they
    do not trigger the caller's refinement branch; the third return value
    flags them explicitly for callers that must reroute failures (e.g. the
    explicit-svd minimum-norm guard).

    Returns (solution, cond_est [...], chol_ok [...]).
    """
    rhs = b[..., None] if b.ndim == A.ndim - 1 else b
    out, ok, d2 = _solve_psd_inner(A, rhs)
    finite = jnp.isfinite(d2) & (d2 > 0)
    dmax = jnp.max(jnp.where(finite, d2, 0.0), axis=-1)
    dmin = jnp.min(jnp.where(finite, d2, jnp.inf), axis=-1)
    cond_est = jnp.where(
        finite.all(axis=-1), dmax / jnp.maximum(dmin, 1e-300), 1.0
    )
    sol = out[..., 0] if b.ndim == A.ndim - 1 else out
    return sol, cond_est, ok


def _lu_solve_vectorized(A: jnp.ndarray, rhs: jnp.ndarray):
    """Batched partial-pivot LU solve with O(K) fused column passes.

    Like the vectorized Cholesky above, Gaussian elimination is expressed
    as K whole-submatrix elimination steps whose every op is elementwise
    over the batch lanes. Per-step row pivoting is done WITHOUT gathers:
    the pivot row is extracted with a one-hot multiply+reduce and the swap
    applied as two rank-1 corrections.

    Args:
        A: [..., K, K] general square (no symmetry assumed).
        rhs: [..., K, M].
    Returns:
        (solution [..., K, M], ok [...] bool lanes with finite nonzero pivots)
    """
    K = A.shape[-1]
    rows = jnp.arange(K)
    S = A
    B = rhs
    inv_d = []  # [...] reciprocal pivots (aligned with final row positions)
    min_abs_d = None
    for j in range(K):
        # partial pivot: largest |S[i, j]| over i >= j
        mag = jnp.where(rows >= j, jnp.abs(S[..., :, j]), -1.0)
        p = jnp.argmax(mag, axis=-1)  # [...]
        hot_p = rows == p[..., None]  # [..., K]
        hot_j = (rows == j) & jnp.ones_like(hot_p)
        # swap rows j <-> p of S and B: S' = S + (1_j - 1_p) (S[p] - S[j])'.
        # Multipliers are stored compactly below the diagonal of S (classic
        # in-place LU), so the swap carries already-computed L rows along —
        # exactly the permutation bookkeeping a pivot array would do.
        delta_S = (S * hot_p[..., :, None]).sum(-2) - S[..., j, :]
        swap = (hot_j ^ hot_p).astype(S.dtype) * jnp.where(hot_j, 1.0, -1.0)
        S = S + swap[..., :, None] * delta_S[..., None, :]
        delta_B = (B * hot_p[..., :, None]).sum(-2) - B[..., j, :]
        B = B + swap[..., :, None] * delta_B[..., None, :]
        # eliminate column j below the diagonal, storing the multipliers in
        # the zeroed positions (columns < j stay untouched by the update:
        # the pivot row is masked to cols >= j)
        d = S[..., j, j]
        dj = 1.0 / jnp.where(d == 0, 1.0, d)
        dj = jnp.where(d == 0, jnp.nan, dj)
        col = S[..., :, j] * dj[..., None] * (rows > j)
        pivrow = S[..., j, :] * (rows >= j)
        S = S - col[..., :, None] * (pivrow[..., None, :] - (rows == j))
        inv_d.append(dj)
        ad = jnp.abs(d)
        min_abs_d = ad if min_abs_d is None else jnp.minimum(min_abs_d, ad)
    # S now holds U on/above the diagonal and L's multipliers strictly below
    U = S * (rows[:, None] <= rows[None, :])
    L = S * (rows[:, None] > rows[None, :])
    ok = jnp.isfinite(S).all(axis=(-2, -1)) & (min_abs_d > 0)
    # forward substitution (unit lower): z_j = B_j - sum_{m<j} L[j,m] z_m
    z = B
    zs = []
    for j in range(K):
        zj = z[..., j, :]
        zs.append(zj)
        z = z - L[..., :, j][..., None] * zj[..., None, :]
    z = jnp.stack(zs, axis=-2)
    # back substitution: U x = z
    x = z
    xs = [None] * K
    for j in range(K - 1, -1, -1):
        xj = x[..., j, :] * inv_d[j][..., None]
        xs[j] = xj
        x = x - U[..., :, j][..., :, None] * xj[..., None, :]
    return jnp.stack(xs, axis=-2), ok


def solve_lu(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched partial-pivot LU solve with eigh-pinv fallback on failure.

    Genuine LU, matching the reference's faer partial-piv path
    (src/least_squares.rs:264-273) — unlike the Cholesky kernel it does not
    assume positive-definiteness, so indefinite systems solve directly.
    Singular lanes degrade to the eigh pseudo-solve, mirroring the
    reference's solve_normal_equations fallback chain
    (src/least_squares.rs:287-328)."""
    rhs = b[..., None] if b.ndim == A.ndim - 1 else b
    sol, ok = _lu_solve_vectorized(A, rhs)
    sol = jnp.where(jnp.isfinite(sol), sol, 0.0)

    def with_fallback(_):
        fb = eigh_pinv_solve(A, rhs)
        return jnp.where(ok[..., None, None], sol, fb)

    out = lax.cond(ok.all(), lambda _: sol, with_fallback, operand=None)
    return out[..., 0] if b.ndim == A.ndim - 1 else out


# --------------------------------------------------------------------------- #
# Householder QR reduction (vectorized over the batch axis)
# --------------------------------------------------------------------------- #
def _householder_reduce(X: jnp.ndarray, Y: jnp.ndarray):
    """Batched Householder reduction: X = Q [R; 0], returns (R [..., K, K]
    upper-triangular, QtY [..., K, M]).

    K explicit reflections as whole-tensor elementwise ops + reductions,
    in place of XLA's batched QR call. Zero rows (masked /
    padding) are genuine zero observations and pass through correctly;
    zero pivot columns (rank deficiency) make the reflection the identity
    and leave a zero diagonal in R for the caller's rank handling."""
    K = X.shape[-1]
    Rn = X.shape[-2]
    rows = jnp.arange(Rn)
    A, B = X, Y
    for j in range(K):
        mask = (rows >= j).astype(X.dtype)  # [R]
        col = A[..., :, j] * mask  # [..., R]
        sigma = jnp.sum(col * col, axis=-1, keepdims=True)  # [..., 1]
        cj = A[..., j, j][..., None]
        s = jnp.where(cj >= 0, 1.0, -1.0)
        alpha = -s * jnp.sqrt(sigma)
        v = jnp.where(rows == j, col - alpha, col)  # [..., R]
        denom = sigma - cj * alpha  # = ||v||^2 / 2
        beta = jnp.where(denom > 0, 1.0 / denom, 0.0)
        bv = beta[..., None] * v[..., :, None]  # [..., R, 1]
        vtA = jnp.einsum("...r,...rk->...k", v, A)
        A = A - bv * vtA[..., None, :]
        vtB = jnp.einsum("...r,...rm->...m", v, B)
        B = B - bv * vtB[..., None, :]
    return A[..., :K, :], B[..., :K, :]


# a reflection pass costs O(K) whole-tensor ops; above this K the op count
# (and [G,R,K] traffic per reflection) favors the XLA QR call — except for
# small batch counts, where the unrolled reflections are kept up to K ~ 128
# (see _use_unrolled_householder). Thresholds predate the GPU port and
# have not been retuned.
_HOUSEHOLDER_MAX_K = 32


def _use_unrolled_householder(batch: int, k: int) -> bool:
    return k <= _HOUSEHOLDER_MAX_K or (batch <= 4 and k <= 128)


# --------------------------------------------------------------------------- #
# lane-major Householder QR + one-sided Jacobi SVD (grouped explicit paths)
# --------------------------------------------------------------------------- #
# lane kernels unroll K reflections / K(K-1)/2 Jacobi rotation pairs; keep
# the op count sane
_LANE_QR_MAX_K = 8
_JACOBI_SWEEPS = 8


def householder_lanes(X: jnp.ndarray, Y: jnp.ndarray):
    """Lane-major batched Householder reduction: X [R, K, G] (group axis
    minor-most, so every op runs over all groups at once), Y [R, M, G] ->
    (R [K, K, G] upper triangular, QtY [K, M, G]). Exact to ~1e-14.
    Zero (masked/padding) rows pass through as genuine zero observations."""
    Rn, K, G = X.shape
    rows = jnp.arange(Rn)
    A, B = X, Y
    for j in range(K):
        mask = (rows >= j).astype(A.dtype)[:, None]  # [R, 1]
        colf = A[:, j, :] * mask  # [R, G]
        sigma = (colf * colf).sum(axis=0)  # [G]
        cj = A[j, j, :]
        s = jnp.where(cj >= 0, 1.0, -1.0)
        alpha = -s * jnp.sqrt(sigma)
        v = jnp.where((rows == j)[:, None], colf - alpha[None, :], colf)
        denom = sigma - cj * alpha  # = ||v||^2 / 2
        beta = jnp.where(denom > 0, 1.0 / denom, 0.0)  # [G]
        vtA = (v[:, None, :] * A).sum(axis=0)  # [K, G]
        A = A - (beta[None, :] * v)[:, None, :] * vtA[None, :, :]
        vtB = (v[:, None, :] * B).sum(axis=0)  # [M, G]
        B = B - (beta[None, :] * v)[:, None, :] * vtB[None, :, :]
    return A[:K], B[:K]


def jacobi_svd_lanes(W: jnp.ndarray, n_sweeps: int = _JACOBI_SWEEPS):
    """One-sided Jacobi SVD of W [K, K, G] in lane-major layout: returns
    (U [K, K, G], sigma [K, G], V [K, K, G]) with W = U diag(sigma) V^T.

    Every rotation is elementwise over the G lanes, in place of XLA's
    batched SVD call; singular values match LAPACK to ~1e-14. Zero columns (rank
    deficiency) yield sigma = 0 with U columns left untouched."""
    K, _, G = W.shape
    V = jnp.eye(K, dtype=W.dtype)[:, :, None] * jnp.ones((1, 1, G), W.dtype)
    for _ in range(n_sweeps):
        for p in range(K - 1):
            for q in range(p + 1, K):
                wp = W[:, p, :]
                wq = W[:, q, :]
                app = (wp * wp).sum(0)
                aqq = (wq * wq).sum(0)
                apq = (wp * wq).sum(0)
                tau = (aqq - app) / (2.0 * jnp.where(apq == 0, 1.0, apq))
                # sign(0) must be +1 here: tau = 0 (equal-norm correlated
                # columns) needs the full 45-degree rotation, not a no-op
                t = jnp.where(tau >= 0, 1.0, -1.0) / (
                    jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau)
                )
                t = jnp.where(apq == 0, 0.0, t)
                c = 1.0 / jnp.sqrt(1.0 + t * t)
                s = c * t
                W = W.at[:, p, :].set(c * wp - s * wq).at[:, q, :].set(s * wp + c * wq)
                vp = V[:, p, :]
                vq = V[:, q, :]
                V = V.at[:, p, :].set(c * vp - s * vq).at[:, q, :].set(s * vp + c * vq)
    sigma = jnp.sqrt((W * W).sum(0))  # [K, G]
    U = W / jnp.where(sigma == 0, 1.0, sigma)[None, :, :]
    return U, sigma, V


def svd_lstsq_lanes(
    Xp: jnp.ndarray,  # [G, R, K] padded rows (masked rows zeroed)
    yp: jnp.ndarray,  # [G, R] or [G, R, M]
    alpha: float | jnp.ndarray = 0.0,
    rcond: float | None = None,
    n_valid: jnp.ndarray | None = None,  # [G] per-group valid-row counts
) -> jnp.ndarray:
    """Grouped minimum-norm (ridge-shrunk) SVD least squares in lane-major
    layout: Householder reduction to the K x K factor + one-sided Jacobi
    SVD, with numpy-lstsq rcond-cutoff semantics identical to `svd_lstsq`
    (reference solve_ridge_svd, src/least_squares.rs:106-168). The default
    cutoff uses each group's own valid-row count (``n_valid``) rather than
    the padded row dimension, so small groups keep numpy's
    ``eps * max(n_g, k)`` semantics."""
    G, n, k = Xp.shape
    squeeze = yp.ndim == 2
    Y = yp[..., None] if squeeze else yp
    Xl = Xp.transpose(1, 2, 0)  # [R, K, G]
    Yl = Y.transpose(1, 2, 0)  # [R, M, G]
    Rf, QtY = householder_lanes(Xl, Yl)  # [K,K,G], [K,M,G]
    u, s, v = jacobi_svd_lanes(Rf)
    uty = (u[:, :, None, :] * QtY[:, None, :, :]).sum(axis=0)  # [K, M, G]
    if rcond is None:
        if n_valid is not None:
            rcond = _EPS64 * jnp.maximum(n_valid.astype(F64), float(k))  # [G]
        else:
            rcond = _EPS64 * max(n, k)
    cut = rcond * s.max(axis=0)  # [G]
    alpha = jnp.asarray(alpha, dtype=F64)
    denom = s * s + alpha
    d = jnp.where(s > cut[None, :], s / jnp.where(denom == 0, 1.0, denom), 0.0)
    term = d[:, None, :] * uty  # [K(j), M, G]
    beta = (v[:, :, None, :] * term[None, :, :, :]).sum(axis=1)  # [K(i), M, G]
    out = beta.transpose(2, 0, 1)  # [G, K, M]
    return out[..., 0] if squeeze else out


# --------------------------------------------------------------------------- #
# SVD least squares (minimum norm, numpy-lstsq parity)
# --------------------------------------------------------------------------- #
def svd_lstsq(
    X: jnp.ndarray,
    y: jnp.ndarray,
    alpha: float | jnp.ndarray = 0.0,
    rcond: float | None = None,
    n_valid: jnp.ndarray | None = None,  # [...] per-problem valid-row counts
) -> jnp.ndarray:
    """Minimum-norm (ridge-shrunk) least squares via SVD, batched.

    Mirrors the reference's `solve_ridge_svd` (src/least_squares.rs:106-168):
    singular values below ``rcond * sigma_max`` are cut (numpy lstsq default
    ``rcond = eps * max(n, k)``, least_squares.rs:142-145) and the remaining
    directions are shrunk by ``sigma / (sigma^2 + alpha)`` (plain pinv when
    alpha == 0).

    For tall problems the SVD is taken of the K x K triangular factor from a
    QR of X — a reduction that preserves singular values.

    Args:
        X: [..., N, K] (rows may be zero — masked rows contribute nothing).
        y: [..., N] or [..., N, M].
        alpha: scalar or [...] ridge strength.
        rcond: cutoff ratio; None -> numpy lstsq default.
    """
    n, k = X.shape[-2], X.shape[-1]
    batch = int(np.prod(X.shape[:-2])) if X.ndim > 2 else 1
    squeeze = y.ndim == X.ndim - 1
    Y = y[..., None] if squeeze else y

    if n > k:
        # QR reduction: svd(X) = (Q U_r) S V^T with R = U_r S V^T
        if _use_unrolled_householder(batch, k):
            R, QtY = _householder_reduce(X, Y)
        else:
            Q, R = jnp.linalg.qr(X)
            QtY = jnp.einsum("...ni,...nm->...im", Q, Y)
        u_r, s, vt = jnp.linalg.svd(R, full_matrices=False)
        uty = jnp.einsum("...ji,...jm->...im", u_r, QtY)
    else:
        u, s, vt = jnp.linalg.svd(X, full_matrices=False)
        uty = jnp.einsum("...ni,...nm->...im", u, Y)

    if rcond is None:
        if n_valid is not None:
            # per-problem numpy-lstsq default: eps * max(n_valid, k)
            rcond = _EPS64 * jnp.maximum(n_valid.astype(F64), float(k))[..., None]
        else:
            rcond = _EPS64 * max(n, k)
    cut = rcond * jnp.max(s, axis=-1, keepdims=True)
    alpha = jnp.asarray(alpha, dtype=F64)
    denom = s * s + alpha[..., None] if alpha.ndim else s * s + alpha
    d = jnp.where(s > cut, s / jnp.where(denom == 0, 1.0, denom), 0.0)
    beta = jnp.einsum("...ik,...im->...km", vt, d[..., None] * uty)
    return beta[..., 0] if squeeze else beta


# --------------------------------------------------------------------------- #
# QR least squares with rank-deficiency handling
# --------------------------------------------------------------------------- #
def qr_lstsq(X: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """QR least squares, batched, tolerant of rank deficiency.

    The reference uses faer's column-pivoted QR (least_squares.rs:193-205)
    which implicitly drops dependent columns. XLA's QR is unpivoted, so we
    detect near-zero diagonal entries of R and re-solve the normal equations
    with those columns excluded (coefficient forced to 0) — giving finite
    coefficients and identical predictions on collinear inputs, as exercised
    by reference tests/test_ols.py:324-360.
    """
    n, k = X.shape[-2], X.shape[-1]
    batch = int(np.prod(X.shape[:-2])) if X.ndim > 2 else 1
    if _use_unrolled_householder(batch, k) and n > k:
        R, qty2 = _householder_reduce(X, y[..., None])
        qty = qty2[..., 0]
    else:
        Q, R = jnp.linalg.qr(X)
        qty = jnp.einsum("...ni,...n->...i", Q, y)
    diag = jnp.abs(jnp.diagonal(R, axis1=-2, axis2=-1))
    tol = _EPS64 * max(n, k) * jnp.max(diag, axis=-1, keepdims=True)
    keep = diag > tol  # [..., K]

    full_rank = keep.all()

    def solve_full(_):
        if k <= _HOUSEHOLDER_MAX_K:
            # unrolled back-substitution (no triangular-solve custom call)
            xs = [None] * k
            for i in range(k - 1, -1, -1):
                acc = qty[..., i]
                for m in range(i + 1, k):
                    acc = acc - R[..., i, m] * xs[m]
                xs[i] = acc / R[..., i, i]
            return jnp.stack(xs, axis=-1)
        return jax.scipy.linalg.solve_triangular(R, qty, lower=False)

    def solve_deficient(_):
        # zero out dropped columns; solve (X_keep^T X_keep + tiny*I) via
        # masked normal equations so dropped coefficients are exactly 0.
        # Per-lane selection: only the rank-deficient lanes take this
        # fallback — full-rank lanes in the same batch keep the QR
        # back-substitution result (matching the per-group semantics of
        # the reference's per-call column-pivoted QR).
        Xm = X * keep[..., None, :]
        A = jnp.einsum("...nk,...nl->...kl", Xm, Xm)
        # unit diagonal on dropped columns keeps the system non-singular
        eye = jnp.eye(k, dtype=X.dtype)
        A = A + eye * jnp.where(keep, 0.0, 1.0)[..., None, :] * jnp.where(
            keep, 0.0, 1.0
        )[..., :, None]
        b = jnp.einsum("...nk,...n->...k", Xm, y)
        fallback = solve_psd(A, b) * keep
        lane_full = keep.all(axis=-1)  # [...] per-lane rank flag
        return jnp.where(lane_full[..., None], solve_full(None), fallback)

    return lax.cond(full_rank, solve_full, solve_deficient, operand=None)


# --------------------------------------------------------------------------- #
# Student-t survival (p-values)
# --------------------------------------------------------------------------- #
def t_two_sided_p_value(t: jnp.ndarray, dof: jnp.ndarray) -> jnp.ndarray:
    """Two-sided p-value 2*(1 - F_t(|t|; dof)) via the regularized incomplete
    beta identity p = I_{v/(v+t^2)}(v/2, 1/2). Replaces the reference's
    statrs Student-t CDF (src/statistics.rs:44-48)."""
    t = jnp.asarray(t, dtype=F64)
    dof = jnp.asarray(dof, dtype=F64)
    x = dof / (dof + t * t)
    return jax.scipy.special.betainc(dof / 2.0, 0.5, x)
