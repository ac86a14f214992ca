"""Lane-major moving-window kernels (RLS + rolling OLS).

The reference solves these models with per-row sequential state updates on
the host (src/least_squares.rs:494-598, 848-1032). The classic kernels
(ops/recursive.py, ops/rolling.py) reproduce the recursions as batched
scans with state shaped ``[G, chunk, K, K]``, whose minor-most axis is a
tiny K. Here the group axis G is minor-most, so every elementwise step of a
scan body runs over all groups at once, with neighbouring groups adjacent
in memory. On one H100 this layout runs grouped 2M x 5 x 10k rls and
rolling 16-18x faster than the classic kernels (PERF.md, Findings), and
CONFIG.moving_lanes defaults on for the GPU.

Two formulations:

* **lane-chol** (K <= LANE_CHOL_MAX_K, exact f64): windowed/discounted
  moments are prefix sums computed chunk-at-a-time in ``[C, K, K, G]``
  layout (group axis minor-most); every row's K x K normal-equation system
  is solved by a fully unrolled Cholesky whose every op is elementwise over
  ``[C, G]`` lanes. No inverse propagation, no downdate instability: each
  row is solved fresh from exact f64 moments. (A trailing G=1 axis is free
  — XLA canonicalizes size-1 dims — so this also serves single groups.)

* **refined-SM** (any K; used when groups are too few to fill the lanes or
  K is too large to unroll): rows are split into chunks of C; chunk-start
  states are computed exactly in f64 by a tiny prefix scan over per-chunk
  moment summaries; all (group, chunk) lanes then scan their C rows in
  parallel — sequential depth C, not N. Within the scan the inverse state
  P advances with Sherman-Morrison rank-1 updates — f32 for RLS (its
  Bayesian priors keep the warm-up well-conditioned; f32 state moves half
  the bytes), f64 for rolling (its chunk-0 seed is the diffuse
  I/reg, f32-catastrophic) — while exact moments (A, b) accumulate in f64
  (elementwise adds); every row's coefficient is corrected
  with two refinement passes ``c += P (b - A c)``. P is only a
  *preconditioner*: low-precision drift, skipped downdates on singular
  leaving-rows, and approximate seeds cost convergence rate, never
  correctness. Measured error vs the exact f64 recursion: ~1e-9 relative
  at K=100 over 512-row chunks. Batches too large for the whole-batch
  state scan sequential group blocks (``lanes_group_block``).
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

F64 = jnp.float64
F32 = jnp.float32

# unrolled lane-Cholesky op count grows ~K^3/6; above this K the column-pass
# variant (~11K ops on shrinking submatrix slices) takes over. The cutoffs
# and memory budgets below predate the GPU port and have not been retuned
# for the GPU. Env-overridable for tuning.
LANE_CHOL_UNROLL_MAX_K = int(os.environ.get("POLS_TPU_LANE_CHOL_UNROLL_MAX_K", "16"))
# above the unroll cutoff the column-pass lane Cholesky covers K up to this
# bound (the reference's Woodbury rolling covers every K uniformly,
# src/least_squares.rs:848-1032; beyond it the refined-SM / classic kernels
# take over). Chunk temporaries are [C, K, K, G] f64, so the applicability
# check also bounds memory.
LANE_CHOL_MAX_K = int(os.environ.get("POLS_TPU_LANE_CHOL_MAX_K", "32"))
# cap on the [C, K, K, G] f64 chunk temporaries for the column-pass tier
_LANE_CHOL_TEMP_BYTES = 768 * 1024 * 1024

# memory budget for materialized chunk temporaries ([C, K, K, G] f64)
_CHUNK_BYTES = 128 * 1024 * 1024
# refined-SM per-lane state: K^2 * (4B f32 P + 8B f64 A) + vectors
_SM_STATE_BYTES = 256 * 1024 * 1024


def _pow2(c: int) -> int:
    return 1 << (max(8, c).bit_length() - 1)


def _chol_chunk(K: int, G: int) -> int:
    c = _CHUNK_BYTES // max(1, K * K * G * 8)
    c = min(c, max(8, (1 << 19) // max(1, K * K)))
    return _pow2(min(512, c))


def _sm_chunk(R: int, ln_inv_ff: float = 0.0, K: int = 1) -> int:
    c = min(512, R)
    # per-chunk element cap (chunk * K^2 <= 2^19), the same limit the
    # classic kernels respect (engine/fit.py _pick_chunk)
    c = min(c, max(8, (1 << 19) // max(1, K * K)))
    if ln_inv_ff > 0.0:
        # under discounting the f32 P-state's drift is amplified by ff^-t
        # within a chunk (measured: chunk=512 at half-life 30 drifts to
        # ~3e-4; chunk=128 holds ~3e-11). Cap the amplification at e^4 —
        # ~6 half-lives, beyond which the state has forgotten the chunk
        # start anyway, so shorter chunks cost nothing statistically.
        c = min(c, max(8, int(4.0 / ln_inv_ff)))
    return _pow2(c)


def _use_lane_chol(K: int, G: int) -> bool:
    if K <= LANE_CHOL_UNROLL_MAX_K:
        return True
    if K > LANE_CHOL_MAX_K:
        return False
    # column-pass tier: chunk temporaries [C, K, K, G] f64 must fit
    return _chol_chunk(K, G) * K * K * G * 8 <= _LANE_CHOL_TEMP_BYTES


def lanes_applicable(
    G: int, R: int, K: int, half_life=None, rolling: bool = False
) -> bool:
    """Whether the lane kernels fit this shape within memory budgets."""
    if _use_lane_chol(K, G):
        return True
    ln_inv_ff = 0.0
    if half_life:
        ln_inv_ff = math.log(2.0) / half_life
    C = (
        min(_sm_chunk(R, ln_inv_ff, K), 256)
        if rolling
        else _sm_chunk(R, ln_inv_ff, K)
    )
    n_chunks = -(-R // C)
    # per-lane scan state: K^2 P (f32 for RLS, f64 for rolling) + K^2 f64 A
    per_lane = (16 if rolling else 12) * K * K
    return G * n_chunks * per_lane <= _SM_STATE_BYTES


def lanes_group_block(
    G: int, R: int, K: int, half_life=None, rolling: bool = False
) -> int:
    """Largest group-block size for which the lane kernels fit when the
    whole batch does not — grouped moving models at large K keep the fast
    refined-SM path by scanning the group batch in sequential blocks."""
    if lanes_applicable(G, R, K, half_life, rolling):
        return G
    gb = 1 << (G.bit_length() - 1)
    while gb >= 16:
        if lanes_applicable(gb, R, K, half_life, rolling):
            return gb
        gb >>= 1
    return 0


# --------------------------------------------------------------------------- #
# unrolled lane Cholesky (ops elementwise over [..., G] lanes)
# --------------------------------------------------------------------------- #
def _lane_chol_solve_colpass(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Column-pass right-looking variant of `_lane_chol_solve` for mid-K
    (17..32): ~11K ops on shrinking [..., K-j, G] submatrix slices instead
    of the fully unrolled ~K^3/6 scalar-lane ops (which stop paying for
    themselves past K~16 on a backend with per-op launch cost). Same
    contract: exact f64, NaN lanes on non-PD systems."""
    K = A.shape[-3]
    S = A
    inv_d = []  # [..., G] reciprocal diagonal of L, per column
    cols = []  # [..., K-1-j, G] subdiagonal of L column j
    for j in range(K):
        d = jnp.sqrt(S[..., 0, 0, :])
        dj = 1.0 / d
        col = S[..., 1:, 0, :] * dj[..., None, :]
        inv_d.append(dj)
        cols.append(col)
        if j < K - 1:
            S = S[..., 1:, 1:, :] - col[..., :, None, :] * col[..., None, :, :]
    # forward substitution L z = b, column-oriented
    z = []
    rem = b
    for j in range(K):
        zj = rem[..., 0, :] * inv_d[j]
        z.append(zj)
        if j < K - 1:
            rem = rem[..., 1:, :] - cols[j] * zj[..., None, :]
    # back substitution L^T x = z: x_j = (z_j - cols[j] . x_{j+1:}) / d_j
    x = [None] * K
    for j in range(K - 1, -1, -1):
        s = z[j]
        if j < K - 1:
            tail = jnp.stack(x[j + 1 :], axis=-2)  # [..., K-1-j, G]
            s = s - (cols[j] * tail).sum(axis=-2)
        x[j] = s * inv_d[j]
    return jnp.stack(x, axis=-2)  # [..., K, G]


def _lane_chol_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b with A [..., K, K, G] PD and b [..., K, G].

    Fully unrolled over K: every op is elementwise on [..., G]-shaped
    arrays, so each op runs over all G lanes at once. Non-PD lanes produce NaN
    (callers mask undefined rows; regularized systems are PD by
    construction). Mid-K systems route to the column-pass variant."""
    K = A.shape[-3]
    if K > LANE_CHOL_UNROLL_MAX_K:
        return _lane_chol_solve_colpass(A, b)
    a = [[A[..., i, j, :] for j in range(i + 1)] for i in range(K)]
    L = [[None] * (i + 1) for i in range(K)]
    inv_d = [None] * K
    for j in range(K):
        s = a[j][j]
        for m in range(j):
            s = s - L[j][m] * L[j][m]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv_d[j] = 1.0 / d
        for i in range(j + 1, K):
            s = a[i][j]
            for m in range(j):
                s = s - L[i][m] * L[j][m]
            L[i][j] = s * inv_d[j]
    bb = [b[..., i, :] for i in range(K)]
    z = [None] * K
    for i in range(K):
        s = bb[i]
        for m in range(i):
            s = s - L[i][m] * z[m]
        z[i] = s * inv_d[i]
    x = [None] * K
    for i in range(K - 1, -1, -1):
        s = z[i]
        for m in range(i + 1, K):
            s = s - L[m][i] * x[m]
        x[i] = s * inv_d[i]
    return jnp.stack(x, axis=-2)  # [..., K, G]


# --------------------------------------------------------------------------- #
# lane-chol drivers (sequential chunk scan, exact f64)
# --------------------------------------------------------------------------- #
def _rls_lane_chol(X, y, v, ff: float, inv_cov: float, mean0, chunk: int):
    """X [R, K, G] valid-masked, y [R, G], v [R, G]; returns [R, K, G]."""
    R, K, G = X.shape
    n_chunks = R // chunk
    discounted = ff != 1.0
    lam = jnp.where(v, ff, 1.0) if discounted else None
    eye = jnp.eye(K, dtype=F64)[None, :, :, None]

    def body(carry, idx):
        disc_c, M_c, b_c = carry
        Xc = lax.dynamic_slice_in_dim(X, idx * chunk, chunk)  # [C, K, G]
        yc = lax.dynamic_slice_in_dim(y, idx * chunk, chunk)  # [C, G]
        Uc = Xc[:, :, None, :] * Xc[:, None, :, :]  # [C, K, K, G]
        uc = Xc * yc[:, None, :]  # [C, K, G]
        if discounted:
            lamc = lax.dynamic_slice_in_dim(lam, idx * chunk, chunk)
            drel = jnp.cumprod(lamc, axis=0)  # [C, G]
            inv_drel = 1.0 / drel
            M_t = drel[:, None, None, :] * (
                M_c[None] + jnp.cumsum(Uc * inv_drel[:, None, None, :], axis=0)
            )
            b_t = drel[:, None, :] * (
                b_c[None] + jnp.cumsum(uc * inv_drel[:, None, :], axis=0)
            )
            disc_t = disc_c[None] * drel
        else:
            M_t = M_c[None] + jnp.cumsum(Uc, axis=0)
            b_t = b_c[None] + jnp.cumsum(uc, axis=0)
            disc_t = jnp.broadcast_to(disc_c, (chunk, G))
        prior = disc_t * inv_cov  # [C, G]
        A_t = M_t + prior[:, None, None, :] * eye
        rhs = b_t + prior[:, None, :] * mean0[None, :, None]
        coef = _lane_chol_solve(A_t, rhs)  # [C, K, G]
        return (disc_t[-1], M_t[-1], b_t[-1]), coef

    carry0 = (jnp.ones(G, F64), jnp.zeros((K, K, G), F64), jnp.zeros((K, G), F64))
    _, coefs = lax.scan(body, carry0, jnp.arange(n_chunks))
    return coefs.reshape(R, K, G)


def _rolling_lane_chol(Xv, yv, Xs, ys, reg, chunk: int):
    """Streams [R, K, G] / [R, G]; reg [G]; returns [R, K, G]."""
    R, K, G = Xv.shape
    n_chunks = R // chunk
    eye = jnp.eye(K, dtype=F64)[None, :, :, None]

    def body(carry, idx):
        W_c, b_c = carry
        Xa = lax.dynamic_slice_in_dim(Xv, idx * chunk, chunk)
        ya = lax.dynamic_slice_in_dim(yv, idx * chunk, chunk)
        Xl = lax.dynamic_slice_in_dim(Xs, idx * chunk, chunk)
        yl = lax.dynamic_slice_in_dim(ys, idx * chunk, chunk)
        dU = Xa[:, :, None, :] * Xa[:, None, :, :] - Xl[:, :, None, :] * Xl[:, None, :, :]
        du = Xa * ya[:, None, :] - Xl * yl[:, None, :]
        W_t = W_c[None] + jnp.cumsum(dU, axis=0)
        b_t = b_c[None] + jnp.cumsum(du, axis=0)
        coef = _lane_chol_solve(W_t + reg[None, None, None, :] * eye, b_t)
        return (W_t[-1], b_t[-1]), coef

    carry0 = (jnp.zeros((K, K, G), F64), jnp.zeros((K, G), F64))
    _, coefs = lax.scan(body, carry0, jnp.arange(n_chunks))
    return coefs.reshape(R, K, G)


# --------------------------------------------------------------------------- #
# refined-SM path: f32 P-state + f64 regularized moments + refinement
# --------------------------------------------------------------------------- #
def _mv64(M: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """[L, K, K] x [L, K] matvec as elementwise+reduce, which fuses into
    the scan body (and is exact f64: no matmul precision setting applies)."""
    return (M * c[:, None, :]).sum(axis=-1)


def _chol_inverse_small_batch(A: jnp.ndarray) -> jnp.ndarray:
    """Exact f64 inverse of a small batch of PD matrices [L, K, K] using the
    vectorized O(K)-pass Cholesky (no XLA custom call). One-time seed cost,
    off the per-row path."""
    from .linalg import _chol_solve_vectorized

    K = A.shape[-1]
    inv, _ = _chol_solve_vectorized(A, jnp.broadcast_to(jnp.eye(K, dtype=F64), A.shape))
    return inv


def _refined_sm_scan(xs_add, xs_sub, lam, P0, A0, b0, c0, rolling: bool,
                     p_dtype=F32):
    """Core lane scan; returns [C, L, K] coefficient rows.

    xs_add = (X [C,L,K] f64 valid-masked, y [C,L]); xs_sub likewise for the
    rolling leaving-row stream (None for RLS). A follows the exact f64
    recursion (discounted: A_t = lam A + x x', which folds the prior —
    exactly the system the reference's Kalman P inverts,
    src/least_squares.rs:531-540; rolling: A_t = A + x x' - xs xs').

    ``p_dtype`` is the Sherman-Morrison P-state precision. RLS keeps f32
    (benign Bayesian priors, ~1e-9 measured agreement); rolling uses f64 —
    its chunk-0 seed is the diffuse I/reg (~1e10), whose SM warm-up cancels
    catastrophically in f32 but holds ~1e-6 relative in f64, after which
    the exact-moment
    refinement contracts the error to ~1e-12."""
    X, y = xs_add
    lowp = p_dtype == F32
    scan_in = ([X.astype(F32)] if lowp else []) + [X, y]
    if rolling:
        Xs, ys = xs_sub
        scan_in += ([Xs.astype(F32)] if lowp else []) + [Xs, ys]
    if lam is not None:
        scan_in.append(lam)

    def body(carry, xs):
        P, A, b, coef = carry
        if lowp:
            xp, x64, yt = xs[0], xs[1], xs[2]
            rest = xs[3:]
        else:
            x64, yt = xs[0], xs[1]
            xp = x64
            rest = xs[2:]
        lam_t = xs[-1] if lam is not None else None
        # --- P: Sherman-Morrison (+ guarded downdate for rolling) ---
        Px = (P * xp[:, None, :]).sum(axis=-1)
        if lam_t is not None:
            ffv = lam_t.astype(p_dtype)
            r = ffv + (xp * Px).sum(-1)
            P = (P - Px[:, :, None] * (Px / r[:, None])[:, None, :]) / ffv[:, None, None]
        else:
            r = 1.0 + (xp * Px).sum(-1)
            P = P - Px[:, :, None] * (Px / r[:, None])[:, None, :]
        if rolling:
            if lowp:
                xsp, xs64, yst = rest[0], rest[1], rest[2]
            else:
                xs64, yst = rest[0], rest[1]
                xsp = xs64
            Ps = (P * xsp[:, None, :]).sum(axis=-1)
            den = 1.0 - (xsp * Ps).sum(-1)
            # singular leaving rows: skip the downdate — P degrades to a
            # stale preconditioner; the f64 refinement below keeps the
            # coefficients correct (the old guard substituted den=1 and
            # silently produced a wrong inverse)
            safe = den > 1e-6
            upd = Ps[:, :, None] * (Ps / jnp.where(safe, den, 1.0)[:, None])[:, None, :]
            P = jnp.where(safe[:, None, None], P + upd, P)
        else:
            xs64 = yst = None
        # --- exact f64 state ---
        if lam_t is not None:
            A = A * lam_t[:, None, None] + x64[:, :, None] * x64[:, None, :]
            b = b * lam_t[:, None] + x64 * yt[:, None]
        elif rolling:
            A = A + x64[:, :, None] * x64[:, None, :] - xs64[:, :, None] * xs64[:, None, :]
            b = b + x64 * yt[:, None] - xs64 * yst[:, None]
        else:
            A = A + x64[:, :, None] * x64[:, None, :]
            b = b + x64 * yt[:, None]
        # --- refined coefficient (P is only a preconditioner) ---
        c = coef
        for _ in range(2):
            resid = b - _mv64(A, c)
            c = c + (P * resid.astype(p_dtype)[:, None, :]).sum(axis=-1).astype(F64)
        return (P, A, b, c), c

    (_, _, _, _), coefs = lax.scan(body, (P0, A0, b0, c0), tuple(scan_in))
    return coefs


def _to_lanes(a: jnp.ndarray, G: int, n_chunks: int, C: int) -> jnp.ndarray:
    """[R, ..., G] -> [C, L, ...] with lane l = g * n_chunks + c."""
    if a.ndim == 3:
        K = a.shape[1]
        return (
            a.transpose(2, 0, 1)
            .reshape(G, n_chunks, C, K)
            .transpose(2, 0, 1, 3)
            .reshape(C, G * n_chunks, K)
        )
    return a.transpose(1, 0).reshape(G, n_chunks, C).transpose(2, 0, 1).reshape(C, G * n_chunks)


def _from_lanes(coefs: jnp.ndarray, G: int, n_chunks: int, C: int) -> jnp.ndarray:
    """[C, L, K] -> [R, K, G]."""
    K = coefs.shape[-1]
    return (
        coefs.reshape(C, G, n_chunks, K)
        .transpose(1, 2, 0, 3)
        .reshape(G, n_chunks * C, K)
        .transpose(1, 2, 0)
    )


def _seed_prefix(summaries, carry0, step):
    """Tiny sequential prefix over per-chunk summaries: returns the carried
    state at each chunk START. summaries: tuple of [n_chunks, G, ...]."""

    def body(carry, cs):
        return step(carry, cs), carry

    _, starts = lax.scan(body, carry0, summaries)
    return starts


def _finite_or_zero(P32: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(jnp.isfinite(P32), P32, 0.0)


def _rls_refined_sm(X, y, v, ff: float, inv_cov: float, mean0, chunk: int):
    """X [R, K, G] valid-masked; returns [R, K, G]."""
    R, K, G = X.shape
    C = chunk
    n_chunks = R // C
    L = G * n_chunks
    discounted = ff != 1.0
    eye = jnp.eye(K, dtype=F64)

    Xl = _to_lanes(X, G, n_chunks, C)
    yl = _to_lanes(y, G, n_chunks, C)
    lam_l = None
    if discounted:
        lam_l = _to_lanes(jnp.where(v, ff, 1.0), G, n_chunks, C)
        drel = jnp.cumprod(lam_l, axis=0)  # [C, L]
        inv_drel = 1.0 / drel
        S = jnp.einsum("cl,clk,clm->lkm", inv_drel, Xl, Xl, preferred_element_type=F64)
        s = jnp.einsum("cl,clk,cl->lk", inv_drel, Xl, yl, preferred_element_type=F64)
        d_end = drel[-1]
        S = S * d_end[:, None, None]
        s = s * d_end[:, None]
    else:
        S = jnp.einsum("clk,clm->lkm", Xl, Xl, preferred_element_type=F64)
        s = jnp.einsum("clk,cl->lk", Xl, yl, preferred_element_type=F64)
        d_end = jnp.ones(L, F64)

    def lane2chunks(a):  # [L, ...] -> [n_chunks, G, ...]
        return a.reshape((G, n_chunks) + a.shape[1:]).swapaxes(0, 1)

    def step(carry, cs):
        M_c, b_c, disc_c = carry
        S_c, s_c, de = cs
        return (
            de[:, None, None] * M_c + S_c,
            de[:, None] * b_c + s_c,
            disc_c * de,
        )

    carry0 = (jnp.zeros((G, K, K), F64), jnp.zeros((G, K), F64), jnp.ones(G, F64))
    M_st, b_st, disc_st = _seed_prefix(
        (lane2chunks(S), lane2chunks(s), lane2chunks(d_end)), carry0, step
    )

    def chunks2lane(a):  # [n_chunks, G, ...] -> [L, ...]
        return a.swapaxes(0, 1).reshape((L,) + a.shape[2:])

    M_st, b_st, disc_st = chunks2lane(M_st), chunks2lane(b_st), chunks2lane(disc_st)
    prior = disc_st * inv_cov
    A0 = M_st + prior[:, None, None] * eye
    rhs0 = b_st + prior[:, None] * mean0[None, :]
    P0 = _chol_inverse_small_batch(A0)
    c0 = _mv64(P0, rhs0)
    coefs = _refined_sm_scan(
        (Xl, yl), None, lam_l, _finite_or_zero(P0.astype(F32)), A0, rhs0, c0,
        rolling=False,
    )
    return _from_lanes(coefs, G, n_chunks, C)


def _rolling_refined_sm(Xv, yv, Xs, ys, reg, chunk: int):
    """Streams [R, K, G] / [R, G]; reg [G]; returns [R, K, G]."""
    R, K, G = Xv.shape
    C = chunk
    n_chunks = R // C
    L = G * n_chunks
    eye = jnp.eye(K, dtype=F64)

    Xa = _to_lanes(Xv, G, n_chunks, C)
    ya = _to_lanes(yv, G, n_chunks, C)
    Xl = _to_lanes(Xs, G, n_chunks, C)
    yl = _to_lanes(ys, G, n_chunks, C)

    dS = (
        jnp.einsum("clk,clm->lkm", Xa, Xa, preferred_element_type=F64)
        - jnp.einsum("clk,clm->lkm", Xl, Xl, preferred_element_type=F64)
    )
    ds = (
        jnp.einsum("clk,cl->lk", Xa, ya, preferred_element_type=F64)
        - jnp.einsum("clk,cl->lk", Xl, yl, preferred_element_type=F64)
    )

    def lane2chunks(a):
        return a.reshape((G, n_chunks) + a.shape[1:]).swapaxes(0, 1)

    def step(carry, cs):
        W_c, b_c = carry
        dW, db = cs
        return (W_c + dW, b_c + db)

    carry0 = (jnp.zeros((G, K, K), F64), jnp.zeros((G, K), F64))
    W_st, b_st = _seed_prefix((lane2chunks(dS), lane2chunks(ds)), carry0, step)
    W_st = W_st.swapaxes(0, 1).reshape(L, K, K)
    b_st = b_st.swapaxes(0, 1).reshape(L, K)
    reg_l = jnp.broadcast_to(reg[:, None], (G, n_chunks)).reshape(L)

    A0 = W_st + reg_l[:, None, None] * eye
    P0 = _chol_inverse_small_batch(A0)
    c0 = _mv64(P0, b_st)
    # f64 P throughout: chunk 0 seeds from the diffuse I/reg (~1e10), whose
    # SM warm-up is stable at f64 (and would cancel catastrophically at
    # f32); later chunks seed from exact well-conditioned f64 inverses.
    # (Earlier revisions carried f32 P and recomputed chunk 0 with an exact
    # per-row direct pass — ~4K column passes per group block, which is
    # what kept this kernel off the grouped large-K configs.)
    coefs = _refined_sm_scan(
        (Xa, ya), (Xl, yl), None, _finite_or_zero(P0), A0, b_st, c0,
        rolling=True, p_dtype=F64,
    )
    return _from_lanes(coefs, G, n_chunks, C)  # [R, K, G]


# --------------------------------------------------------------------------- #
# public entry points (same contracts as ops.recursive / ops.rolling)
# --------------------------------------------------------------------------- #
@partial(
    jax.jit,
    static_argnames=("half_life", "initial_state_covariance", "initial_state_mean"),
)
def solve_recursive_lanes(
    Xp: jnp.ndarray,  # [G, R, K] zero-filled
    yp: jnp.ndarray,  # [G, R]
    vp: jnp.ndarray,  # [G, R] bool
    half_life: Optional[float],
    initial_state_covariance: float,
    initial_state_mean: Optional[Tuple[float, ...]],
) -> jnp.ndarray:
    """Lane-major batched RLS coefficient paths [G, R, K]; semantics match
    ops.recursive.solve_recursive_least_squares (reference
    src/least_squares.rs:494-598: invalid rows leave the state untouched so
    coefficients forward-fill; rows before the first valid observation
    yield exactly mean0)."""
    G, R, K = Xp.shape
    ff = math.exp(math.log(0.5) / half_life) if half_life else 1.0
    c = 10.0 if initial_state_covariance is None else initial_state_covariance
    inv_cov = 1.0 / c
    if initial_state_mean is None:
        mean0 = jnp.zeros(K, dtype=F64)
    else:
        m = jnp.asarray(initial_state_mean, dtype=F64)
        mean0 = jnp.broadcast_to(m, (K,)) if m.ndim else jnp.full(K, m, dtype=F64)

    ln_inv_ff = math.log(1.0 / ff) if ff < 1.0 else 0.0
    chunk = (
        _chol_chunk(K, G) if _use_lane_chol(K, G) else _sm_chunk(R, ln_inv_ff, K)
    )
    if ln_inv_ff > 0.0:
        chunk = min(chunk, _pow2(max(8, int(600.0 / ln_inv_ff))))
    pad = (-R) % chunk
    if pad:
        Xp = jnp.pad(Xp, ((0, 0), (0, pad), (0, 0)))
        yp = jnp.pad(yp, ((0, 0), (0, pad)))
        vp = jnp.pad(vp, ((0, 0), (0, pad)))

    vf = vp.astype(F64)
    X = (Xp * vf[..., None]).transpose(1, 2, 0)  # [Rp, K, G]
    y = (yp * vf).transpose(1, 0)
    v = vp.transpose(1, 0)

    if _use_lane_chol(K, G):
        coefs = _rls_lane_chol(X, y, v, ff, inv_cov, mean0, chunk)
    else:
        coefs = _rls_refined_sm(X, y, v, ff, inv_cov, mean0, chunk)
    return coefs.transpose(2, 0, 1)[:, :R]  # [G, R, K]


@partial(jax.jit, static_argnames=("window", "min_periods", "alpha", "positional"))
def solve_rolling_lanes(
    Xp: jnp.ndarray,  # [G, R, K] zero-filled
    yp: jnp.ndarray,  # [G, R]
    vp: jnp.ndarray,  # [G, R] bool
    window: int,
    min_periods: Optional[int],
    alpha: float,
    positional: bool,
) -> jnp.ndarray:
    """Lane-major batched rolling-OLS coefficient paths [G, R, K]; both
    window semantics of the reference (src/least_squares.rs:947-1029):
    positional ('drop_window', statsmodels missing='drop' parity incl.
    forward-fill across undefined gaps) and valid-rank windows (the drop
    family)."""
    G, R, K = Xp.shape
    if min_periods is None:
        min_periods = min(K, window)

    # 256-row chunks bound the f64 P+A scan state per lane while keeping
    # the sequential depth short (total steps across group blocks are
    # invariant in C; smaller C trades state for lanes)
    chunk = (
        _chol_chunk(K, G) if _use_lane_chol(K, G) else min(_sm_chunk(R, K=K), 256)
    )
    pad = (-R) % chunk
    if pad:
        Xp = jnp.pad(Xp, ((0, 0), (0, pad), (0, 0)))
        yp = jnp.pad(yp, ((0, 0), (0, pad)))
        vp = jnp.pad(vp, ((0, 0), (0, pad)))
    Rp = R + pad

    vf = vp.astype(F64)
    X = (Xp * vf[..., None]).transpose(1, 2, 0)  # [Rp, K, G]
    y = (yp * vf).transpose(1, 0)
    v = vp.transpose(1, 0)
    t = jnp.arange(Rp)
    r = jnp.cumsum(v.astype(jnp.int64), axis=0)  # [Rp, G] 1-based valid rank

    w_eff = min(window, Rp)
    if positional:
        # the leaving row is row t-window: a shifted slice, no gather
        zpadX = jnp.zeros((w_eff, K, G), F64)
        zpady = jnp.zeros((w_eff, G), F64)
        Xs = jnp.concatenate([zpadX, X[: Rp - w_eff]], axis=0)
        ys = jnp.concatenate([zpady, y[: Rp - w_eff]], axis=0)
        r_shift = jnp.concatenate(
            [jnp.zeros((w_eff, G), jnp.int64), r[: Rp - w_eff]], axis=0
        )
        count_w = r - r_shift
        defined = count_w >= min_periods
    else:
        # valid-rank window: the leaving row is the valid row of rank
        # r_t - window; rank -> row-index map built with one scatter
        lanes = jnp.broadcast_to(jnp.arange(G), (Rp, G))
        trow = jnp.broadcast_to(t[:, None], (Rp, G))
        rank_pos = (
            jnp.zeros((Rp + 2, G), jnp.int64)
            .at[jnp.where(v, r, Rp + 1), lanes]
            .set(trow)
        )
        sub_rank = r - window
        sub_on = v & (sub_rank >= 1)
        sub_idx = jnp.take_along_axis(rank_pos, jnp.clip(sub_rank, 0, Rp + 1), axis=0)
        so = sub_on.astype(F64)
        Xs = jnp.take_along_axis(X, sub_idx[:, None, :], axis=0) * so[:, None, :]
        ys = jnp.take_along_axis(y, sub_idx, axis=0) * so
        defined = r >= min_periods

    if alpha > 0.0:
        reg = jnp.full(G, alpha, F64)
    else:
        # diffuse prior ~1e-10 of the data scale per lane (plays the role of
        # the reference's exact warm-up inversion; relative coef error ~reg)
        scale = jnp.maximum(jnp.mean(X * X, axis=(0, 1)) * w_eff, 1e-300)
        reg = scale * 1e-10

    if _use_lane_chol(K, G):
        coefs = _rolling_lane_chol(X, y, Xs, ys, reg, chunk)  # [Rp, K, G]
    else:
        coefs = _rolling_refined_sm(X, y, Xs, ys, reg, chunk)

    coefs = jnp.where(defined[:, None, :], coefs, jnp.nan)
    if positional:
        # carry the last refreshed estimate across undefined gaps via a
        # last-defined associative scan — O(log R) elementwise passes
        # instead of an [R*K*G]-element gather
        def last_defined(a, b):
            ca, da = a
            cb, db = b
            return jnp.where(db, cb, ca), da | db

        d1 = defined[:, None, :]  # [R, 1, G], broadcasts over K
        filled, seen = lax.associative_scan(
            last_defined, (jnp.where(d1, coefs, 0.0), d1), axis=0
        )
        coefs = jnp.where(seen, filled, jnp.nan)
    return coefs.transpose(2, 0, 1)[:, :R]
