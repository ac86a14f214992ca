"""Least-squares evaluation engine — the device equivalent of the reference's
plugin entry points (src/expressions.rs:390-741).

Every model is evaluated as ONE batched JAX program over all groups at once:
host-side layout planning (group factorization, padded/split-padded gather
indices) feeds jitted kernels that accumulate moments with batched matmuls and
solve per group (or per row, for moving-window models) with batched
factorizations.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

from ..config import CONFIG
import jax
import jax.numpy as jnp
from jax import lax

from ..series import Series, StatisticsSeries, StructSeries
from ..ops import masking
from ..ops.cd import solve_elastic_net_cov
from ..ops.direct import (
    grouped_moments,
    resolve_solve_method,
    solve_from_rows,
)
from ..ops.linalg import solve_psd, solve_psd_cond
from ..ops.recursive import solve_recursive_least_squares
from ..ops.rolling import solve_rolling_ols
from ..ops.statistics import feature_metrics, residual_metrics
from .groups import register_cache_owner, single_layout

F64 = jnp.float64


# --------------------------------------------------------------------------- #
# layout helpers
# --------------------------------------------------------------------------- #
def _pad_rows(layout, arrays, mask):
    """Gather [N, ...] arrays into fully padded [G, R, ...] layouts.

    Returns (padded_arrays, combined_mask) where the mask ANDs padding
    validity with the supplied row mask.
    """
    if layout.num_groups == 1:
        return [a[None] for a in arrays], mask[None]
    g, pmask, R = layout.device_padded()
    padded = [
        jnp.take(a, g, axis=0).reshape((layout.num_groups, R) + a.shape[1:])
        for a in arrays
    ]
    pm = pmask & jnp.take(mask, g).reshape(layout.num_groups, R)
    return padded, pm


def _unpad_rows(layout, padded: jnp.ndarray) -> jnp.ndarray:
    """Scatter a padded [G, R, ...] per-row result back to row order [N, ...]."""
    if layout.num_groups == 1:
        return padded[0]
    G, R = padded.shape[:2]
    flat = padded.reshape((G * R,) + padded.shape[2:])
    return jnp.take(flat, layout.device_unpad(R), axis=0)


def _split_layout(layout):
    from .groups import bucket_size

    # bucketed block width: one compiled program serves every max-group-size
    # in the bucket (shape bucketing, <=12.5% pad waste)
    r_cap = min(
        CONFIG.moment_chunk_rows, bucket_size(max(8, int(layout.counts.max())))
    )
    return layout.device_split(r_cap)


def _moments(layout, X, y, w):
    """Per-group XtX/Xty/counts via the split-padded block layout: heavy groups
    are split into row blocks whose partial moments are segment-summed."""
    g, pmask, block_group, S = _split_layout(layout)
    r_cap = pmask.shape[1]
    Xp = jnp.take(X, g, axis=0).reshape((S, r_cap, X.shape[1]))
    yp = jnp.take(y, g, axis=0).reshape((S, r_cap) + y.shape[1:])
    wp = pmask & jnp.take(w, g).reshape(S, r_cap)
    return grouped_moments(Xp, yp, wp, block_group, layout.num_groups)


def _gather_per_row(layout, per_group: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(per_group, layout.device_gids(), axis=0)


# --------------------------------------------------------------------------- #
# fused static fit + predict (normal-equation path)
# --------------------------------------------------------------------------- #
@partial(jax.jit, static_argnames=("num_groups", "policy", "want", "force_refine", "lu"))
def _chol_fit_kernel(
    vals,  # [N, 1+K] target column 0, features 1..K (raw values)
    valid,  # [N, 1+K] bool validity, or None when fully valid
    gather,  # [S*R] split-padded gather map (None when num_groups == 1)
    pmask,  # [S, R]
    block_group,  # [S]
    gids,  # [N] int32
    num_groups: int,
    alpha: float,
    policy: str,
    want: str,  # "beta" | "rows" | "preds"
    force_refine: bool = False,  # explicit 'qr': unconditional CSNE sweeps
    lu: bool = False,  # explicit 'lu': partial-pivot elimination, no CSNE
):
    """One fused device program for grouped normal-equation fits:
    null-policy masking -> single padded gather -> moment matmuls ->
    segment-sum merge -> vectorized batched Cholesky (eigh fallback) ->
    per-row coefficient gather -> predictions. A single program per call
    pays one dispatch, and packing target + mask next to the features
    means ONE row gather instead of three."""
    K = vals.shape[1] - 1
    if valid is None:
        y_fit, X_fit = vals[:, 0], vals[:, 1:]
        fit_mask = None  # all rows valid
        X_pred, predict_valid = X_fit, None
    else:
        problem = masking.prepare_problem(
            policy, vals[:, 0], valid[:, 0], vals[:, 1:], valid[:, 1:]
        )
        y_fit, X_fit, fit_mask = problem.y, problem.X, problem.fit_mask
        X_pred, predict_valid = problem.X_predict, problem.predict_valid

    if num_groups == 1:
        wf1 = (
            jnp.ones((1, X_fit.shape[0]), F64)
            if fit_mask is None
            else fit_mask.astype(F64)[None]
        )
        Xm = X_fit * wf1[0][:, None]
        XtX = jnp.einsum("nk,nl->kl", Xm, X_fit, preferred_element_type=F64)[None]
        Xty = jnp.einsum("nk,n->k", Xm, y_fit, preferred_element_type=F64)[None]
        refine = (X_fit[None], y_fit[None], wf1, jnp.zeros(1, jnp.int32), 1)
    else:
        S, R = pmask.shape
        cols = [X_fit, y_fit[:, None]]
        if fit_mask is not None:
            cols.append(fit_mask[:, None].astype(F64))
        Z = jnp.concatenate(cols, axis=1)
        Zp = jnp.take(Z, gather, axis=0).reshape((S, R, Z.shape[1]))
        Xp, yp = Zp[..., :K], Zp[..., K]
        wp = pmask if fit_mask is None else pmask & (Zp[..., K + 1] > 0.5)
        XtX, Xty, _ = grouped_moments(Xp, yp, wp, block_group, num_groups)
        refine = (Xp, yp, wp.astype(F64), block_group, num_groups)

    A = XtX + jnp.asarray(alpha, F64) * jnp.eye(K, dtype=F64)
    if lu:
        from ..ops.linalg import solve_lu

        beta = solve_lu(A, Xty)
    elif force_refine:
        beta = _csne_refine_blocks(A, solve_psd(A, Xty), *refine, alpha)
    else:
        beta, cond_est = solve_psd_cond(A, Xty)
        beta = lax.cond(
            jnp.max(cond_est) > _COND_REFINE,
            lambda b: _csne_refine_blocks(A, b, *refine, alpha),
            lambda b: b,
            beta,
        )
    if want == "beta":
        return beta
    coef_rows = (
        jnp.broadcast_to(beta[0], X_pred.shape)
        if num_groups == 1
        else jnp.take(beta, gids, axis=0)
    )
    if want == "rows":
        return coef_rows
    preds = jnp.einsum("nk,nk->n", X_pred, coef_rows)
    return preds, predict_valid


# ---- steady-state block pipeline: materialized partition + fit kernel ---- #
@partial(jax.jit, static_argnames=("policy", "S", "R"))
def _build_blocks(vals, valid, gather, pmask, policy: str, S: int, R: int):
    """Materialize the split-padded partition of a query's columns (run once
    per (columns, layout, policy); cached). Returns (Zp [S,R,1+K] with the
    target in slot 0, wp [S,R] fit mask, predict_valid [N] or None)."""
    if valid is None:
        Zp = jnp.take(vals, gather, axis=0).reshape((S, R, vals.shape[1]))
        return Zp, pmask, None
    problem = masking.prepare_problem(
        policy, vals[:, 0], valid[:, 0], vals[:, 1:], valid[:, 1:]
    )
    Z = jnp.concatenate(
        [problem.y[:, None], problem.X, problem.fit_mask[:, None].astype(F64)],
        axis=1,
    )
    Zp = jnp.take(Z, gather, axis=0).reshape((S, R, Z.shape[1]))
    wp = pmask & (Zp[..., -1] > 0.5)
    return Zp[..., :-1], wp, problem.predict_valid


@partial(jax.jit, static_argnames=("policy", "G", "R", "moving"))
def _build_padded_layout(
    vals, valid, gather, pmask, policy: str, G: int, R: int, moving: bool
):
    """Materialize the fully padded [G, R] layout (run once per (columns,
    layout, policy); cached): null-policy masking + ONE row gather of the
    packed [target, features, mask] matrix instead of three separate
    gathers per query. ``moving`` selects the moving-window masking
    semantics (zero-filled fit with validity carried separately,
    src/expressions.rs:656,683)."""
    K = vals.shape[1] - 1
    if valid is None:
        y_z, X_z = vals[:, 0], vals[:, 1:]
        vmask = jnp.ones(vals.shape[0], dtype=bool)
        predict_valid = None
    else:
        problem = masking.prepare_problem(
            policy, vals[:, 0], valid[:, 0], vals[:, 1:], valid[:, 1:],
            moving=moving,
        )
        y_z, X_z, vmask = problem.y, problem.X, problem.fit_mask
        predict_valid = problem.predict_valid
    if G == 1:
        return X_z[None], y_z[None], vmask[None], predict_valid
    Z = jnp.concatenate(
        [y_z[:, None], X_z, vmask[:, None].astype(F64)], axis=1
    )
    Zp = jnp.take(Z, gather, axis=0).reshape((G, R, K + 2))
    vp = pmask & (Zp[..., -1] > 0.5)
    return Zp[..., 1 : K + 1], Zp[..., 0], vp, predict_valid


def _padded_cached(layout, vals, valid, policy: str, moving: bool):
    """Padded-layout cache (LRU of 2, like `_blocks_cached`): steady-state
    moving-window and row-space (SVD) queries skip the null-policy pass and
    the [N -> G x R] gather entirely."""
    G = layout.num_groups
    if G == 1:
        gather, pmask, R = None, None, vals.shape[0]
    else:
        gather, pmask, R = layout.device_padded()
    key = ("movpad", id(vals), id(valid), policy, moving)
    if key not in layout._dev:
        out = _build_padded_layout(vals, valid, gather, pmask, policy, G, R, moving)
        mov_keys = [k_ for k_ in layout._dev if isinstance(k_, tuple) and k_[0] == "movpad"]
        if len(mov_keys) >= 2:
            del layout._dev[mov_keys[0]]
        layout._dev[key] = out + (vals, valid)
    entry = layout._dev.pop(key)
    layout._dev[key] = entry
    return entry[0], entry[1], entry[2], entry[3]


def _moving_cached(layout, vals, valid, policy: str):
    return _padded_cached(layout, vals, valid, policy, moving=True)


def _block_preds(Xp, beta_blocks):
    """Block predictions as unrolled elementwise multiply-adds: the tiny
    K-contraction becomes K fused multiply-adds, one elementwise pass over
    the rows, in place of a batched matmul with a K-wide contraction."""
    K = Xp.shape[-1]
    acc = Xp[..., 0] * beta_blocks[:, None, 0]
    for k in range(1, K):
        acc = acc + Xp[..., k] * beta_blocks[:, None, k]
    return acc


def _row_preds(vals_row, beta, gids):
    """Row-order predictions straight from the cached [N, 1+K] row stack:
    K tiny-table gathers (beta columns, [G] f64) plus K
    fused multiply-adds. No permutation out of the block layout at all,
    and exact f64 (the pair-gather unpad reconstructs to 2^-48). Valid only
    when the predict features equal the raw stack (no null masking)."""
    K = vals_row.shape[1] - 1
    acc = vals_row[:, 1] * jnp.take(beta[:, 0], gids)
    for k in range(1, K):
        acc = acc + vals_row[:, 1 + k] * jnp.take(beta[:, k], gids)
    return acc


def _unpad_preds(preds_blocks, unpad_idx, contiguous: bool = False):
    """Row-order gather of block predictions; as f32 (hi, lo) pairs when
    CONFIG.pair_gather is set (same bytes, exact to 2^-48). With a
    single group the split layout is row-sequential, so the "gather" is a
    free slice (``contiguous``)."""
    flat = preds_blocks.reshape(-1)
    if contiguous:
        return flat[: unpad_idx.shape[0]]
    if not CONFIG.pair_gather:
        return jnp.take(flat, unpad_idx, axis=0)
    hi = flat.astype(jnp.float32)
    lo = (flat - hi.astype(F64)).astype(jnp.float32)
    pairs = jnp.stack([hi, lo], axis=-1)  # [S*R, 2]
    out = jnp.take(pairs, unpad_idx, axis=0)
    return out[:, 0].astype(F64) + out[:, 1].astype(F64)


# cond(XtX) beyond which one f64 Cholesky solve of the squared system loses
# lstsq-grade accuracy; flagged batches take the CSNE refinement branch
_COND_REFINE = 1.0e6


def _csne_refine_blocks(A, beta, Xp, yp, wf, block_group, num_groups, alpha):
    """Corrected semi-normal-equations refinement (Björck's CSNE): the
    normal-equation solve squares cond(X), so near-collinear features lose
    up to 2x the digits a QR solve would. Two sweeps of
    ``r = y - X b`` (computed from the rows in f64, avoiding the
    cancellation of the moment form) and ``b += A^{-1}(X'r - alpha b)``
    restore QR-grade forward error for cond(X) up to ~1/sqrt(eps) (~1e7);
    four sweeps also recover lanes whose Cholesky failed into the eigh-pinv
    fallback (much larger initial error, convergence ratio ~eps*cond(A)).
    Runs only on flagged batches via lax.cond — well-conditioned queries
    never pay for the extra row passes. Reference default for this case is
    column-pivoted QR (src/least_squares.rs:193-231)."""
    from ..ops.linalg import psd_solver

    solve = psd_solver(A)  # factor A once; 4 sweeps reuse the factor
    for _ in range(4):
        bb = jnp.take(beta, block_group, axis=0)
        resid = (yp - _block_preds(Xp, bb)) * wf
        # X'r as elementwise-multiply + reduce, fused into one row pass
        Xtr = jax.ops.segment_sum(
            (Xp * resid[..., None]).sum(axis=1),
            block_group,
            num_segments=num_groups,
        )
        beta = beta + solve(Xtr - jnp.asarray(alpha, F64) * beta)
    return beta


# cond(XtX) beyond which the explicit-svd moment fast path reroutes to the
# true row-space SVD (minimum-norm / rcond-cutoff semantics): conservative —
# the CSNE-refined moment solve is lstsq-grade well past this, and genuine
# rank-deficiency sits many orders beyond it
_SVD_GUARD_COND = 1.0e10


def _solve_dispatch(XtX, Xty, counts, alpha: float, cd_params, refine=None,
                    force_refine: bool = False, svd_guard: bool = False,
                    lu: bool = False):
    """Normal-equation Cholesky solve (with conditioning-gated CSNE
    refinement when row blocks are supplied), or covariance-form coordinate
    descent when cd hyper-parameters are supplied (lasso/enet/NNLS).

    ``force_refine`` runs the CSNE sweeps unconditionally: this is the
    engine's CholeskyQR2-equivalent path for explicit solve_method='qr'
    (chol factor of the moments as R, row-space residual refinement —
    QR-grade forward error for cond(X) up to ~1e7 at a fraction of a
    factorization's cost).

    ``svd_guard`` (single-group explicit 'svd' on tall well-shaped data):
    same refined moment solve — identical to the SVD solution whenever no
    singular value falls below the rcond cutoff — with an in-program
    conditioning gate that reroutes to the true row-space minimum-norm SVD
    (reference solve_ridge_svd, src/least_squares.rs:106-168) when the
    Cholesky fails or cond(XtX) is large. Replaces an 800-op Householder
    reduction + SVD with one moment pass for the overwhelmingly common
    full-rank case."""
    if cd_params is None:
        K = XtX.shape[-1]
        A = XtX + jnp.asarray(alpha, F64) * jnp.eye(K, dtype=F64)
        if lu:
            # explicit 'lu': genuine batched partial-pivot elimination with
            # no CSNE sweeps — the reference's LU path is likewise a plain
            # factorization (src/least_squares.rs:264-273)
            from ..ops.linalg import solve_lu

            return solve_lu(A, Xty)
        if refine is None:
            return solve_psd(A, Xty)
        Xp, yp, wf, block_group, num_groups = refine
        if svd_guard and num_groups == 1:
            from ..ops.linalg import solve_psd_cond_ok, svd_lstsq

            beta, cond_est, ok = solve_psd_cond_ok(A, Xty)

            def fast(b):
                return _csne_refine_blocks(
                    A, b, Xp, yp, wf, block_group, num_groups, alpha
                )

            def accurate(_):
                Xrows = (Xp * wf[..., None]).reshape(1, -1, K)
                yrows = (yp * wf).reshape(1, -1)
                nv = wf.sum()[None]
                return svd_lstsq(Xrows, yrows, alpha=alpha, rcond=None, n_valid=nv)

            good = ok.all() & (jnp.max(cond_est) < _SVD_GUARD_COND)
            return lax.cond(good, fast, accurate, beta)
        if force_refine:
            beta = solve_psd(A, Xty)
            return _csne_refine_blocks(
                A, beta, Xp, yp, wf, block_group, num_groups, alpha
            )
        beta, cond_est = solve_psd_cond(A, Xty)
        return lax.cond(
            jnp.max(cond_est) > _COND_REFINE,
            lambda b: _csne_refine_blocks(
                A, b, Xp, yp, wf, block_group, num_groups, alpha
            ),
            lambda b: b,
            beta,
        )
    l1_ratio, max_iter, tol, positive, active_set = cd_params
    return solve_elastic_net_cov(
        XtX, Xty, counts, alpha=alpha, l1_ratio=l1_ratio,
        max_iter=max_iter, tol=tol, positive=positive, active_set=active_set,
    )


@partial(jax.jit, static_argnames=("num_groups", "want", "cd_params", "force_refine", "svd_guard", "lu"))
def _blocks_fit_kernel(
    Zp,  # [S, R, 1+K] target in slot 0
    wp,  # [S, R]
    block_group,  # [S]
    unpad_idx,  # [N] row-order gather out of the flat [S*R] layout
    gids,  # [N]
    num_groups: int,
    alpha: float,
    want: str,  # "beta" | "rows" | "preds"
    cd_params=None,  # static (l1_ratio, max_iter, tol, positive) for CD
    force_refine: bool = False,  # static: explicit 'qr' (CholeskyQR2 path)
    svd_guard: bool = False,  # static: explicit 'svd' single-group fast path
    vals_row=None,  # [N, 1+K] raw row stack (want="preds_row" only)
    lu: bool = False,  # static: explicit 'lu' (partial-pivot elimination)
):
    """Steady-state grouped fit on the materialized partition: moment
    matmuls + vectorized Cholesky (or covariance-form CD); predictions are
    computed block-wise (beta indexed by block, [S,K] — tiny) and scattered
    to row order with one [N] gather instead of an [N,K] coefficient
    gather (or straight from the row stack under want="preds_row")."""
    K = Zp.shape[-1] - 1
    yp, Xp = Zp[..., 0], Zp[..., 1:]
    XtX, Xty, counts = grouped_moments(Xp, yp, wp, block_group, num_groups)
    refine = (Xp, yp, wp.astype(F64), block_group, num_groups)
    beta = _solve_dispatch(
        XtX, Xty, counts, alpha, cd_params, refine, force_refine, svd_guard, lu
    )
    if want == "beta":
        return beta
    if want == "rows":
        return jnp.take(beta, gids, axis=0)
    if want == "preds_row":
        return _row_preds(vals_row, beta, gids)
    beta_blocks = jnp.take(beta, block_group, axis=0)  # [S, K]
    preds_blocks = _block_preds(Xp, beta_blocks)
    if want == "preds_flat":  # block-ordered; caller defers the permutation
        return preds_blocks.reshape(-1)
    return _unpad_preds(preds_blocks, unpad_idx, contiguous=num_groups == 1)


@partial(jax.jit, static_argnames=("num_groups", "want", "cd_params", "force_refine", "svd_guard", "lu"))
def _blocks_fit_kernel_ozaki(
    Zp,  # [S, R, 1+K] target in slot 0 (used for block predictions)
    digits,  # [D, S, R, 1+K] int8 digit planes (padding rows zeroed)
    scales,  # [S, 1+K] f64
    wp,  # [S, R]
    block_group,  # [S]
    unpad_idx,  # [N]
    gids,  # [N]
    num_groups: int,
    alpha: float,
    want: str,
    cd_params=None,
    force_refine: bool = False,
    svd_guard: bool = False,
    vals_row=None,  # [N, 1+K] raw row stack (want="preds_row" only)
    lu: bool = False,
):
    """Digit-matmul variant of `_blocks_fit_kernel`: the full moment matrix
    Z^T diag(w) Z comes from exact int8 digit matmuls (ops/ozaki.py)
    instead of an f64 batched matmul. Target is Zp's column 0, so XtX is the
    trailing KxK block and Xty the first column's tail."""
    from ..ops.ozaki import moments_from_digits

    K = Zp.shape[-1] - 1
    M, counts = moments_from_digits(digits, scales, wp, block_group, num_groups)
    XtX = M[:, 1:, 1:]
    Xty = M[:, 1:, 0]
    refine = (Zp[..., 1:], Zp[..., 0], wp.astype(F64), block_group, num_groups)
    beta = _solve_dispatch(
        XtX, Xty, counts, alpha, cd_params, refine, force_refine, svd_guard, lu
    )
    if want == "beta":
        return beta
    if want == "rows":
        return jnp.take(beta, gids, axis=0)
    if want == "preds_row":
        return _row_preds(vals_row, beta, gids)
    beta_blocks = jnp.take(beta, block_group, axis=0)
    preds_blocks = _block_preds(Zp[..., 1:], beta_blocks)
    if want == "preds_flat":
        return preds_blocks.reshape(-1)
    return _unpad_preds(preds_blocks, unpad_idx, contiguous=num_groups == 1)


@partial(jax.jit, static_argnames=("num_groups", "cd_params", "ridge"))
def _blocks_statistics_kernel(
    Zp, digits, scales, wp, block_group, num_groups: int, alpha: float,
    cd_params=None, ridge: bool = False,
):
    """All model-quality statistics from the materialized partition in ONE
    device program (the reference runs this once per group on the host;
    src/expressions.rs:468-509, src/statistics.rs).

    rss / sst / mae all come from *per-row* residuals (the moment identities
    yty - 2b'Xty + b'XtXb and yty - (sum y)^2/n cancel catastrophically for
    good fits / large target means); se/t/p come from the ridge-aware
    normal-equation metrics (NaN lanes on non-PD systems). With ``cd_params``
    the reported coefficients (and their residual metrics) come from the
    coordinate-descent solve — the reference's dispatch-solver estimate
    (src/expressions.rs:475) — while se/t/p keep the normal-equation
    recompute of src/statistics.rs:116."""
    K = Zp.shape[-1] - 1
    yp, Xp = Zp[..., 0], Zp[..., 1:]
    if digits is not None:
        # reuse the cached int8 digit planes (CONFIG.use_ozaki)
        from ..ops.ozaki import moments_from_digits

        M, counts = moments_from_digits(digits, scales, wp, block_group, num_groups)
        XtX, Xty = M[:, 1:, 1:], M[:, 1:, 0]
    else:
        XtX, Xty, counts = grouped_moments(Xp, yp, wp, block_group, num_groups)
    wf = wp.astype(F64)
    seg = lambda v: jax.ops.segment_sum(v, block_group, num_segments=num_groups)
    n_safe = jnp.maximum(counts, 1.0)
    sumy = seg((yp * wf).sum(axis=1))
    mean_b = jnp.take(sumy / n_safe, block_group, axis=0)  # [S]
    sst = seg((((yp - mean_b[:, None]) * wf) ** 2).sum(axis=1))

    if cd_params is not None:
        l1_ratio, max_iter, tol, positive, active_set = cd_params
        beta = solve_elastic_net_cov(
            XtX, Xty, counts, alpha=alpha, l1_ratio=l1_ratio,
            max_iter=max_iter, tol=tol, positive=positive,
            active_set=active_set,
        )
    else:
        A = XtX + jnp.asarray(alpha, F64) * jnp.eye(K, dtype=F64)
        beta = solve_psd(A, Xty)  # dispatch solver's estimate (with fallback)
    bb = jnp.take(beta, block_group, axis=0)  # [S, K]
    resid = (yp - _block_preds(Xp, bb)) * wf
    sae = seg(jnp.abs(resid).sum(axis=1))
    rss = seg((resid * resid).sum(axis=1))
    if cd_params is not None:
        # se/t/p always derive from the normal-equation RSS (reference
        # statistics.rs recomputes beta from the normal equations)
        beta_ne = solve_psd(
            XtX + jnp.asarray(alpha, F64) * jnp.eye(K, dtype=F64), Xty
        )
        resid_ne = (yp - _block_preds(Xp, jnp.take(beta_ne, block_group, axis=0))) * wf
        rss_ne = seg((resid_ne * resid_ne).sum(axis=1))
    else:
        rss_ne = rss
    fm = feature_metrics(XtX, Xty, rss_ne, counts, alpha, ridge=ridge)
    return {
        "coefficients": beta,
        "mse": rss / n_safe,
        "mae": sae / n_safe,
        "r2": 1.0 - rss / sst,
        "standard_errors": fm["standard_errors"],
        "t_values": fm["t_values"],
        "p_values": fm["p_values"],
    }


def _statistics_series(out, names, layout, layout_in):
    """Device metric arrays -> a device-native statistics struct column
    (reference struct shape: src/expressions.rs:485-508). No per-group host
    loop: 10k-group queries do O(1) host work and the per-row broadcast
    under .over() is a device gather."""
    out_series = StatisticsSeries("statistics", names, dict(out))
    if layout_in is not None:
        # device_gids: the host copy would re-upload an [N] index per query
        out_series = out_series.gather(layout.device_gids())
    return out_series


def _statistics_blocks(layout, vals, valid, policy, kwargs, names, layout_in,
                       cd_params=None):
    """Fast statistics path: cached partition + one fused kernel; no host
    work scales with the group count — the output stays a device-native
    statistics struct column."""
    Zp, wp, _, block_group, digits, scales = _blocks_cached(layout, vals, valid, policy)
    alpha = float(kwargs.alpha or 0.0)
    out = _blocks_statistics_kernel(
        Zp, digits, scales, wp, block_group, layout.num_groups,
        alpha, cd_params, ridge=alpha > 0.0,
    )
    return _statistics_series(out, names, layout, layout_in)


def _sharded_static(
    layout, vals, valid, policy, alpha, cd_params, mode,
    names, out_name, inv_w, layout_in, G, n, force_refine: bool = False,
    lu: bool = False,
):
    """Multi-chip static fit: returns the finished output Series, or None to
    fall back to single-device execution (with a log explaining why)."""
    if G <= 1:
        logger.info(
            "auto_shard: single group — whole-group solve stays on one "
            "device (heavy-group row splits apply only to moment paths)"
        )
        return None
    from ..parallel import (
        fit_moments_sharded,
        make_mesh,
        statistics_moments_sharded,
    )

    if valid is None:
        X_fit, y_fit = vals[:, 1:], vals[:, 0]
        wmask = jnp.ones(n, dtype=bool)
        X_pred = None
        predict_valid = None
    else:
        problem = masking.prepare_problem(
            policy, vals[:, 0], valid[:, 0], vals[:, 1:], valid[:, 1:]
        )
        X_fit, y_fit, wmask = problem.X, problem.y, problem.fit_mask
        X_pred, predict_valid = problem.X_predict, problem.predict_valid

    mesh = make_mesh()
    gids = layout.device_gids()
    if mode == "statistics":
        out = statistics_moments_sharded(
            mesh, X_fit, y_fit, wmask, gids, num_groups=G, alpha=alpha,
            cd_params=cd_params,
        )
        return _statistics_series(out, names, layout, layout_in)
    beta, preds = fit_moments_sharded(
        mesh, X_fit, y_fit, wmask, gids, num_groups=G, alpha=alpha,
        cd_params=cd_params, X_pred=X_pred, force_refine=force_refine, lu=lu,
    )
    if mode == "coefficients":
        rows = beta if layout_in is None else _gather_per_row(layout, beta)
        return _coef_struct(rows, names)
    if inv_w is not None:
        preds = preds * inv_w
    return Series(out_name, preds, predict_valid)


def _blocks_cached(layout, vals, valid, policy: str):
    """Materialized-partition cache: one padded gather per (columns, layout,
    policy); steady-state queries reuse the device-resident blocks. When the
    int8 digit-moment path is enabled and inputs are null-free, the digit
    decomposition (ops/ozaki.py) is cached alongside."""
    g, pmask, block_group, S = _split_layout(layout)
    R = pmask.shape[1]
    key = ("blocks", id(vals), id(valid), policy, R)
    if key not in layout._dev:
        Zp, wp, predict_valid = _build_blocks(vals, valid, g, pmask, policy, S, R)
        digits = scales = None
        if valid is None and CONFIG.use_ozaki:
            from ..ops.ozaki import MAX_BLOCK_ROWS, decompose_blocks

            # digit recombination is only exact up to MAX_BLOCK_ROWS rows per
            # block; oversized chunks fall back to the f64 einsum moments
            if R <= MAX_BLOCK_ROWS:
                digits, scales = decompose_blocks(Zp, wp)
        # LRU of 2 partitions: evict only the least-recently-used entry
        # (dict order tracks recency; hits below re-insert at the end)
        block_keys = [k for k in layout._dev if isinstance(k, tuple) and k[0] == "blocks"]
        if len(block_keys) >= 2:
            del layout._dev[block_keys[0]]
        # hold refs to vals/valid so the ids in `key` stay valid
        layout._dev[key] = (
            Zp, wp, predict_valid, block_group, digits, scales, vals, valid,
        )
    entry = layout._dev.pop(key)
    layout._dev[key] = entry  # move to most-recently-used position
    Zp, wp, predict_valid, block_group, digits, scales, _, _ = entry
    return Zp, wp, predict_valid, block_group, digits, scales


def _moving_group_block(G: int, k: int) -> int:
    """Group-block size for the classic moving kernels: at large G * K^2
    the [G, chunk, K, K] scan temporaries grow past any sensible budget
    even at the minimum chunk of 8 (grouped K=100 at G=10k would be
    ~6 GB), so the padded group batch is processed in sequential blocks
    sized to keep the minimum-chunk state inside a 64 MB budget. The
    budget predates the GPU port and has not been retuned for the GPU."""
    return max(1, (64 * 1024 * 1024) // max(1, k * k * 8 * 8))


def _solve_moving_blocked(solver, Xp, yp, vp, G: int, k: int, **params):
    """Dispatch a classic (non-lane) moving solver over group blocks when
    the whole batch's scan state cannot fit (see `_moving_group_block`).
    Equal-size blocks share one compiled program; the remainder block (if
    any) compiles once more."""
    Gb = _moving_group_block(G, k)
    if G <= Gb:
        return solver(Xp, yp, vp, chunk=_pick_chunk(G, k), **params)
    return _solve_lanes_blocked(
        solver, Xp, yp, vp, G, Gb, chunk=_pick_chunk(Gb, k), **params
    )


def _solve_lanes_blocked(solver, Xp, yp, vp, G: int, gb: int, **params):
    """Run a batched moving solver over sequential group blocks of size
    ``gb`` and concatenate — used when the whole batch's scan state would
    overflow the memory budget. Equal-size blocks share one compiled
    program; the remainder block (if any) compiles once more."""
    parts = [
        solver(Xp[i : i + gb], yp[i : i + gb], vp[i : i + gb], **params)
        for i in range(0, G, gb)
    ]
    return jnp.concatenate(parts, axis=0)


def _pick_chunk(G: int, k: int) -> int:
    """Bound the scan chunk for the moving-window kernels.

    Two limits: total scan-state memory (G * chunk * K^2 f64 <= ~64 MB;
    the associative-scan temporaries multiply this several-fold) and a
    per-chunk element cap (chunk * K^2 <= 2^19). Both predate the GPU
    port and are kept as they were; on the GPU the bound is device memory,
    and they have not been retuned."""
    budget = 64 * 1024 * 1024
    c = budget // max(1, G * k * k * 8)
    c = min(c, max(8, (1 << 19) // max(1, k * k)))
    c = int(max(8, min(CONFIG.moment_chunk_rows, c)))
    # power-of-two chunks only (one compiled program per power of two)
    return 1 << (c.bit_length() - 1)


# --------------------------------------------------------------------------- #
# target/feature extraction
# --------------------------------------------------------------------------- #
_STACK_CACHE_LIMIT = 8


def _stack_cached(target, feat_series):
    """[N, 1+K] (values, validity) stack — target first — memoized on the
    target Series. Plain-column queries re-evaluate to the same Series
    objects, so repeated calls skip the device-side stack entirely; validity
    is None when every input column is fully valid (the common fast case).
    """
    key = ("stack",) + tuple(id(s) for s in feat_series)
    cache = getattr(target, "_layout_cache", None)
    if cache is not None and key in cache:
        return cache[key][0]
    vals = jnp.stack(
        [jnp.asarray(target.values, dtype=F64)]
        + [jnp.asarray(s.values, dtype=F64) for s in feat_series],
        axis=1,
    )
    valid = None
    if target.validity is not None or any(s.validity is not None for s in feat_series):
        valid = jnp.stack(
            [target.valid_mask()] + [s.valid_mask() for s in feat_series], axis=1
        )
    out = (vals, valid)
    try:
        if cache is None:
            cache = {}
            object.__setattr__(target, "_layout_cache", cache)
            register_cache_owner(target)
        if len(cache) >= _STACK_CACHE_LIMIT:
            cache.pop(next(iter(cache)))
        cache[key] = (out, tuple(feat_series))  # hold refs: keys use id()s
    except AttributeError:
        pass
    return out


@jax.jit
def _weight_vectors(w_vals, w_valid):
    """sqrt-weight and its reciprocal; nulls -> EPSILON (reference
    least_squares.py:190-196, _EPSILON :63)."""
    from ..config import EPSILON

    sq = jnp.where(w_valid, jnp.sqrt(w_vals), EPSILON)
    return sq, 1.0 / sq


def _weighted_stack_cached(target, feat_series, weights):
    """Weighted (values, validity, sqrt_w, inv_sqrt_w) stack: the WLS
    sqrt-weight scaling folded into ONE device op over the whole [N, 1+K]
    stack instead of one expression kernel per column; memoized alongside
    the unweighted stack."""
    vals, valid = _stack_cached(target, feat_series)
    cache = getattr(target, "_layout_cache", None)
    key = ("wstack", id(vals), id(weights))
    if cache is not None and key in cache:
        return cache[key][0]
    sq, inv = _weight_vectors(
        jnp.asarray(weights.values, dtype=F64), weights.valid_mask()
    )
    vals_w = vals * sq[:, None]
    out = (vals_w, valid, sq, inv)
    try:
        if cache is None:
            cache = {}
            object.__setattr__(target, "_layout_cache", cache)
            register_cache_owner(target)
        if len(cache) >= _STACK_CACHE_LIMIT:
            cache.pop(next(iter(cache)))
        cache[key] = (out, weights)
    except AttributeError:
        pass
    return out


def _const_series(target, n: int):
    """Engine-side intercept column: a cached all-ones Series (the reference
    builds `target.fill_null(0)*0+1` as an expression, polars_ols/
    least_squares.py:184-188 — identical values/validity, but here it joins
    the fused column stack instead of paying its own expression kernels)."""
    cache = getattr(target, "_layout_cache", None)
    key = ("const", n)
    if cache is not None and key in cache:
        return cache[key]
    s = Series("const", jnp.ones(n, dtype=F64))
    try:
        if cache is None:
            cache = {}
            object.__setattr__(target, "_layout_cache", cache)
            register_cache_owner(target)
        if len(cache) >= _STACK_CACHE_LIMIT:
            cache.pop(next(iter(cache)))
        cache[key] = s
    except AttributeError:
        pass
    return s


def _extract(target, feat_series):
    names = [s.name for s in feat_series]
    X = jnp.stack([jnp.asarray(s.values, dtype=F64) for s in feat_series], axis=1)
    xv = jnp.stack([s.valid_mask() for s in feat_series], axis=1)
    if isinstance(target, StructSeries):
        y = target.values
        yv = target.validity if target.validity is not None else jnp.ones_like(y, dtype=bool)
        return y, yv, X, xv, names, target.field_names
    y = jnp.asarray(target.values, dtype=F64)
    yv = target.valid_mask()
    return y, yv, X, xv, names, None


# --------------------------------------------------------------------------- #
# static fits
# --------------------------------------------------------------------------- #
def _resolve_method(layout, kwargs, k: int) -> str:
    alpha = kwargs.alpha or 0.0
    return resolve_solve_method(
        kwargs.solve_method,
        alpha,
        kwargs.l1_ratio,
        bool(kwargs.positive),
        int(layout.counts.max()),
        k,
    )


def _fit_static(problem, layout, kwargs, k: int, method: Optional[str] = None):
    """Dispatch + solve; returns beta [G, K] or [G, K, M] for multi-target."""
    alpha = kwargs.alpha or 0.0
    l1 = kwargs.l1_ratio
    positive = bool(kwargs.positive)
    if method is None:
        method = _resolve_method(layout, kwargs, k)
    if method in ("chol", "lu") or (method == "qr" and problem.y.ndim == 1):
        XtX, Xty, _ = _moments(layout, problem.X, problem.y, problem.fit_mask)
        if problem.y.ndim == 1:
            return _solve_ne_refined_rows(
                XtX, Xty, problem.X, problem.y, problem.fit_mask,
                layout.device_gids(), layout.num_groups, float(alpha),
                force_refine=method == "qr", lu=method == "lu",
            )
        A = jnp.asarray(float(alpha), F64) * jnp.eye(k, dtype=F64) + XtX
        if method == "lu":
            from ..ops.linalg import solve_lu

            return solve_lu(A, Xty)
        return solve_psd(A, Xty)
    if method in ("cd", "cd_active_set"):
        # covariance-form CD: one moment pass, then O(K) coordinate steps
        XtX, Xty, counts = _moments(layout, problem.X, problem.y, problem.fit_mask)
        return solve_elastic_net_cov(
            XtX,
            Xty,
            counts,
            alpha=float(alpha),
            l1_ratio=float(0.5 if l1 is None else l1),
            max_iter=int(kwargs.max_iter or 1000),
            tol=float(kwargs.tol if kwargs.tol is not None else 1e-5),
            positive=positive,
            active_set=method == "cd_active_set",
        )
    (Xp, yp), wp = _pad_rows(layout, [problem.X, problem.y], problem.fit_mask)
    n_valid = wp.sum(axis=1)
    Xp = Xp * wp[..., None]
    yp = yp * (wp if yp.ndim == 2 else wp[..., None])
    if (
        method == "svd"
        and k <= 8
        and layout.num_groups >= 64
        and Xp.shape[1] > k
    ):
        # grouped explicit SVD: lane-major Householder + one-sided Jacobi
        # (exact to ~1e-14, in place of the batched SVD call)
        return _svd_lanes_jit(Xp, yp, float(alpha), kwargs.rcond, n_valid)
    if (
        CONFIG.auto_shard
        and jax.device_count() > 1
        and layout.num_groups >= jax.device_count()
    ):
        # whole-group row-space solves (incl. multi-target's shared-SVD,
        # src/least_squares.rs:243-260) are embarrassingly group-parallel:
        # shard the padded group batch over the mesh, zero collectives
        from ..parallel import make_mesh, solve_groups_sharded

        return solve_groups_sharded(
            make_mesh(),
            _rows_solver,
            (Xp, yp, n_valid),
            alpha=float(alpha),
            method=method,
            rcond=kwargs.rcond,
        )
    return solve_from_rows(Xp, yp, float(alpha), method, kwargs.rcond, n_valid)


@partial(jax.jit, static_argnames=("rcond",))
def _svd_lanes_jit(Xp, yp, alpha: float, rcond, n_valid=None):
    from ..ops.linalg import svd_lstsq_lanes

    return svd_lstsq_lanes(Xp, yp, alpha=alpha, rcond=rcond, n_valid=n_valid)


def _rows_solver(Xp, yp, n_valid, alpha: float, method: str, rcond):
    """Keyword-friendly adapter over `solve_from_rows` for the group-sharded
    dispatch (solve_groups_sharded passes batch arrays positionally)."""
    return solve_from_rows(Xp, yp, alpha, method, rcond, n_valid)


@partial(
    jax.jit,
    static_argnames=("num_groups", "rcond", "want", "use_lanes"),
)
def _svd_fit_kernel(
    Xp,  # [G, R, K] padded (cached layout; excluded rows zeroed)
    yp,  # [G, R]
    vp,  # [G, R] bool fit mask
    gids,  # [N]
    num_groups: int,
    alpha: float,
    rcond,
    want: str,  # "beta" | "rows" | "preds"
    use_lanes: bool,
):
    """Fused explicit-SVD fit on the cached padded layout: minimum-norm
    (ridge-shrunk) solves via lane-major Householder + Jacobi when the
    group batch fills the lanes, the row-major reduction otherwise;
    predictions stay in the padded layout for the deferred unpad."""
    from ..ops.linalg import svd_lstsq, svd_lstsq_lanes

    wf = vp.astype(F64)
    n_valid = wf.sum(axis=1)
    Xm = Xp * wf[..., None]
    ym = yp * wf
    if use_lanes:
        beta = svd_lstsq_lanes(Xm, ym, alpha=alpha, rcond=rcond, n_valid=n_valid)
    else:
        beta = svd_lstsq(Xm, ym, alpha=alpha, rcond=rcond, n_valid=n_valid)
    if want == "beta":
        return beta
    if want == "rows":
        return jnp.take(beta, gids, axis=0)
    preds_p = Xp[..., 0] * beta[:, None, 0]
    for kk in range(1, Xp.shape[-1]):
        preds_p = preds_p + Xp[..., kk] * beta[:, None, kk]
    return preds_p


@partial(jax.jit, static_argnames=("num_groups", "force_refine", "lu"))
def _solve_ne_refined_rows(
    XtX, Xty, X, y, w, gids, num_groups: int, alpha: float,
    force_refine: bool = False, lu: bool = False,
):
    """Row-space variant of the conditioning-gated CSNE refinement for the
    general (non-fused) normal-equation path: same math as
    `_csne_refine_blocks` but over [N]-shaped rows with segment sums.
    ``force_refine`` = explicit 'qr' (CholeskyQR2-equivalent); ``lu`` =
    explicit 'lu' (plain partial-pivot elimination, no sweeps)."""
    k = XtX.shape[-1]
    A = XtX + jnp.asarray(alpha, F64) * jnp.eye(k, dtype=F64)
    if lu:
        from ..ops.linalg import solve_lu

        return solve_lu(A, Xty)
    wf = w.astype(F64)

    def refine(b):
        from ..ops.linalg import psd_solver

        solve = psd_solver(A)  # factor once; sweeps reuse the factor
        for _ in range(4):
            resid = (y - (X * jnp.take(b, gids, axis=0)).sum(axis=1)) * wf
            Xtr = jax.ops.segment_sum(
                X * resid[:, None], gids, num_segments=num_groups
            )
            b = b + solve(Xtr - jnp.asarray(alpha, F64) * b)
        return b

    if force_refine:
        return refine(solve_psd(A, Xty))
    beta, cond_est = solve_psd_cond(A, Xty)
    return lax.cond(jnp.max(cond_est) > _COND_REFINE, refine, lambda b: b, beta)


@partial(
    jax.jit,
    static_argnames=("model", "params", "k", "nan_to_null", "lazy", "pair"),
)
def _moving_query_kernel(
    Xp, yp, vp, unpad_idx, predict_valid,
    inv_w,  # [N] 1/sqrt(w) WLS unscale in row order, or None
    model: str,  # "rls" | "rolling"
    params: tuple,  # static model hyper-parameters
    k: int,
    nan_to_null: bool,  # rolling: NaN coefficients -> null predictions
    lazy: bool,  # return block-ordered flat preds for a deferred unpad
    pair: bool,
):
    """One fused device program for a moving-model predictions query:
    lane kernel -> padded-layout predictions -> validity -> (deferred)
    unpad. The multiply-adds, the NaN->null mask and the unpad gathers run
    inside the kernel's program instead of as one eager dispatch each."""
    from ..ops.moving import solve_recursive_lanes, solve_rolling_lanes

    if model == "rls":
        half_life, c0, mean0 = params
        coefs_p = solve_recursive_lanes(
            Xp, yp, vp, half_life=half_life,
            initial_state_covariance=c0, initial_state_mean=mean0,
        )
    else:
        window, min_periods, alpha, positional = params
        coefs_p = solve_rolling_lanes(
            Xp, yp, vp, window=window, min_periods=min_periods,
            alpha=alpha, positional=positional,
        )
    preds_p = Xp[..., 0] * coefs_p[..., 0]
    for kk in range(1, k):
        preds_p = preds_p + Xp[..., kk] * coefs_p[..., kk]
    flat = preds_p.reshape(-1)
    validity = predict_valid
    if nan_to_null:
        finite = ~jnp.isnan(flat)
        finite_row = finite if unpad_idx is None else jnp.take(finite, unpad_idx, axis=0)
        validity = finite_row if validity is None else validity & finite_row
    if lazy:
        return flat, validity
    if unpad_idx is None:  # single group: row order == padded order
        out = flat
    elif not pair:
        out = jnp.take(flat, unpad_idx, axis=0)
    else:
        hi = flat.astype(jnp.float32)
        lo = (flat - hi.astype(F64)).astype(jnp.float32)
        pairs = jnp.stack([hi, lo], axis=-1)
        g = jnp.take(pairs, unpad_idx, axis=0)
        out = g[:, 0].astype(F64) + g[:, 1].astype(F64)
    if inv_w is not None:
        out = out[: inv_w.shape[0]] * inv_w
    return out, validity


def _coef_struct(beta: jnp.ndarray, names: List[str], name: str = "coefficients"):
    """Coefficient matrix -> struct column; NaN entries become nulls
    (src/expressions.rs:114-143)."""
    return StructSeries(name, names, beta, jnp.isfinite(beta))


def _predictions(problem, coef_rows: jnp.ndarray, name: str) -> Series:
    """Row-wise dot of (possibly per-row) coefficients with predict features,
    with the policy's null re-masking (src/expressions.rs:145-195)."""
    preds = jnp.einsum("nk,nk->n", problem.X_predict, coef_rows)
    return Series(name, preds, problem.predict_valid)


# --------------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------------- #
def evaluate_least_squares(
    function_name: str,
    target,
    feat_series: List[Series],
    kwargs,
    mode: str,
    layout_in,
    multi_target: bool = False,
    weights=None,
    add_intercept: bool = False,
):
    n = len(target)
    if add_intercept:
        feat_series = list(feat_series) + [_const_series(target, n)]
    k = len(feat_series)
    moving = function_name in ("recursive_least_squares", "rolling_least_squares")
    policy = kwargs.null_policy
    layout = layout_in if layout_in is not None else single_layout(n)
    G = layout.num_groups
    out_name = target.name

    # ---- fused fast path: static normal-equation fits on plain targets ----
    if (
        function_name == "least_squares"
        and not multi_target
        and not isinstance(target, StructSeries)
    ):
        method = _resolve_method(layout, kwargs, k)
        # explicit 'qr' runs the CholeskyQR2-equivalent path: fused moments
        # + Cholesky factor + unconditional CSNE row-space refinement
        # (QR-grade forward error at a fraction of a factorization's cost;
        # reference col-piv QR: src/least_squares.rs:193-205).
        # Single-group large-K explicit 'svd' on tall data takes the same
        # moment path with an in-kernel conditioning guard that reroutes to
        # the true minimum-norm SVD on rank trouble (_SVD_GUARD_COND) —
        # full-rank solutions are identical and the moment pass replaces a
        # Householder+SVD program.
        svd_single = (
            method == "svd"
            and G == 1
            and k > 8
            and kwargs.rcond is None
            and n > k
            and mode != "statistics"
        )
        if method in ("chol", "lu", "cd", "cd_active_set", "qr") or svd_single:
            force_refine = method in ("qr", "svd")
            lu = method == "lu"
            cd_params = None
            if method in ("cd", "cd_active_set"):
                cd_params = (
                    float(0.5 if kwargs.l1_ratio is None else kwargs.l1_ratio),
                    int(kwargs.max_iter or 1000),
                    float(kwargs.tol if kwargs.tol is not None else 1e-5),
                    bool(kwargs.positive),
                    method == "cd_active_set",
                )
            inv_w = None
            if weights is not None:
                vals, valid, _, inv_w = _weighted_stack_cached(
                    target, feat_series, weights
                )
            else:
                vals, valid = _stack_cached(target, feat_series)
            alpha = float(kwargs.alpha or 0.0)
            names = [s.name for s in feat_series]
            # multi-chip: distribute the grouped fit across every visible
            # device (rows stay sharded where they land; psum_scatter merges
            # partial moments exactly — SURVEY §2.3 DP row). Covers every
            # null policy, CD (shard-local covariance iterations) and
            # statistics; falls through (with a log) only for G <= 1.
            if CONFIG.auto_shard and jax.device_count() > 1:
                out = _sharded_static(
                    layout, vals, valid, policy, alpha, cd_params, mode,
                    names, out_name, inv_w, layout_in, G, n, force_refine, lu,
                )
                if out is not None:
                    return out
            if mode == "statistics":
                return _statistics_blocks(
                    layout, vals, valid, policy, kwargs, names, layout_in,
                    cd_params,
                )
            # block predictions reuse fit-side features; valid whenever the
            # predict features coincide with (or are masked over) fit ones
            blocks_ok = (mode != "statistics") and (
                valid is None or policy in ("zero", "ignore", "drop")
            )
            if blocks_ok:
                r_cap = _split_layout(layout)[1].shape[1]
                Zp, wp, predict_valid, block_group, digits, scales = (
                    _blocks_cached(layout, vals, valid, policy)
                )
                tail = (
                    wp, block_group,
                    layout.device_split_unpad(r_cap), layout.device_gids(),
                )
                if digits is not None:
                    fit = lambda want, vr=None: _blocks_fit_kernel_ozaki(
                        Zp, digits, scales, *tail, G, alpha, want, cd_params,
                        force_refine, svd_single, vals_row=vr, lu=lu,
                    )
                else:
                    fit = lambda want, vr=None: _blocks_fit_kernel(
                        Zp, *tail, G, alpha, want, cd_params, force_refine,
                        svd_single, vals_row=vr, lu=lu,
                    )
                if mode == "coefficients":
                    beta = fit("beta" if layout_in is None else "rows")
                    return _coef_struct(beta, names)
                if CONFIG.lazy_row_order and G > 1 and inv_w is None:
                    # block-ordered output with a deferred row-order
                    # permutation (BlockPermuted): reductions/slices/joins
                    # on device never pay the [N] unpad gather
                    from ..series import BlockPermuted

                    flat = fit("preds_flat")
                    lazy = BlockPermuted(
                        flat, tail[2], pair=CONFIG.pair_gather
                    )
                    return Series(out_name, lazy, predict_valid)
                if CONFIG.row_epilogue and G > 1 and valid is None:
                    # row-space epilogue: predictions built directly in row
                    # order from the cached row stack — no block-layout
                    # permutation, exact f64 (see _row_preds)
                    preds = fit("preds_row", vals)
                else:
                    preds = fit("preds")
                if inv_w is not None:
                    preds = preds * inv_w
                return Series(out_name, preds, predict_valid)
            if method in ("chol", "lu", "qr"):
                if G == 1:
                    g = pmask = block_group = None
                else:
                    g, pmask, block_group, _ = _split_layout(layout)
                args = (vals, valid, g, pmask, block_group, layout.device_gids())
                if mode == "coefficients":
                    want = "beta" if layout_in is None else "rows"
                    beta = _chol_fit_kernel(
                        *args, G, alpha, policy, want, force_refine, lu
                    )
                    return _coef_struct(beta, names)
                preds, predict_valid = _chol_fit_kernel(
                    *args, G, alpha, policy, "preds", force_refine, lu
                )
                if inv_w is not None:
                    preds = preds * inv_w
                return Series(out_name, preds, predict_valid)
            # cd with statistics / unsupported policy: general path below

        if method == "svd" and mode != "statistics":
            # fused explicit-SVD path on the cached padded layout (the
            # uncached variant re-gathered [G, R_max] rows every call)
            inv_w = None
            if weights is not None:
                vals, valid, _, inv_w = _weighted_stack_cached(
                    target, feat_series, weights
                )
            else:
                vals, valid = _stack_cached(target, feat_series)
            if valid is None or policy in ("zero", "drop"):
                names = [s.name for s in feat_series]
                alpha = float(kwargs.alpha or 0.0)
                Xp, yp, vp, predict_valid = _padded_cached(
                    layout, vals, valid, policy, moving=False
                )
                use_lanes_svd = k <= 8 and G >= 64 and Xp.shape[1] > k
                args_svd = (
                    Xp, yp, vp, layout.device_gids(), G, alpha, kwargs.rcond,
                )
                if mode == "coefficients":
                    want = "beta" if layout_in is None else "rows"
                    beta = _svd_fit_kernel(*args_svd, want, use_lanes_svd)
                    return _coef_struct(beta, names)
                preds_p = _svd_fit_kernel(*args_svd, "preds", use_lanes_svd)
                if G > 1 and CONFIG.lazy_row_order and inv_w is None:
                    from ..series import BlockPermuted

                    lazy = BlockPermuted(
                        preds_p.reshape(-1),
                        layout.device_unpad(preds_p.shape[1]),
                        pair=CONFIG.pair_gather,
                    )
                    return Series(out_name, lazy, predict_valid)
                preds = _unpad_rows(layout, preds_p)
                if inv_w is not None:
                    preds = preds * inv_w
                return Series(out_name, preds, predict_valid)

    if moving:
        names = [s.name for s in feat_series]
        from ..ops.moving import (
            lanes_applicable,
            solve_recursive_lanes,
            solve_rolling_lanes,
        )

        # engine-side WLS for moving models: the whole [N, 1+K] stack is
        # scaled by sqrt(w) in one device op (reference pre-scales each
        # column expression-side, least_squares.py:190-196) and predictions
        # are unscaled by 1/sqrt(w) inside the fused query program
        inv_w = None
        if weights is not None:
            vals_m, valid_m, _, inv_w = _weighted_stack_cached(
                target, feat_series, weights
            )
        else:
            vals_m, valid_m = _stack_cached(target, feat_series)
        Xp, yp, vp, predict_valid = _moving_cached(layout, vals_m, valid_m, policy)
        R_pad = Xp.shape[1]
        is_rls = function_name == "recursive_least_squares"
        use_lanes = CONFIG.moving_lanes and lanes_applicable(
            G, R_pad, k,
            kwargs.half_life if is_rls else None,
            rolling=not is_rls,
        )
        if is_rls:
            mean0_q = kwargs.initial_state_mean if mode == "coefficients" else None
            if isinstance(mean0_q, (list, tuple)):
                mean0_q = tuple(float(v) for v in mean0_q)
            elif mean0_q is not None:
                mean0_q = float(mean0_q)
            model_params = (
                kwargs.half_life,
                float(
                    10.0
                    if kwargs.initial_state_covariance is None
                    else kwargs.initial_state_covariance
                ),
                mean0_q,
            )
        else:
            window_i = int(kwargs.window_size)
            mp = kwargs.min_periods
            # with a fully valid column stack every row is a window member,
            # so valid-rank ('drop' family) semantics coincide with the
            # positional window — which needs a shifted slice instead of a
            # rank scatter + per-lane gathers
            positional_q = policy == "drop_window" or (
                valid_m is None and (mp is None or mp <= window_i)
            )
            model_params = (
                window_i,
                mp,
                float(kwargs.alpha or 0.0),
                positional_q,
            )
        shard_ok = (
            CONFIG.auto_shard and jax.device_count() > 1 and use_lanes
            and G >= jax.device_count()
        )
        if use_lanes and not shard_ok and mode != "coefficients":
            # the whole predictions query as ONE device program (kernel +
            # multiply-adds + NaN->null + unpad + WLS unscale), not one
            # eager dispatch per post-op
            lazy_out = G > 1 and CONFIG.lazy_row_order and inv_w is None
            unpad_idx = layout.device_unpad(R_pad) if G > 1 else None
            flat, validity = _moving_query_kernel(
                Xp, yp, vp, unpad_idx, predict_valid, inv_w,
                model="rls" if is_rls else "rolling",
                params=model_params,
                k=k,
                nan_to_null=not is_rls,
                lazy=lazy_out,
                pair=CONFIG.pair_gather,
            )
            if lazy_out:
                from ..series import BlockPermuted

                return Series(
                    out_name,
                    BlockPermuted(flat, unpad_idx, pair=CONFIG.pair_gather),
                    validity,
                )
            return Series(out_name, flat, validity)
        # multi-chip: moving models are whole-group scans — shard the group
        # batch axis over the mesh (zero collectives; SURVEY §2.3)
        shard_groups = (
            CONFIG.auto_shard
            and jax.device_count() > 1
            and use_lanes
            and G >= jax.device_count()
        )
        if CONFIG.auto_shard and jax.device_count() > 1 and not shard_groups:
            logger.info(
                "auto_shard: moving model stays on one device "
                "(needs lane kernels and G >= device_count; G=%d, K=%d)", G, k
            )
        if function_name == "recursive_least_squares":
            # quirk parity: the reference's predictions entry point ignores
            # initial_state_mean (src/expressions.rs:624-646 passes None)
            mean0 = kwargs.initial_state_mean if mode == "coefficients" else None
            if isinstance(mean0, (list, tuple)):
                mean0 = tuple(float(v) for v in mean0)
            elif mean0 is not None:
                mean0 = float(mean0)
            c0 = float(
                10.0
                if kwargs.initial_state_covariance is None
                else kwargs.initial_state_covariance
            )
            if shard_groups:
                from ..parallel import make_mesh, solve_groups_sharded

                coefs_p = solve_groups_sharded(
                    make_mesh(), solve_recursive_lanes, (Xp, yp, vp),
                    half_life=kwargs.half_life,
                    initial_state_covariance=c0,
                    initial_state_mean=mean0,
                )
            elif use_lanes:
                coefs_p = solve_recursive_lanes(
                    Xp, yp, vp,
                    half_life=kwargs.half_life,
                    initial_state_covariance=c0,
                    initial_state_mean=mean0,
                )
            else:
                from ..ops.moving import lanes_group_block

                gb = (
                    lanes_group_block(G, R_pad, k, kwargs.half_life)
                    if CONFIG.moving_lanes
                    else 0
                )
                if gb:
                    # large-K grouped RLS keeps the fast refined-SM lanes by
                    # scanning sequential group blocks (the whole batch's
                    # [G, chunks, K, K] state is what failed to fit)
                    coefs_p = _solve_lanes_blocked(
                        solve_recursive_lanes, Xp, yp, vp, G, gb,
                        half_life=kwargs.half_life,
                        initial_state_covariance=c0,
                        initial_state_mean=mean0,
                    )
                else:
                    coefs_p = _solve_moving_blocked(
                        solve_recursive_least_squares, Xp, yp, vp, G, k,
                        half_life=kwargs.half_life,
                        initial_state_covariance=c0,
                        initial_state_mean=mean0,
                    )
        elif shard_groups:
            from ..parallel import make_mesh, solve_groups_sharded

            coefs_p = solve_groups_sharded(
                make_mesh(), solve_rolling_lanes, (Xp, yp, vp),
                window=model_params[0],
                min_periods=model_params[1],
                alpha=model_params[2],
                positional=model_params[3],
            )
        elif use_lanes:
            coefs_p = solve_rolling_lanes(
                Xp, yp, vp,
                window=model_params[0],
                min_periods=model_params[1],
                alpha=model_params[2],
                positional=model_params[3],
            )
        else:
            from ..ops.moving import lanes_group_block

            gb = (
                lanes_group_block(G, R_pad, k, None, rolling=True)
                if CONFIG.moving_lanes
                else 0
            )
            if gb:
                # large-K grouped rolling keeps the fast refined-SM lanes by
                # scanning sequential group blocks (the whole batch's
                # [G, chunks, K, K] f64 P+A state is what failed to fit)
                coefs_p = _solve_lanes_blocked(
                    solve_rolling_lanes, Xp, yp, vp, G, gb,
                    window=model_params[0],
                    min_periods=model_params[1],
                    alpha=model_params[2],
                    positional=model_params[3],
                )
            else:
                coefs_p = _solve_moving_blocked(
                    solve_rolling_ols, Xp, yp, vp, G, k,
                    window=model_params[0],
                    min_periods=model_params[1],
                    alpha=model_params[2],
                    positional=model_params[3],
                )
        if mode == "coefficients":
            return _coef_struct(_unpad_rows(layout, coefs_p), names)
        # predictions in the padded layout: K fused f64 multiply-adds and ONE
        # [N]-element unpad — deferred like the static path's block outputs
        preds_p = Xp[..., 0] * coefs_p[..., 0]
        for kk in range(1, k):
            preds_p = preds_p + Xp[..., kk] * coefs_p[..., kk]
        if not is_rls:
            # warm-up NaN predictions become nulls (engine-side equivalent
            # of the reference's fill_nan post-step, least_squares.py:407)
            finite = _unpad_rows(layout, ~jnp.isnan(preds_p))
            predict_valid = (
                finite if predict_valid is None else predict_valid & finite
            )
        if G > 1 and CONFIG.lazy_row_order and inv_w is None:
            from ..series import BlockPermuted

            R_full = preds_p.shape[1]
            lazy = BlockPermuted(
                preds_p.reshape(-1),
                layout.device_unpad(R_full),
                pair=CONFIG.pair_gather,
            )
            return Series(out_name, lazy, predict_valid)
        preds = _unpad_rows(layout, preds_p)
        if inv_w is not None:
            preds = preds * inv_w
        return Series(out_name, preds, predict_valid)


    if (
        multi_target
        and isinstance(target, StructSeries)
        and function_name == "least_squares"
        and mode != "statistics"
    ):
        # fused multi-target fast path: masking + padding + shared SVD +
        # per-target prediction epilogue in ONE device program (the general
        # path below runs ~12 eager stages, each its own dispatch)
        out = _multi_target_fused(
            target, feat_series, kwargs, layout, weights
        )
        if out is not None:
            return out

    y, yv, X, xv, names, target_names = _extract(target, feat_series)
    problem = masking.prepare_problem(policy, y, yv, X, xv, moving=moving)
    inv_w = None
    if weights is not None:
        sq, inv_w = _weight_vectors(
            jnp.asarray(weights.values, dtype=F64), weights.valid_mask()
        )
        problem = masking.MaskedProblem(
            problem.y * (sq if problem.y.ndim == 1 else sq[:, None]),
            problem.X * sq[:, None],
            problem.fit_mask,
            problem.X_predict * sq[:, None],
            problem.predict_valid,
        )

    if function_name == "least_squares":
        if mode == "statistics":
            return _statistics(problem, layout, kwargs, names, layout_in, k)
        beta = _fit_static(problem, layout, kwargs, k)
        if beta.ndim == 3:  # multi-target [G, K, M]
            return _multi_target_output(problem, beta, layout, target_names, inv_w)
        if mode == "coefficients":
            if layout_in is None:
                return _coef_struct(beta, names)
            return _coef_struct(_gather_per_row(layout, beta), names)
        coef_rows = (
            jnp.broadcast_to(beta[0], (n, k)) if G == 1 else _gather_per_row(layout, beta)
        )
        out = _predictions(problem, coef_rows, out_name)
        if inv_w is not None:
            out = Series(out_name, out.values * inv_w, out.validity)
        return out

    raise ValueError(f"unknown least-squares function {function_name!r}")


@jax.jit
def _multi_preds_single(X, beta_km, inv_w):
    """[N, K] x [K, M] as K*M fused multiply-adds on [N] vectors."""
    K, M = beta_km.shape
    cols = []
    for m in range(M):
        acc = X[:, 0] * beta_km[0, m]
        for kk in range(1, K):
            acc = acc + X[:, kk] * beta_km[kk, m]
        cols.append(acc)
    preds = jnp.stack(cols, axis=-1)
    return preds if inv_w is None else preds * inv_w[:, None]


@partial(jax.jit, static_argnames=("num_groups", "R", "pair"))
def _multi_preds_grouped(X, beta, g, unpad_idx, num_groups: int, R: int,
                         pair: bool, inv_w):
    """Grouped multi-target predictions in ONE program: pad X into the
    [G, R, K] group layout, K*M fused multiply-adds against the per-group
    [G, K, M] coefficients, and a row-order pair-gather per target.
    Replaces an eager [N, K, M] per-row coefficient gather + einsum (the
    gather alone moves M x the row data)."""
    K = X.shape[1]
    M = beta.shape[-1]
    Xp = jnp.take(X, g, axis=0).reshape(num_groups, R, K)
    cols = []
    for m in range(M):
        acc = Xp[..., 0] * beta[:, None, 0, m]
        for kk in range(1, K):
            acc = acc + Xp[..., kk] * beta[:, None, kk, m]
        cols.append(_unpad_preds(acc, unpad_idx) if pair
                    else jnp.take(acc.reshape(-1), unpad_idx, axis=0))
    preds = jnp.stack(cols, axis=-1)
    return preds if inv_w is None else preds * inv_w[:, None]


def _features_stack_cached(feat_series):
    """[N, K] feature (values, validity) stack memoized on the first feature
    Series — multi-target queries rebuild their target struct per call, so
    the target-keyed `_stack_cached` never hits for them."""
    key = ("fstack",) + tuple(id(s) for s in feat_series)
    owner = feat_series[0]
    cache = getattr(owner, "_layout_cache", None)
    if cache is not None and key in cache:
        return cache[key][0]
    X = jnp.stack([jnp.asarray(s.values, dtype=F64) for s in feat_series], axis=1)
    xv = None
    if any(s.validity is not None for s in feat_series):
        xv = jnp.stack([s.valid_mask() for s in feat_series], axis=1)
    out = (X, xv)
    try:
        if cache is None:
            cache = {}
            object.__setattr__(owner, "_layout_cache", cache)
            register_cache_owner(owner)
        if len(cache) >= _STACK_CACHE_LIMIT:
            cache.pop(next(iter(cache)))
        cache[key] = (out, tuple(feat_series))  # hold refs: keys use id()s
    except AttributeError:
        pass
    return out


@partial(
    jax.jit, static_argnames=("num_groups", "R", "policy", "weighted", "M")
)
def _build_mt_padded(
    y, yv, X, xv, w_vals, w_valid, g, pmask,
    *, num_groups: int, R: int, policy: str, weighted: bool, M: int,
):
    """Materialize the padded multi-target partition in ONE program (run
    once per (struct target, features, policy, weights); cached). Packs
    [masked+weighted targets, masked+weighted features, fit mask, predict
    features] into a single [N, ...] matrix so the whole build is one row
    gather. Returns (Xp [G,R,K], Yp [G,R,M], wp [G,R], Xq_p or None,
    predict_valid or None)."""
    K = X.shape[1]
    yv_ = yv if yv is not None else jnp.ones_like(y, dtype=bool)
    xv_ = xv if xv is not None else jnp.ones_like(X, dtype=bool)
    problem = masking.prepare_problem(policy, y, yv_, X, xv_)
    yf, Xf, mask = problem.y, problem.X, problem.fit_mask
    if weighted:
        # sqrt(w)-scale the FIT system only; predictions broadcast over the
        # unscaled X_predict, so no 1/sqrt(w) post-step is needed
        sq, _ = _weight_vectors(w_vals, w_valid)
        yf = yf * sq[:, None]
        Xf = Xf * sq[:, None]
    # predict features differ from fit features whenever masking or weight
    # scaling touched them; pack them alongside only then
    same_predict = (yv is None and xv is None) and not weighted
    cols = [yf, Xf, mask[:, None].astype(F64)]
    if not same_predict:
        cols.append(problem.X_predict)
    Z = jnp.concatenate(cols, axis=1)
    if num_groups == 1:
        Zp = Z[None]
        wp = (Zp[..., M + K] > 0.5)
    else:
        Zp = jnp.take(Z, g, axis=0).reshape(num_groups, R, Z.shape[1])
        wp = pmask & (Zp[..., M + K] > 0.5)
    Yp = Zp[..., :M]
    Xp = Zp[..., M : M + K]
    Xq_p = None if same_predict else Zp[..., M + K + 1 :]
    return Xp, Yp, wp, Xq_p, problem.predict_valid


def _mt_padded_cached(layout, target, X, xv, weights, policy: str):
    """Padded multi-target partition cache (keyed like `_padded_cached`):
    steady-state multi-target queries skip masking and the [N -> G x R]
    gather entirely (re-gathering X/Y per call moves the row data again)."""
    G = layout.num_groups
    y = target.values
    yv = target.validity
    if G == 1:
        g, pmask, R = None, None, int(y.shape[0])
    else:
        g, pmask, R = layout.device_padded()
    w_vals = w_valid = None
    if weights is not None:
        w_vals = jnp.asarray(weights.values, dtype=F64)
        w_valid = weights.valid_mask()
    key = ("mtpad", id(y), id(yv), id(X), id(xv), id(weights), policy, R)
    if key not in layout._dev:
        out = _build_mt_padded(
            y, yv, X, xv, w_vals, w_valid, g, pmask,
            num_groups=G, R=R, policy=policy,
            weighted=weights is not None, M=int(y.shape[1]),
        )
        mt_keys = [k_ for k_ in layout._dev if isinstance(k_, tuple) and k_[0] == "mtpad"]
        if len(mt_keys) >= 2:
            del layout._dev[mt_keys[0]]
        # hold refs to the keyed objects so the ids stay valid
        layout._dev[key] = out + (y, yv, X, xv, weights)
    entry = layout._dev.pop(key)
    layout._dev[key] = entry
    return entry[0], entry[1], entry[2], entry[3], entry[4]


@partial(
    jax.jit,
    static_argnames=("num_groups", "rcond", "pair", "use_lanes"),
)
def _multi_fused_kernel(
    Xp,  # [G, R, K] padded fit features (masked rows zeroed via wp below)
    Yp,  # [G, R, M] padded targets
    wp,  # [G, R] fit mask
    Xq_p,  # [G, R, K] padded predict features, or None to reuse Xp
    unpad_idx,  # row-order unpad map (None when num_groups == 1)
    alpha,
    *,
    num_groups: int,
    rcond,
    pair: bool,
    use_lanes: bool,
):
    """Multi-target solve + predict in one program over the cached padded
    partition: the shared SVD serves all M targets (reference
    least_squares.py:282-329, src/least_squares.rs:243-260), predictions
    broadcast per target as K fused multiply-adds + a row-order unpad."""
    K = Xp.shape[-1]
    M = Yp.shape[-1]
    n_valid = wp.sum(axis=1)
    Xf = Xp * wp[..., None]
    Yf = Yp * wp[..., None]
    if use_lanes:
        from ..ops.linalg import svd_lstsq_lanes

        beta = svd_lstsq_lanes(Xf, Yf, alpha=alpha, rcond=rcond, n_valid=n_valid)
    else:
        beta = solve_from_rows(Xf, Yf, alpha, "svd", rcond, n_valid)
    Xq = Xp if Xq_p is None else Xq_p
    cols = []
    for m in range(M):
        acc = Xq[..., 0] * beta[:, None, 0, m]
        for kk in range(1, K):
            acc = acc + Xq[..., kk] * beta[:, None, kk, m]
        if num_groups == 1:
            cols.append(acc[0])
        else:
            cols.append(
                _unpad_preds(acc, unpad_idx)
                if pair
                else jnp.take(acc.reshape(-1), unpad_idx, axis=0)
            )
    preds = jnp.stack(cols, axis=-1)
    return preds


def _multi_target_fused(target, feat_series, kwargs, layout, weights):
    """Fused multi-target dispatch. Returns the predictions StructSeries, or
    None when the group-sharded whole-group solve should run instead
    (auto_shard on a multi-device mesh, handled by `_fit_static`)."""
    G = layout.num_groups
    if CONFIG.auto_shard and jax.device_count() > 1 and G >= jax.device_count():
        return None
    k = len(feat_series)
    X, xv = _features_stack_cached(feat_series)
    Xp, Yp, wp, Xq_p, predict_valid = _mt_padded_cached(
        layout, target, X, xv, weights, kwargs.null_policy
    )
    R = Xp.shape[1]
    unpad = None if G == 1 else layout.device_unpad(R)
    use_lanes = k <= 8 and G >= 64 and R > k
    preds = _multi_fused_kernel(
        Xp, Yp, wp, Xq_p, unpad,
        jnp.asarray(float(kwargs.alpha or 0.0), F64),
        num_groups=G,
        rcond=kwargs.rcond,
        pair=CONFIG.pair_gather,
        use_lanes=use_lanes,
    )
    validity = None
    if predict_valid is not None:
        validity = predict_valid[:, None] & jnp.ones_like(preds, dtype=bool)
    return StructSeries("predictions", target.field_names, preds, validity)


def _multi_target_output(problem, beta, layout, target_names, inv_w=None):
    """Predictions struct for multi-target fits (src/expressions.rs:521-591):
    Drop policy masks whole output rows with nulls; weighted fits unscale
    by 1/sqrt(w) (the reference's expression-level post-step,
    least_squares.py:234-235)."""
    if layout.num_groups == 1:
        preds = _multi_preds_single(problem.X_predict, beta[0], inv_w)
    else:
        g, _, R = layout.device_padded()
        preds = _multi_preds_grouped(
            problem.X_predict, beta, g, layout.device_unpad(R),
            layout.num_groups, R, CONFIG.pair_gather, inv_w,
        )
    validity = None
    if problem.predict_valid is not None:
        validity = problem.predict_valid[:, None] & jnp.ones_like(preds, dtype=bool)
    return StructSeries("predictions", target_names, preds, validity)


def _statistics(problem, layout, kwargs, names, layout_in, k):
    """mode='statistics': single-row struct per group with residual metrics,
    dispatch-solver coefficients and normal-equation se/t/p
    (src/expressions.rs:468-509, src/statistics.rs)."""
    alpha = float(kwargs.alpha or 0.0)
    XtX, Xty, counts = _moments(layout, problem.X, problem.y, problem.fit_mask)
    w = problem.fit_mask.astype(F64)
    # sigma^2 for se/t/p uses the normal-equation estimate's *per-row* RSS
    # (reference src/statistics.rs:115-123; the moment identity cancels)
    A = XtX + jnp.asarray(alpha, F64) * jnp.eye(k, dtype=F64)
    beta_ne = solve_psd(A, Xty)
    resid_ne = (problem.y - jnp.einsum(
        "nk,nk->n", problem.X, _gather_per_row(layout, beta_ne)
    )) * w
    rss_ne = jax.ops.segment_sum(
        resid_ne * resid_ne, layout.device_gids(), num_segments=layout.num_groups
    )
    fm = feature_metrics(XtX, Xty, rss_ne, counts, alpha)

    # the 'coefficients' field reports the dispatch solver's estimate
    # (src/expressions.rs:475); se/t/p use the normal-equation recompute
    beta = _fit_static(problem, layout, kwargs, k)
    coef_rows = _gather_per_row(layout, beta)
    preds = jnp.einsum("nk,nk->n", problem.X, coef_rows)
    (yp, pp), wp = _pad_rows(layout, [problem.y, preds], problem.fit_mask)
    rm = residual_metrics(yp, pp, wp)

    out = {
        "coefficients": beta,
        "mse": rm["mse"],
        "mae": rm["mae"],
        "r2": rm["r2"],
        "standard_errors": fm["standard_errors"],
        "t_values": fm["t_values"],
        "p_values": fm["p_values"],
    }
    return _statistics_series(out, names, layout, layout_in)


# --------------------------------------------------------------------------- #
# predict (out-of-sample, row-aligned coefficient struct)
# --------------------------------------------------------------------------- #
def evaluate_predict(coef, feat_series: List[Series], null_policy: str, name: str):
    assert isinstance(coef, StructSeries), (
        "the first input to predict must be a coefficients struct"
    )
    assert len(coef.field_names) == len(feat_series), (
        f"coefficient struct has {len(coef.field_names)} fields but "
        f"{len(feat_series)} feature columns were passed"
    )
    X = jnp.stack([jnp.asarray(s.values, dtype=F64) for s in feat_series], axis=1)
    xv = jnp.stack([s.valid_mask() for s in feat_series], axis=1)
    Xp = jnp.where(xv, X, jnp.nan if null_policy == "ignore" else 0.0)
    # null coefficient entries (e.g. unmatched left-join rows) are NaN in
    # the reference's unnest -> to_ndarray conversion, so their predictions
    # come out NaN (src/expressions.rs:726-729)
    coefv = coef.values
    if coef.validity is not None:
        coefv = jnp.where(coef.validity, coefv, jnp.nan)
    preds = jnp.einsum("nk,nk->n", Xp, coefv)
    validity = None
    if null_policy == "drop":
        validity = xv.all(axis=1) & coef.valid_mask()
    return Series(name, preds, validity)
