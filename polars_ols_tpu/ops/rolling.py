"""Rolling-window least squares, batched.

The reference maintains XtX / Xty (or its Woodbury inverse) with sequential
per-row rank-2 updates (src/least_squares.rs:600-1032). Parallel
reformulation: windowed moments are *differences of prefix sums* —
``W_t = P_t - P_{t-w}`` with ``P`` the running sum of per-row outer products
(invalid rows contribute zero). The add/subtract streams are cumsummed in
row chunks (carrying the running window moment across chunks, bounding
memory at chunk * K^2) and every row's K x K system is solved by one batched
Cholesky — fully parallel over rows and groups instead of a sequential scan.
Add/subtract propagation error matches the reference's own incremental
updates; accumulation is f64.

Two window semantics, matching src/least_squares.rs:947-1029:

* drop family ('drop'/'drop_zero'/'drop_y_zero_x'): the window spans the
  last `window` *valid* observations; coefficients are defined from the
  min_periods-th valid observation onwards and forward-fill across invalid
  rows automatically (the window is keyed on valid-rank, which is constant
  across invalid rows).
* 'drop_window': statsmodels RollingOLS(missing='drop') semantics — a fixed
  positional window using only its valid rows; coefficients refresh when the
  window holds >= min_periods valid observations and otherwise carry the
  last refreshed value (NaN before the first refresh).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .linalg import solve_psd

F64 = jnp.float64


def _windowed_solve_chunks(
    X: jnp.ndarray,  # [R, K] zero-filled (invalid rows zero)
    y: jnp.ndarray,  # [R]
    v: jnp.ndarray,  # [R] bool
    sub_idx: jnp.ndarray,  # [R] row index whose moment leaves the window at t
    sub_on: jnp.ndarray,  # [R] bool — whether a subtraction applies at t
    alpha: float,
    chunk: int,
) -> jnp.ndarray:
    """Core streaming kernel: coef_t = solve(W_t + alpha I, Wy_t) for all t."""
    R, k = X.shape
    vf = v.astype(F64)
    Xv = X * vf[:, None]
    yv = y * vf
    eye = alpha * jnp.eye(k, dtype=F64)

    n_chunks = R // chunk

    def body(carry, idx):
        W_c, b_c = carry
        rows = idx * chunk + jnp.arange(chunk)
        Xa = lax.dynamic_slice_in_dim(Xv, idx * chunk, chunk)
        Xr = lax.dynamic_slice_in_dim(X, idx * chunk, chunk)
        ya = lax.dynamic_slice_in_dim(yv, idx * chunk, chunk)
        si = lax.dynamic_slice_in_dim(sub_idx, idx * chunk, chunk)
        so = lax.dynamic_slice_in_dim(sub_on, idx * chunk, chunk).astype(F64)
        vs = lax.dynamic_slice_in_dim(vf, idx * chunk, chunk)

        Xs = jnp.take(Xv, si, axis=0) * so[:, None]  # rows leaving the window
        ys = jnp.take(yv, si, axis=0) * so

        dU = jnp.einsum("bk,bl->bkl", Xa, Xr, preferred_element_type=F64) - jnp.einsum(
            "bk,bl->bkl", Xs, jnp.take(X, si, axis=0), preferred_element_type=F64
        )
        du = Xa * ya[:, None] - Xs * ys[:, None]
        W = W_c + jnp.cumsum(dU, axis=0)
        b = b_c + jnp.cumsum(du, axis=0)
        coef = solve_psd(W + eye, b)
        return (W[-1], b[-1]), coef

    carry0 = (jnp.zeros((k, k), F64), jnp.zeros(k, F64))
    _, coefs = lax.scan(body, carry0, jnp.arange(n_chunks))
    return coefs.reshape(R, k)


# above this feature count the prefix-difference kernel's chunk shrinks
# below usefulness (chunk*K^2 cap); the reference's own Woodbury rank-1
# update scan (src/least_squares.rs:629-787, default for k > 60) is the
# faster formulation — one K^2 Sherman-Morrison add + one downdate per row.
_SM_MIN_K = 33


def _windowed_sm_scan(
    X: jnp.ndarray,  # [R, K]
    y: jnp.ndarray,  # [R]
    v: jnp.ndarray,  # [R] bool
    sub_idx: jnp.ndarray,  # [R]
    sub_on: jnp.ndarray,  # [R] bool
    alpha: float,
    window: int,
) -> jnp.ndarray:
    """Woodbury-state rolling solve: propagate M = (W + reg*I)^-1 with a
    Sherman-Morrison update for the entering row and a downdate for the
    leaving row; coef_t = M b_t. With ridge alpha the state is exact
    (M0 = I/alpha, reference least_squares.rs:924-926); for alpha = 0 a
    diffuse prior reg ~ 1e-10 of the data scale plays the role of the
    reference's warm-up inversion (relative coefficient error ~ reg)."""
    R, K = X.shape
    vf = v.astype(F64)
    Xv = X * vf[:, None]
    yv = y * vf
    so = sub_on.astype(F64)
    Xs = jnp.take(Xv, sub_idx, axis=0) * so[:, None]
    ys = jnp.take(yv, sub_idx, axis=0) * so
    if alpha > 0.0:
        reg = jnp.asarray(alpha, F64)
    else:
        scale = jnp.maximum(jnp.mean(Xv * Xv) * min(window, R), 1e-300)
        reg = scale * 1e-10

    def body(carry, row):
        M, b, poisoned = carry
        xa, ya, xs_, ys_ = row
        Mx = M @ xa
        M = M - jnp.outer(Mx, Mx) / (1.0 + jnp.dot(xa, Mx))
        b = b + xa * ya
        Mx2 = M @ xs_
        den = 1.0 - jnp.dot(xs_, Mx2)
        # a singular leaving-row downdate makes the propagated inverse
        # wrong from here on: skip the downdate and poison the lane so the
        # affected coefficients surface as NaN instead of silently-wrong
        # values (the defined/min_periods mask semantics).
        #
        # KNOWN DIVERGENCE from the reference's NonWoodbury path (which
        # re-solves from moments each row and so recovers once the window
        # slides past, src/least_squares.rs:700-735): here the inverse
        # state is unrecoverable after a singular downdate — exactly like
        # the reference's own Woodbury path, whose 2x2 block inverse
        # (src/least_squares.rs:629-648) is likewise unguarded. An exact
        # reseed would need a per-row K x K factorization under vmap
        # (where lax.cond lowers to select and BOTH branches always run),
        # doubling the kernel's cost for a degenerate case. The lane-major
        # kernels (ops/moving.py), which are the default wherever they
        # apply, avoid the problem entirely via exact f64 moments +
        # refinement and recover like the reference.
        bad = jnp.abs(den) <= 1e-12
        upd = jnp.outer(Mx2, Mx2) / jnp.where(bad, 1.0, den)
        M = jnp.where(bad, M, M + upd)
        b = b - xs_ * ys_
        poisoned = poisoned | bad
        coef = jnp.where(poisoned, jnp.nan, M @ b)
        return (M, b, poisoned), coef

    M0 = jnp.eye(K, dtype=F64) / reg
    carry0 = (M0, jnp.zeros(K, F64), jnp.asarray(False))
    (_, _, _), coefs = lax.scan(body, carry0, (Xv, yv, Xs, ys))
    return coefs


def _rolling_single(
    X: jnp.ndarray,
    y: jnp.ndarray,
    v: jnp.ndarray,
    window: int,
    min_periods: int,
    alpha: float,
    positional: bool,
    chunk: int,
) -> jnp.ndarray:
    R, k = X.shape
    t = jnp.arange(R)
    r = jnp.cumsum(v.astype(jnp.int64))  # 1-based valid rank through t

    if positional:
        # 'drop_window': subtract row t-window (its moment is zero if invalid)
        sub_idx = jnp.clip(t - window, 0, R - 1)
        sub_on = t >= window
        count_w = r - jnp.where(t >= window, jnp.take(r, sub_idx), 0)
        defined = count_w >= min_periods
    else:
        # drop family: subtract the valid row of rank (r_t - window) when a
        # new valid row takes the window beyond `window` valid observations
        rank_pos = jnp.zeros(R + 2, dtype=jnp.int64)
        rank_pos = rank_pos.at[jnp.where(v, r, R + 1)].set(t)
        sub_rank = r - window
        sub_on = v & (sub_rank >= 1)
        sub_idx = jnp.take(rank_pos, jnp.clip(sub_rank, 0, R + 1))
        defined = r >= min_periods

    if k >= _SM_MIN_K:
        coefs = _windowed_sm_scan(X, y, v, sub_idx, sub_on, alpha, window)
    else:
        coefs = _windowed_solve_chunks(X, y, v, sub_idx, sub_on, alpha, chunk)
    coefs = jnp.where(defined[:, None], coefs, jnp.nan)

    if positional:
        # carry last refreshed value across undefined gaps (statsmodels
        # forward-fill parity, reference tests/test_ols.py:718-772)
        last = jnp.maximum.accumulate(jnp.where(defined, t, -1))
        coefs = jnp.where(
            (last >= 0)[:, None], jnp.take(coefs, jnp.clip(last, 0), axis=0), jnp.nan
        )
    return coefs


@partial(
    jax.jit,
    static_argnames=("window", "min_periods", "alpha", "positional", "chunk"),
)
def solve_rolling_ols(
    Xp: jnp.ndarray,  # [G, R, K] zero-filled
    yp: jnp.ndarray,  # [G, R]
    vp: jnp.ndarray,  # [G, R] bool
    window: int,
    min_periods: Optional[int],
    alpha: float,
    positional: bool,
    chunk: int = 256,
) -> jnp.ndarray:
    """Batched rolling-OLS coefficient paths [G, R, K] (NaN where undefined).

    min_periods defaults to min(K, window) (src/least_squares.rs:860);
    `use_woodbury` is accepted upstream for API parity but is irrelevant
    here — the batched prefix-sum kernel solves every window directly.
    """
    G, R, k = Xp.shape
    if min_periods is None:
        min_periods = min(k, window)
    chunk = min(chunk, R)
    pad = (-R) % chunk
    if pad:
        Xp = jnp.pad(Xp, ((0, 0), (0, pad), (0, 0)))
        yp = jnp.pad(yp, ((0, 0), (0, pad)))
        vp = jnp.pad(vp, ((0, 0), (0, pad)))
    fn = partial(
        _rolling_single,
        window=window,
        min_periods=min_periods,
        alpha=alpha,
        positional=positional,
        chunk=chunk,
    )
    coefs = jax.vmap(fn)(Xp.astype(F64), yp.astype(F64), vp)
    return coefs[:, :R]
