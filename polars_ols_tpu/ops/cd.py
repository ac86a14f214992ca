"""Cyclic coordinate descent for Lasso / ElasticNet / NNLS, batched over groups.

Sweep-for-sweep equivalent of the reference's `solve_elastic_net`
(src/least_squares.rs:386-492): the objective is
``1/(2n)||y - Xw||^2 + alpha*l1*||w||_1 + 0.5*alpha*(1-l1)*||w||^2``
(alpha internally scaled by the number of *valid* samples, :419), updates are
cyclic with naive residual add-back/subtract (:423-434) and convergence is
``||w - w_old||_2 < tol`` (:436-445).

Device formulation: a `lax.while_loop` over sweeps containing a `lax.fori_loop`
over coordinates, vmapped over the group axis. Excluded rows arrive zeroed so
they contribute nothing to any inner product. The `cd_active_set` variant of
the reference (:447-488) permanently removes a coordinate from the sweep the
first time its update lands below ``tol`` in absolute value; here the same
iterate sequence is reproduced with a frozen-coordinate mask (removal is a
CPU work-saving device — on a vector machine every lane runs either way, so
the mask costs nothing and preserves the reference's exact update order).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

F64 = jnp.float64


def _soft_threshold(x: jnp.ndarray, alpha: float, positive: bool) -> jnp.ndarray:
    """sign(x) * max(|x| - alpha, 0), clamped at 0 when positive
    (src/least_squares.rs:373-379)."""
    out = jnp.sign(x) * jnp.maximum(jnp.abs(x) - alpha, 0.0)
    if positive:
        out = jnp.maximum(out, 0.0)
    return out


def _cd_single(
    Xt: jnp.ndarray,  # [K, R] transposed padded features (masked rows zeroed)
    y: jnp.ndarray,  # [R]
    n_valid: jnp.ndarray,  # scalar
    alpha: float,
    l1_ratio: float,
    max_iter: int,
    tol: float,
    positive: bool,
) -> jnp.ndarray:
    k = Xt.shape[0]
    a = alpha * jnp.maximum(n_valid, 1.0)  # alpha *= n_samples (:419)
    a_l1 = a * l1_ratio
    a_l2 = a * (1.0 - l1_ratio)
    col_sq = jnp.sum(Xt * Xt, axis=1)  # [K] x_j^T x_j

    def coord_body(j, carry):
        w, r = carry
        x_j = lax.dynamic_index_in_dim(Xt, j, keepdims=False)  # [R]
        w_j = lax.dynamic_index_in_dim(w, j, keepdims=False)
        r = r + x_j * w_j  # add back current contribution
        rho = jnp.dot(x_j, r, preferred_element_type=F64)
        denom = col_sq[j] + a_l2
        w_j_new = _soft_threshold(rho, a_l1, positive) / jnp.where(denom > 0, denom, 1.0)
        r = r - x_j * w_j_new
        w = lax.dynamic_update_index_in_dim(w, w_j_new, j, axis=0)
        return w, r

    def sweep(state):
        w, r, it, _ = state
        w_new, r_new = lax.fori_loop(0, k, coord_body, (w, r))
        delta = jnp.linalg.norm(w_new - w)
        return w_new, r_new, it + 1, delta

    def cond(state):
        _, _, it, delta = state
        return (it < max_iter) & (delta >= tol)

    w0 = jnp.zeros(k, dtype=F64)
    w, _, _, _ = lax.while_loop(cond, sweep, (w0, y, jnp.int32(0), jnp.asarray(jnp.inf, F64)))
    return w


def _coord_update(XtX, Xty, a_l1, a_l2, positive):
    """The reference's cyclic coordinate update on the covariance form
    (src/least_squares.rs:423-434): w_j <- S(x_j'r + XtX_jj w_j, a_l1) /
    (XtX_jj + a_l2). Shared by the cyclic solver and the FISTA polish so
    the two paths can never diverge on the update rule."""
    diag = jnp.diagonal(XtX)

    def update(j, w):
        # x_j^T r + XtX_jj w_j  ==  Xty_j - (XtX w)_j + XtX_jj w_j
        rho = Xty[j] - jnp.dot(XtX[j], w) + diag[j] * w[j]
        denom = diag[j] + a_l2
        return _soft_threshold(rho, a_l1, positive) / jnp.where(denom > 0, denom, 1.0)

    return update


def _cd_cov_single(
    XtX: jnp.ndarray,  # [K, K]
    Xty: jnp.ndarray,  # [K]
    n_valid: jnp.ndarray,  # scalar
    alpha: float,
    l1_ratio: float,
    max_iter: int,
    tol: float,
    positive: bool,
    active_set: bool = False,
) -> jnp.ndarray:
    K = XtX.shape[0]
    a = alpha * jnp.maximum(n_valid, 1.0)
    a_l1 = a * l1_ratio
    a_l2 = a * (1.0 - l1_ratio)
    update = _coord_update(XtX, Xty, a_l1, a_l2, positive)

    def coord_body(j, carry):
        w, active = carry
        w_j = update(j, w)
        if active_set:
            # frozen coordinates keep their last value; a coordinate whose
            # update lands below tol is removed from every later sweep
            # (reference src/least_squares.rs:459-477)
            w_j = jnp.where(active[j], w_j, w[j])
            active = active.at[j].set(active[j] & (jnp.abs(w_j) >= tol))
        return w.at[j].set(w_j), active

    def sweep(state):
        w, active, it, _ = state
        w_new, active = lax.fori_loop(0, K, coord_body, (w, active))
        return w_new, active, it + 1, jnp.linalg.norm(w_new - w)

    def cond(state):
        _, _, it, delta = state
        return (it < max_iter) & (delta >= tol)

    w0 = jnp.zeros(K, dtype=F64)
    active0 = jnp.ones(K, dtype=bool)
    w, _, _, _ = lax.while_loop(
        cond, sweep, (w0, active0, jnp.int32(0), jnp.asarray(jnp.inf, F64))
    )
    return w


# above this K the cyclic sweep's K sequential coordinate steps (each a
# handful of tiny ops) dominate wall-clock on an accelerator; the accelerated
# proximal-gradient formulation converges in whole-vector iterations instead
_FISTA_MIN_K = 33


def _mv(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """K x K f64 matvec as elementwise+reduce (fuses with its neighbours)."""
    return (M * v[None, :]).sum(axis=1)


def _cd_cov_single_fista(
    XtX: jnp.ndarray,  # [K, K]
    Xty: jnp.ndarray,  # [K]
    n_valid: jnp.ndarray,
    alpha: float,
    l1_ratio: float,
    max_iter: int,
    tol: float,
    positive: bool,
) -> jnp.ndarray:
    """Large-K solver: FISTA with adaptive restart on the covariance form.

    Minimizes the identical objective as `_cd_cov_single` (the reference's
    src/least_squares.rs:386-445, alpha scaled by n_valid) but advances with
    whole-vector proximal-gradient steps — one K x K matvec + soft-threshold
    per iteration — instead of K sequential coordinate updates per sweep.
    The elastic-net objective is convex (strongly so for l2 > 0), so both
    iterations share their fixed points. Inner stopping is 20x tighter than
    `tol`; the caller then snaps exact support-wise optimality with the
    batched `_active_set_polish` (which replaced the earlier 2-sweep cyclic
    polish — same fixed point, no K-deep sequential chain)."""
    K = XtX.shape[0]
    a = alpha * jnp.maximum(n_valid, 1.0)
    a_l1 = a * l1_ratio
    a_l2 = a * (1.0 - l1_ratio)

    # step size 1/L, L = lambda_max(XtX) + a_l2 via power iteration
    def pw(_, v):
        v = _mv(XtX, v)
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-300)

    v0 = jnp.full(K, 1.0 / jnp.sqrt(K), dtype=F64)
    v = lax.fori_loop(0, 24, pw, v0)
    L = jnp.vdot(v, _mv(XtX, v)) * 1.02 + a_l2 + 1e-300

    inner_tol = tol * 0.05

    def body(state):
        w, z, t, it, _ = state
        grad = _mv(XtX, z) - Xty + a_l2 * z
        w_new = _soft_threshold(z - grad / L, a_l1 / L, positive)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        z_new = w_new + ((t - 1.0) / t_new) * (w_new - w)
        # adaptive restart (O'Donoghue-Candes gradient scheme)
        restart = jnp.vdot(z - w_new, w_new - w) > 0.0
        z_new = jnp.where(restart, w_new, z_new)
        t_new = jnp.where(restart, 1.0, t_new)
        return w_new, z_new, t_new, it + 1, jnp.linalg.norm(w_new - w)

    def cond(state):
        _, _, _, it, delta = state
        return (it < 4 * max_iter) & (delta >= inner_tol)

    w0 = jnp.zeros(K, dtype=F64)
    w, _, _, _, _ = lax.while_loop(
        cond, body, (w0, w0, jnp.asarray(1.0, F64), jnp.int32(0), jnp.asarray(jnp.inf, F64))
    )
    return w


def _active_set_polish(
    XtX: jnp.ndarray,  # [G, K, K] f64
    Xty: jnp.ndarray,  # [G, K]
    a_l1: jnp.ndarray,  # [G] sample-scaled l1 strength
    a_l2: jnp.ndarray,  # [G] sample-scaled l2 strength
    w: jnp.ndarray,  # [G, K] FISTA iterate (exact zeros off-support)
    positive: bool,
) -> jnp.ndarray:
    """Newton polish on the FISTA support: one batched PSD solve instead of
    the 2K-link cyclic sweep chain.

    On a fixed support A with signs s, the elastic-net optimum solves
    ``(XtX_AA + a_l2 I) w_A = Xty_A - a_l1 s_A`` exactly (the stationarity
    condition of the reference's objective, src/least_squares.rs:386-445,
    with the soft-threshold subgradient resolved by s). The cyclic polish
    sweeps this replaces are a K-step sequential dependency chain whose
    wall-clock is per-op dispatch latency, not math (~65 us/link on the
    benchmark backend — 200 links at K=100); the solve here is one batched
    Cholesky. Round 1 solves on the FISTA support and zeroes any coordinate
    whose solved sign contradicts its subgradient sign; a second round —
    admitting inactive coordinates whose KKT residual ``|Xty - XtX w -
    a_l2 w| > a_l1`` demands activation and re-solving — runs under a
    scalar ``lax.cond`` only when round 1 actually changed the support
    (FISTA at 20x-tight inner tol almost always identifies it exactly, and
    each round is a batch of small sequential device ops).
    A monotone safeguard makes the polish never-worse lane-wise: the
    result is kept only where it does not increase the elastic-net
    objective over the incoming FISTA iterate. This is what protects the
    wide underdetermined pure-lasso case (n << K, a_l2 = 0): the masked
    system is rank-deficient there, its eigh-pinv least-squares solution
    need not be a stationary point when the sign vector carries
    small-coordinate errors, and the FISTA iterate itself is already the
    better answer."""
    from .linalg import solve_psd

    K = XtX.shape[-1]
    eye = jnp.eye(K, dtype=F64)
    B = XtX + a_l2[:, None, None] * eye

    def objective(w):  # [G] covariance-form EN objective (constant dropped)
        Aw = (XtX * w[:, None, :]).sum(-1)
        return (
            0.5 * (w * Aw).sum(-1)
            - (Xty * w).sum(-1)
            + a_l1 * jnp.abs(w).sum(-1)
            + 0.5 * a_l2 * (w * w).sum(-1)
        )

    def solve_on_support(w):
        s = (w > 0.0).astype(F64) if positive else jnp.sign(w)
        m = jnp.abs(s)
        A = B * (m[:, :, None] * m[:, None, :])
        A = A + eye * (1.0 - m)[:, :, None]  # identity rows off-support
        rhs = (Xty - a_l1[:, None] * s) * m
        w_new = solve_psd(A, rhs)
        shrunk = (m > 0.0) & (s * w_new <= 0.0)
        return jnp.where(shrunk, 0.0, w_new), shrunk.any()

    w_in = w
    w, any_shrunk = solve_on_support(w)
    rho = Xty - (XtX * w[:, None, :]).sum(-1) - a_l2[:, None] * w
    tol_pad = 1.0 + 1e-12
    if positive:
        viol = (w == 0.0) & (rho > a_l1[:, None] * tol_pad)
    else:
        viol = (w == 0.0) & (jnp.abs(rho) > a_l1[:, None] * tol_pad)

    def second_round(w):
        seeded = jnp.where(viol, jnp.sign(rho), w)  # admit with the KKT sign
        return solve_on_support(seeded)[0]

    w = lax.cond(any_shrunk | viol.any(), second_round, lambda w: w, w)
    # monotone safeguard: NaN objectives compare False and keep the FISTA w
    better = objective(w) <= objective(w_in)
    return jnp.where(better[:, None], w, w_in)


@partial(
    jax.jit,
    # alpha/l1_ratio are traced operands: one compiled program serves every
    # regularization strength (they enter the update rule arithmetically)
    static_argnames=("max_iter", "tol", "positive", "active_set"),
)
def solve_elastic_net_cov(
    XtX: jnp.ndarray,  # [G, K, K]
    Xty: jnp.ndarray,  # [G, K]
    n_valid: jnp.ndarray,  # [G]
    alpha: float,
    l1_ratio: float = 0.5,
    max_iter: int = 1000,
    tol: float = 1e-5,
    positive: bool = False,
    active_set: bool = False,
) -> jnp.ndarray:
    """Covariance-form cyclic coordinate descent on precomputed moments.

    Produces the SAME iterate sequence as the reference's naive residual
    updates (src/least_squares.rs:423-434) — x_j^T r expands to
    Xty_j - (XtX w)_j + XtX_jj w_j — but each coordinate step is O(K) on
    the moment matrices instead of O(n) over the row data (the classic
    n >> k "precompute" formulation, cf. sklearn's Gram variant). Combined
    with the engine's int8-digit moment accumulation this removes every
    per-sweep pass over the rows.

    Above ``_FISTA_MIN_K`` features the sequential K-step sweeps give way to
    accelerated proximal-gradient iterations (same fixed point, CD-polished;
    see `_cd_cov_single_fista`) — at K=100 the cyclic sweep spends its time
    in per-coordinate op dispatch, not math. ``active_set`` always runs the
    cyclic form (the reference's active-set variant is defined by its
    coordinate update order, src/least_squares.rs:447-488)."""
    XtX64 = XtX.astype(F64)
    Xty64 = Xty.astype(F64)
    nv64 = n_valid.astype(F64)
    if active_set:
        single = partial(_cd_cov_single, active_set=True)
    elif XtX.shape[-1] < _FISTA_MIN_K:
        single = _cd_cov_single
    else:
        fn = partial(
            _cd_cov_single_fista,
            alpha=alpha,
            l1_ratio=l1_ratio,
            max_iter=max_iter,
            tol=tol,
            positive=positive,
        )
        w = jax.vmap(fn)(XtX64, Xty64, nv64)
        a = alpha * jnp.maximum(nv64, 1.0)
        # polish batched OUTSIDE the vmap: solve_psd's eigh-pinv fallback
        # stays behind a scalar lax.cond (vmapping it would turn the cond
        # into a select and run the eigh for every lane every time)
        return _active_set_polish(
            XtX64, Xty64, a * l1_ratio, a * (1.0 - l1_ratio), w, positive
        )
    fn = partial(
        single,
        alpha=alpha,
        l1_ratio=l1_ratio,
        max_iter=max_iter,
        tol=tol,
        positive=positive,
    )
    return jax.vmap(fn)(XtX64, Xty64, nv64)


@partial(jax.jit, static_argnames=("max_iter", "tol", "positive"))
def solve_elastic_net(
    Xp: jnp.ndarray,  # [G, R, K]
    yp: jnp.ndarray,  # [G, R]
    n_valid: jnp.ndarray,  # [G]
    alpha: float,
    l1_ratio: float = 0.5,
    max_iter: int = 1000,
    tol: float = 1e-5,
    positive: bool = False,
) -> jnp.ndarray:
    """Batched elastic-net fit -> coefficients [G, K]."""
    Xt = jnp.swapaxes(Xp, -1, -2).astype(F64)
    fn = partial(
        _cd_single,
        alpha=alpha,
        l1_ratio=l1_ratio,
        max_iter=max_iter,
        tol=tol,
        positive=positive,
    )
    return jax.vmap(fn)(Xt, yp.astype(F64), n_valid.astype(F64))
