"""Fused multi-query select: N independent fit expressions in ONE program.

M eager queries pay M program dispatches and M sets of host planning;
M problems fused into a single XLA program pay one dispatch, and XLA can
share the subcomputations they have in common (the moments of a shared
design, for one).

Mechanism: jitted kernels inline when called inside another trace, so a
`select()` holding several fusable fit expressions plans each one eagerly
(reusing every device-resident cache — stacks, padded partitions, digit
planes — exactly like the eager path), then calls the SAME inner kernels
under one outer ``jax.jit``. The cached prep arrays become the outer
program's traced arguments; per-expression statics (solver, mode, policy)
key the outer program cache. Anything not fusable (moving models,
statistics, multi-target, struct targets, exotic policies) falls back to
eager evaluation of the whole select — behavior is identical by
construction, only the number of device programs changes.

This is the engine's replacement for amortizing the reference's per-call
pyO3 overhead across a multi-expression ``select`` (the polars engine runs
plugin expressions on rayon threads; here the batch axis is the program).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import CONFIG

F64 = jnp.float64

# outer programs keyed on the tuple of per-query statics; jax.jit handles
# re-tracing on shape/dtype changes underneath each entry
_RUNNERS: Dict[tuple, Any] = {}


def clear_programs() -> None:
    _RUNNERS.clear()


@dataclass
class _Plan:
    statics: tuple  # hashable; selects the traced kernel + post ops
    args: tuple  # concrete device arrays -> outer program's traced inputs
    wrap: Callable[[Any], Any]  # kernel output -> AnySeries (host side)


def _apply_one(statics: tuple, args: tuple):
    """Traced body for one planned query: the same inner kernels the eager
    path dispatches, inlined into the outer program."""
    from .fit import (
        _blocks_fit_kernel,
        _blocks_fit_kernel_ozaki,
        _blocks_statistics_kernel,
        _moving_query_kernel,
        _svd_fit_kernel,
    )

    kind = statics[0]
    if kind == "stats":
        (_, G, cd_params, ridge) = statics
        Zp, digits, scales, wp, bg, alpha = args
        return _blocks_statistics_kernel(
            Zp, digits, scales, wp, bg, G, alpha,
            cd_params=cd_params, ridge=ridge,
        )
    if kind == "moving":
        (_, model, params, k, nan_to_null, lazy, pair) = statics
        Xp, yp, vp, unpad_idx, predict_valid, inv_w = args
        return _moving_query_kernel(
            Xp, yp, vp, unpad_idx, predict_valid, inv_w,
            model=model, params=params, k=k, nan_to_null=nan_to_null,
            lazy=lazy, pair=pair,
        )
    if kind == "blocks":
        (_, G, want, cd_params, force_refine, svd_guard, lu, ozaki, post) = statics
        if ozaki:
            Zp, digits, scales, wp, bg, up, gids, alpha = args[:8]
            extra = args[8:]
            out = _blocks_fit_kernel_ozaki(
                Zp, digits, scales, wp, bg, up, gids,
                num_groups=G, alpha=alpha, want=want, cd_params=cd_params,
                force_refine=force_refine, svd_guard=svd_guard, lu=lu,
            )
        else:
            Zp, wp, bg, up, gids, alpha = args[:6]
            extra = args[6:]
            out = _blocks_fit_kernel(
                Zp, wp, bg, up, gids,
                num_groups=G, alpha=alpha, want=want, cd_params=cd_params,
                force_refine=force_refine, svd_guard=svd_guard, lu=lu,
            )
    else:  # "svd": explicit-SVD fit on the cached padded layout
        (_, G, n, rcond, want, use_lanes, post) = statics
        Xp, yp, vp, gids, alpha = args[:5]
        extra = args[5:]
        kernel_want = want if want in ("beta", "rows") else "preds"
        out = _svd_fit_kernel(
            Xp, yp, vp, gids,
            num_groups=G, alpha=alpha, rcond=rcond, want=kernel_want,
            use_lanes=use_lanes,
        )
        if want == "preds":  # padded [G, R] -> row order [N]
            if G == 1:
                out = out[0][:n]
            else:
                up = extra[0]
                extra = extra[1:]
                out = jnp.take(out.reshape(-1), up, axis=0)
        elif want == "preds_flat":
            out = out.reshape(-1)
    if post == "invw":
        out = out * extra[0]
    elif post == "resid":
        out = extra[0] - out
    elif post == "invw_resid":
        out = extra[1] - out * extra[0]
    return out


def _get_runner(sig: tuple):
    """sig is a tuple of per-query (statics, arg_indices): arg_indices map
    into a DEDUPLICATED flat argument list. Queries sharing input arrays
    (the same cached partition under several alphas, the same weight
    vector, ...) reference one program parameter, so XLA's CSE folds their
    shared subcomputations — an 8-alpha ridge sweep computes its moment
    matrices once, not eight times."""
    runner = _RUNNERS.get(sig)
    if runner is None:

        @jax.jit
        def runner(unique_args):
            return tuple(
                _apply_one(statics, tuple(unique_args[i] for i in idxs))
                for statics, idxs in sig
            )

        _RUNNERS[sig] = runner
    return runner


def _unwrap(expr):
    """Peel alias / over wrappers; returns (core_expr, alias, over_keys)."""
    from ..expr import AliasExpr, OverExpr

    alias = None
    keys = None
    while True:
        if isinstance(expr, AliasExpr):
            alias = alias or expr.name
            expr = expr.inner
        elif isinstance(expr, OverExpr):
            if keys is not None:
                return None, None, None  # nested over: not fusable
            keys = expr.keys
            expr = expr.inner
        else:
            return expr, alias, keys


def _plan_expr(df, expr) -> Optional[_Plan]:
    """Plan one expression for fusion, or None (eager fallback). Planning
    runs exactly the eager path's prep (same caches, same layouts); only the
    final kernel dispatch is deferred into the shared program."""
    from ..expr import BinExpr, LeastSquaresExpr
    from ..series import Series
    from .fit import (
        _blocks_cached,
        _const_series,
        _padded_cached,
        _resolve_method,
        _split_layout,
        _stack_cached,
        _weighted_stack_cached,
    )
    from .groups import layout_for_columns, single_layout

    core, alias, keys = _unwrap(expr)
    if core is None:
        return None

    resid_target = None
    if isinstance(core, BinExpr) and core.op == "-" and isinstance(
        core.right, LeastSquaresExpr
    ):
        resid_target = core.left
        core = core.right
    if not isinstance(core, LeastSquaresExpr):
        return None
    moving = core.function_name in (
        "recursive_least_squares", "rolling_least_squares"
    )
    if core.multi_target or (resid_target is not None and core.mode != "predictions"):
        return None
    if moving:
        if core.mode != "predictions" or resid_target is not None:
            return None
    elif core.function_name != "least_squares" or core.mode not in (
        "predictions", "coefficients", "statistics"
    ):
        return None

    # ---- eager prep (identical to LeastSquaresExpr.evaluate) ----
    feats = []
    for f in core.features:
        feats.extend(f.expand(df))
    if keys is not None:
        layout_in = layout_for_columns([df.get_column(k) for k in keys])
    else:
        layout_in = None
    target = core.target.evaluate(df, layout_in)
    if not isinstance(target, Series):
        return None
    feat_series = [f.evaluate(df, layout_in) for f in feats]
    weights = core.weights.evaluate(df, layout_in) if core.weights is not None else None

    n = len(target)
    if core.add_intercept:
        feat_series = list(feat_series) + [_const_series(target, n)]
    k = len(feat_series)
    kwargs = core.kwargs
    policy = kwargs.null_policy
    layout = layout_in if layout_in is not None else single_layout(n)
    G = layout.num_groups
    if G > 1 and CONFIG.auto_shard and jax.device_count() > 1:
        return None  # the eager path routes these through the sharded engine
    mode = core.mode
    out_name = target.name
    if moving:
        return _plan_moving(
            core, kwargs, target, feat_series, weights, layout, G, k, alias,
            out_name, policy,
        )
    alpha = jnp.asarray(float(kwargs.alpha or 0.0), dtype=F64)
    method = _resolve_method(layout, kwargs, k)
    names = [s.name for s in feat_series]

    inv_w = None
    if weights is not None:
        vals, valid, _, inv_w = _weighted_stack_cached(target, feat_series, weights)
    else:
        vals, valid = _stack_cached(target, feat_series)

    resid_vals = None
    if resid_target is not None:
        # keep residual fusion to the fully-valid case: eager residuals go
        # through Series subtraction with null propagation
        if valid is not None or (weights is not None and weights.validity is not None):
            return None
        t = resid_target.evaluate(df, layout_in)
        if not isinstance(t, Series) or t.validity is not None:
            return None
        resid_vals = jnp.asarray(t.values, dtype=F64)

    cd_params = None
    if method in ("cd", "cd_active_set"):
        cd_params = (
            float(0.5 if kwargs.l1_ratio is None else kwargs.l1_ratio),
            int(kwargs.max_iter or 1000),
            float(kwargs.tol if kwargs.tol is not None else 1e-5),
            bool(kwargs.positive),
            method == "cd_active_set",
        )

    if mode == "statistics":
        if method not in ("chol", "lu", "qr", "cd", "cd_active_set"):
            return None  # explicit-svd statistics: general eager path
        Zp, wp, _, block_group, digits, scales = _blocks_cached(
            layout, vals, valid, policy
        )
        statics = ("stats", G, cd_params, float(kwargs.alpha or 0.0) > 0.0)
        args = (Zp, digits, scales, wp, block_group, alpha)

        def wrap_stats(out, *, names=names, layout=layout,
                       layout_in=layout_in, alias=alias):
            from .fit import _statistics_series

            s = _statistics_series(dict(out), names, layout, layout_in)
            return s.alias(alias) if alias else s

        return _Plan(statics, args, wrap_stats)

    svd_single = (
        method == "svd"
        and G == 1
        and k > 8
        and kwargs.rcond is None
        and n > k
    )
    if method in ("chol", "lu", "cd", "cd_active_set", "qr") or svd_single:
        if not (valid is None or policy in ("zero", "ignore", "drop")):
            return None
        force_refine = method in ("qr", "svd")
        lu = method == "lu"
        r_cap = _split_layout(layout)[1].shape[1]
        Zp, wp, predict_valid, block_group, digits, scales = _blocks_cached(
            layout, vals, valid, policy
        )
        up = layout.device_split_unpad(r_cap)
        gids = layout.device_gids()
        ozaki = digits is not None

        lazy = (
            mode == "predictions"
            and G > 1
            and CONFIG.lazy_row_order
            and inv_w is None
            and resid_vals is None
        )
        if mode == "coefficients":
            want = "beta" if layout_in is None else "rows"
        elif lazy:
            want = "preds_flat"
        else:
            want = "preds"

        post = "none"
        extra: tuple = ()
        if want == "preds":
            if inv_w is not None and resid_vals is not None:
                post, extra = "invw_resid", (inv_w, resid_vals)
            elif inv_w is not None:
                post, extra = "invw", (inv_w,)
            elif resid_vals is not None:
                post, extra = "resid", (resid_vals,)

        statics = (
            "blocks", G, want, cd_params, force_refine, svd_single, lu,
            ozaki, post,
        )
        if ozaki:
            args = (Zp, digits, scales, wp, block_group, up, gids, alpha) + extra
        else:
            args = (Zp, wp, block_group, up, gids, alpha) + extra

        def wrap(out, *, want=want, names=names, out_name=out_name,
                 predict_valid=predict_valid, layout=layout, r_cap=r_cap,
                 alias=alias, resid=resid_vals is not None):
            return _wrap_blocks(
                out, want, names, out_name, predict_valid, layout, r_cap,
                alias, resid,
            )

        return _Plan(statics, args, wrap)

    if method == "svd" and mode in ("predictions", "coefficients"):
        if not (valid is None or policy in ("zero", "drop")):
            return None
        Xp, yp, vp, predict_valid = _padded_cached(
            layout, vals, valid, policy, moving=False
        )
        use_lanes = k <= 8 and G >= 64 and Xp.shape[1] > k
        gids = layout.device_gids()
        lazy = (
            mode == "predictions"
            and G > 1
            and CONFIG.lazy_row_order
            and inv_w is None
            and resid_vals is None
        )
        if mode == "coefficients":
            want = "beta" if layout_in is None else "rows"
        elif lazy:
            want = "preds_flat"
        else:
            want = "preds"
        post = "none"
        extra = ()
        if want == "preds":
            if G > 1:
                extra = (layout.device_unpad(Xp.shape[1]),)
            if inv_w is not None and resid_vals is not None:
                post, extra = "invw_resid", extra + (inv_w, resid_vals)
            elif inv_w is not None:
                post, extra = "invw", extra + (inv_w,)
            elif resid_vals is not None:
                post, extra = "resid", extra + (resid_vals,)
        statics = ("svd", G, n, kwargs.rcond, want, use_lanes, post)
        args = (Xp, yp, vp, gids, alpha) + extra

        def wrap(out, *, want=want, names=names, out_name=out_name,
                 predict_valid=predict_valid, layout=layout,
                 R=Xp.shape[1], alias=alias, resid=resid_vals is not None):
            return _wrap_padded(
                out, want, names, out_name, predict_valid, layout, R, alias,
                resid,
            )

        return _Plan(statics, args, wrap)

    return None


def _plan_moving(core, kwargs, target, feat_series, weights, layout, G, k,
                 alias, out_name, policy) -> Optional[_Plan]:
    """Plan an RLS/rolling predictions query for fusion: mirrors the eager
    moving fast path (one `_moving_query_kernel` on the cached padded
    layout); anything off that path (coefficients mode, classic blocked
    kernels, sharded runs) falls back to eager."""
    from ..ops.moving import lanes_applicable
    from .fit import _moving_cached, _stack_cached, _weighted_stack_cached

    is_rls = core.function_name == "recursive_least_squares"
    inv_w = None
    if weights is not None:
        vals_m, valid_m, _, inv_w = _weighted_stack_cached(
            target, feat_series, weights
        )
    else:
        vals_m, valid_m = _stack_cached(target, feat_series)
    Xp, yp, vp, predict_valid = _moving_cached(layout, vals_m, valid_m, policy)
    R_pad = Xp.shape[1]
    use_lanes = CONFIG.moving_lanes and lanes_applicable(
        G, R_pad, k,
        kwargs.half_life if is_rls else None,
        rolling=not is_rls,
    )
    shard_ok = (
        CONFIG.auto_shard and jax.device_count() > 1 and use_lanes
        and G >= jax.device_count()
    )
    if not use_lanes or shard_ok:
        return None
    if is_rls:
        # predictions quirk parity: initial_state_mean is ignored
        # (reference src/expressions.rs:624-646 passes None)
        model_params = (
            kwargs.half_life,
            float(
                10.0
                if kwargs.initial_state_covariance is None
                else kwargs.initial_state_covariance
            ),
            None,
        )
    else:
        window_i = int(kwargs.window_size)
        mp = kwargs.min_periods
        positional_q = policy == "drop_window" or (
            valid_m is None and (mp is None or mp <= window_i)
        )
        model_params = (
            window_i, mp, float(kwargs.alpha or 0.0), positional_q,
        )
    lazy_out = G > 1 and CONFIG.lazy_row_order and inv_w is None
    unpad_idx = layout.device_unpad(R_pad) if G > 1 else None
    statics = (
        "moving", "rls" if is_rls else "rolling", model_params, k,
        not is_rls, lazy_out, CONFIG.pair_gather,
    )
    args = (Xp, yp, vp, unpad_idx, predict_valid, inv_w)

    def wrap(out, *, out_name=out_name, lazy=lazy_out, unpad_idx=unpad_idx,
             alias=alias):
        from ..series import BlockPermuted, Series

        flat, validity = out
        if lazy:
            s = Series(
                out_name,
                BlockPermuted(flat, unpad_idx, pair=CONFIG.pair_gather),
                validity,
            )
        else:
            s = Series(out_name, flat, validity)
        return s.alias(alias) if alias else s

    return _Plan(statics, args, wrap)


def _wrap_blocks(out, want, names, out_name, predict_valid, layout, r_cap,
                 alias, resid):
    from ..series import BlockPermuted, Series
    from .fit import _coef_struct

    if want in ("beta", "rows"):
        s = _coef_struct(out, names)
    elif want == "preds_flat":
        lazy = BlockPermuted(
            out, layout.device_split_unpad(r_cap), pair=CONFIG.pair_gather
        )
        s = Series(out_name, lazy, predict_valid)
    else:
        s = Series(out_name, out, None if resid else predict_valid)
    return s.alias(alias) if alias else s


def _wrap_padded(out, want, names, out_name, predict_valid, layout, R, alias,
                 resid):
    from ..series import BlockPermuted, Series
    from .fit import _coef_struct

    if want in ("beta", "rows"):
        s = _coef_struct(out, names)
    elif want == "preds_flat":
        lazy = BlockPermuted(out, layout.device_unpad(R), pair=CONFIG.pair_gather)
        s = Series(out_name, lazy, predict_valid)
    else:
        s = Series(out_name, out, None if resid else predict_valid)
    return s.alias(alias) if alias else s


def try_fused_select(df, exprs: List) -> Optional[List]:
    """Fuse the fusable fit expressions of a multi-expression select into one
    device program. Returns the full result list (order preserved), or None
    when fewer than two expressions are fusable (the caller then evaluates
    everything eagerly, exactly as before)."""
    if not CONFIG.fused_select or len(exprs) < 2:
        return None
    plans: List[Optional[_Plan]] = []
    fusable = 0
    for e in exprs:
        try:
            p = _plan_expr(df, e)
        except Exception:
            # fall back to eager evaluation, which surfaces the real error
            # (or handles the case planning does not model)
            return None
        plans.append(p)
        if p is not None:
            fusable += 1
    if fusable < 2:
        return None
    unique: List = []
    index_of: Dict[int, int] = {}
    sig_parts = []
    for p in plans:
        if p is None:
            continue
        idxs = []
        for a in p.args:
            i = index_of.get(id(a))
            if i is None:
                i = len(unique)
                index_of[id(a)] = i
                unique.append(a)
            idxs.append(i)
        sig_parts.append((p.statics, tuple(idxs)))
    sig = tuple(sig_parts)
    runner = _get_runner(sig)
    outs = runner(tuple(unique))
    results: List = []
    it = iter(outs)
    for e, p in zip(exprs, plans):
        if p is None:
            results.append(e.evaluate(df))
        else:
            results.append(p.wrap(next(it)))
    return results
