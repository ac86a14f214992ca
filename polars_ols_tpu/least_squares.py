"""Public compute functions and kwargs dataclasses.

API-parity layer with the reference's polars_ols/least_squares.py: same
function names, same kwargs dataclasses with the same defaults and
validation (least_squares.py:47-160), same pre-processing (intercept
injection and sqrt-weight WLS scaling, :163-196) — but the expressions are
built on the engine's AST and evaluate as batched JAX programs.
"""

from __future__ import annotations

import logging
from dataclasses import asdict, dataclass
from functools import partial
from typing import Any, Dict, List, Literal, Optional, Set, Union, get_args

from .expr import (
    Expr,
    LeastSquaresExpr,
    PredictExpr,
    lit,
    parse_into_expr,
)

logger = logging.getLogger(__name__)

__all__ = [
    "compute_least_squares",
    "compute_recursive_least_squares",
    "compute_rolling_least_squares",
    "compute_least_squares_from_formula",
    "compute_multi_target_least_squares",
    "predict",
    "OLSKwargs",
    "RLSKwargs",
    "RollingKwargs",
    "NullPolicy",
    "OutputMode",
    "SolveMethod",
]

ExprOrStr = Union[Expr, str]

NullPolicy = Literal["zero", "drop", "ignore", "drop_zero", "drop_y_zero_x", "drop_window"]
OutputMode = Literal["predictions", "residuals", "coefficients", "statistics"]
SolveMethod = Literal["qr", "svd", "chol", "lu", "cd", "cd_active_set"]

_VALID_NULL_POLICIES: Set[str] = set(get_args(NullPolicy))
_VALID_OUTPUT_MODES: Set[str] = set(get_args(OutputMode))
_VALID_SOLVE_METHODS: Set[Optional[str]] = set(get_args(SolveMethod)).union({None})


@dataclass
class Kwargs:
    null_policy: str = "ignore"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def __post_init__(self):
        assert self.null_policy in _VALID_NULL_POLICIES, (
            f"unknown null_policy {self.null_policy!r}; "
            f"expected one of {sorted(_VALID_NULL_POLICIES)}"
        )


@dataclass
class OLSKwargs(Kwargs):
    """Parameters for regularized linear models (reference least_squares.py:80-118).

    Attributes:
        alpha: Regularization strength. Defaults to 0.0.
        l1_ratio: ElasticNet mixing (0 ridge, 1 lasso). Defaults to None (ridge).
        max_iter: Maximum coordinate-descent iterations. Defaults to 1000.
        tol: Convergence tolerance. Defaults to 1e-5.
        positive: Enforce non-negative coefficients (NNLS). Defaults to False.
        null_policy: Missing-data strategy. Defaults to "ignore".
        solve_method: one of qr/svd/chol/lu/cd/cd_active_set or None (auto).
        rcond: SVD small-singular-value cutoff; None -> numpy lstsq default.
    """

    alpha: Optional[float] = 0.0
    l1_ratio: Optional[float] = None
    max_iter: Optional[int] = 1_000
    tol: Optional[float] = 1.0e-5
    positive: Optional[bool] = False
    solve_method: Optional[str] = None
    rcond: Optional[float] = None

    def __post_init__(self):
        valid_ols_policies = _VALID_NULL_POLICIES - {"drop_window"}
        assert self.null_policy in valid_ols_policies, (
            f"unknown null_policy {self.null_policy!r} for a static fit; "
            f"expected one of {sorted(valid_ols_policies)}"
        )
        assert self.solve_method in _VALID_SOLVE_METHODS, (
            f"unknown solve_method {self.solve_method!r}; "
            f"expected one of {sorted(s for s in _VALID_SOLVE_METHODS if s)} or None"
        )


@dataclass
class RLSKwargs(Kwargs):
    """Recursive least squares parameters (reference least_squares.py:121-140)."""

    half_life: Optional[float] = None
    initial_state_covariance: Optional[float] = 10.0
    initial_state_mean: Union[Optional[List[float]], float] = None
    null_policy: str = "drop"


@dataclass
class RollingKwargs(Kwargs):
    """Rolling OLS parameters (reference least_squares.py:143-160).

    `use_woodbury` is accepted for API parity; the engine's batched
    prefix-sum kernel solves every window directly, so it is a no-op.
    """

    window_size: int = 1_000_000  # defaults to expanding OLS
    min_periods: Optional[int] = None
    use_woodbury: Optional[bool] = None
    alpha: Optional[float] = None
    null_policy: str = "drop_window"


def _pre_process_data(
    target: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr],
    add_intercept: bool,
):
    """Parse inputs and decide intercept injection (reference
    least_squares.py:163-196).

    Unlike the reference — which expands the intercept and the sqrt-weight
    WLS scaling into per-column expressions, paying one kernel per feature —
    both are folded into the engine's fused device programs (engine/fit.py):
    the const column joins the cached column stack and every column
    (intercept included, as in the reference) is scaled by sqrt(w) in a
    single device op. Numerically identical to the pre-scaled formulation.
    """
    target = parse_into_expr(target)
    features = [parse_into_expr(f) for f in features]
    add_const = False
    if add_intercept:
        if any(f.meta.output_name == "const" for f in features):
            logger.info("a 'const' column is present among the features; treating it as the intercept")
        else:
            add_const = True
    weights: Optional[Expr] = None
    if sample_weights is not None:
        weights = parse_into_expr(sample_weights)
    return target, features, weights, add_const


def _build_least_squares_expr(
    target: ExprOrStr,
    *features: ExprOrStr,
    mode: str,
    function_name: str,
    ols_kwargs: Kwargs,
    multi_target: bool = False,
    **kwargs,
) -> Expr:
    """Equivalent of the reference's `_register_least_squares_plugin`
    (least_squares.py:199-239). The engine returns already-unscaled
    predictions for weighted fits, so the only expression-level post-step
    left is the residual subtraction (reference :236-239, which likewise
    computes residuals against the unscaled target)."""
    target = parse_into_expr(target)
    target_fit, features_fit, weights, add_const = _pre_process_data(
        target, *features, **kwargs
    )
    if mode in ("coefficients", "statistics"):
        return LeastSquaresExpr(
            function_name, target_fit, features_fit, ols_kwargs, mode,
            multi_target=multi_target, weights=weights, add_intercept=add_const,
        ).alias(mode)
    predictions = LeastSquaresExpr(
        function_name, target_fit, features_fit, ols_kwargs, "predictions",
        multi_target=multi_target, weights=weights, add_intercept=add_const,
    )
    if mode == "predictions":
        return predictions
    return target - predictions  # residuals


def compute_least_squares(
    target: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    ols_kwargs: Optional[OLSKwargs] = None,
) -> Expr:
    """OLS/WLS/regularized least squares (reference least_squares.py:242-279)."""
    assert mode in _VALID_OUTPUT_MODES, (
        f"unknown mode {mode!r}; expected one of {sorted(_VALID_OUTPUT_MODES)}"
    )
    ols_kwargs = ols_kwargs or OLSKwargs()
    return _build_least_squares_expr(
        target,
        *features,
        mode=mode,
        function_name="least_squares",
        ols_kwargs=ols_kwargs,
        sample_weights=sample_weights,
        add_intercept=add_intercept,
    )


def compute_multi_target_least_squares(
    targets: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    ols_kwargs: Optional[OLSKwargs] = None,
) -> Expr:
    """Multi-target regression over a struct target: one shared SVD serves
    all M targets (reference least_squares.py:282-329)."""
    ols_kwargs = ols_kwargs or OLSKwargs()
    multi_target_conditions = not ols_kwargs.positive and (
        ols_kwargs.l1_ratio is None or ols_kwargs.l1_ratio == 0.0
    )
    msg = " Fit each target with its own expression instead."
    assert multi_target_conditions, (
        "multi-target fits support only unconstrained OLS/Ridge (shared SVD)." + msg
    )
    assert ols_kwargs.solve_method in {
        "svd",
        None,
    }, "multi-target fits solve through the shared SVD; pass solve_method='svd' or None"
    if mode not in ("predictions", "residuals"):
        raise NotImplementedError(
            "multi-target mode must be 'predictions' or 'residuals'." + msg
        )
    if ols_kwargs.solve_method is None:
        ols_kwargs.solve_method = "svd"
    return _build_least_squares_expr(
        targets,
        *features,
        mode=mode,
        function_name="least_squares",
        ols_kwargs=ols_kwargs,
        sample_weights=sample_weights,
        add_intercept=add_intercept,
        multi_target=True,
    )


def compute_recursive_least_squares(
    target: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    rls_kwargs: Optional[RLSKwargs] = None,
) -> Expr:
    """Recursive least squares (reference least_squares.py:332-369)."""
    valid_output_modes = _VALID_OUTPUT_MODES - {"statistics"}
    assert mode in valid_output_modes, (
        f"unknown mode {mode!r}; expected one of {sorted(valid_output_modes)}"
    )
    rls_kwargs = rls_kwargs or RLSKwargs()
    return _build_least_squares_expr(
        target,
        *features,
        mode=mode,
        function_name="recursive_least_squares",
        ols_kwargs=rls_kwargs,
        sample_weights=sample_weights,
        add_intercept=add_intercept,
    )


def compute_rolling_least_squares(
    target: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    rolling_kwargs: Optional[RollingKwargs] = None,
) -> Expr:
    """Rolling-window least squares (reference least_squares.py:372-409)."""
    valid_output_modes = _VALID_OUTPUT_MODES - {"statistics"}
    assert mode in valid_output_modes, (
        f"unknown mode {mode!r}; expected one of {sorted(valid_output_modes)}"
    )
    rolling_kwargs = rolling_kwargs or RollingKwargs()
    expr = _build_least_squares_expr(
        target,
        *features,
        mode=mode,
        function_name="rolling_least_squares",
        ols_kwargs=rolling_kwargs,
        sample_weights=sample_weights,
        add_intercept=add_intercept,
    )
    if mode == "residuals":
        # warm-up NaNs -> nulls (:407-409). For predictions the engine
        # folds the NaN->null conversion into the fused query program (an
        # expression-level pass would cost a separate device program).
        expr = expr.fill_nan(None)
    return expr


def compute_least_squares_from_formula(
    formula: str,
    sample_weights: Optional[ExprOrStr] = None,
    mode: str = "predictions",
    **kwargs,
) -> Expr:
    """Formula API dispatching on half_life/window_size kwargs (reference
    least_squares.py:412-452)."""
    from .utils import build_expressions_from_patsy_formula

    expressions, add_intercept = build_expressions_from_patsy_formula(
        formula, include_dependent_variable=True
    )
    if kwargs.get("half_life"):
        func = partial(compute_recursive_least_squares, rls_kwargs=RLSKwargs(**kwargs))
    elif kwargs.get("window_size"):
        func = partial(compute_rolling_least_squares, rolling_kwargs=RollingKwargs(**kwargs))
    else:
        func = partial(compute_least_squares, ols_kwargs=OLSKwargs(**kwargs))
    return func(
        expressions[0],
        *expressions[1:],
        add_intercept=add_intercept,
        sample_weights=sample_weights,
        mode=mode,
    )


def predict(
    coefficients: ExprOrStr,
    *features: ExprOrStr,
    null_policy: str = "zero",
    add_intercept: bool = False,
    name: Optional[str] = None,
) -> Expr:
    """Row-aligned coefficient-struct dot features (reference
    least_squares.py:455-491)."""
    # the reference's predict entry point handles exactly zero/ignore/drop
    # (src/expressions.rs:706-741); reject the fit-only policies up front
    # rather than silently treating them as "zero".
    assert null_policy in {"zero", "ignore", "drop"}, (
        f"unknown null_policy {null_policy!r}; predict supports drop/ignore/zero"
    )
    coefficients = parse_into_expr(coefficients)
    features = [parse_into_expr(f) for f in features]
    if add_intercept:
        if any(f.meta.output_name == "const" for f in features):
            logger.warning("a 'const' column is present among the features; treating it as the intercept")
        else:
            features.append(lit(1.0).alias("const"))
    return PredictExpr(coefficients, features, null_policy, name or "predictions")
