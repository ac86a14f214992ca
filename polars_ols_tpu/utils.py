"""Formula parsing and timing utilities.

Replaces the reference's polars_ols/utils.py: patsy is not a dependency
here, so `build_expressions_from_patsy_formula` implements the same subset
of the patsy grammar the reference supports (utils.py:61-108): `~`
separation, `+` terms, interactions `a:b` (products aliased "a:b"),
intercept by default removable with `- 1` / `+ 0`; categorical `C(...)` and
function terms raise, matching the reference's explicit asserts
(utils.py:99-102).
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from functools import lru_cache, reduce
from typing import List, Optional, Tuple

from .expr import Expr, col, parse_into_expr  # noqa: F401  (re-export parity)


@lru_cache
def build_expressions_from_patsy_formula(
    formula: str, include_dependent_variable: bool = False
) -> Tuple[List[Expr], bool]:
    """Parse a patsy-style formula into expressions.

    Example:
        >>> exprs, intercept = build_expressions_from_patsy_formula(
        ...     "y ~ x1 + x2 + x3:x4 - 1", include_dependent_variable=True)
        >>> [e.meta.output_name for e in exprs], intercept
        (['y', 'x1', 'x2', 'x3:x4'], False)

        Term removal works like patsy, left to right (utils.py:86-108 of the
        reference routes through patsy, where `a + b - b` drops `b`):
        >>> exprs, intercept = build_expressions_from_patsy_formula(
        ...     "y ~ x1 + x2 + x3 - x2", include_dependent_variable=True)
        >>> [e.meta.output_name for e in exprs], intercept
        (['y', 'x1', 'x3'], True)
    """
    if include_dependent_variable:
        assert "~" in formula, "formula must contain '~' to include a dependent variable"
        lhs, rhs = formula.split("~", 1)
        lhs_terms = [t.strip() for t in lhs.split("+") if t.strip()]
        assert len(lhs_terms) == 1, "only one dependent variable is supported"
    else:
        rhs = formula.split("~", 1)[-1]
        lhs_terms = []

    add_intercept = True
    terms: List[str] = []
    # tokenize on +/- keeping '-1'/'+0' intercept markers
    for raw in re.split(r"(?=[+-])", rhs.replace(" ", "")):
        t = raw.lstrip("+")
        if not t:
            continue
        if t in ("-1", "+0", "0"):
            add_intercept = False
            continue
        if t == "1":
            add_intercept = True
            continue
        if t.startswith("-"):
            # patsy set-difference semantics, applied left to right:
            # "x1 + x2 - x2" drops x2; removing an absent term is a no-op.
            removed = t[1:]
            terms = [term for term in terms if term != removed]
            continue
        if t not in terms:
            terms.append(t)

    assert not any("C(" in t for t in terms), "categorical variables are not yet supported"
    for t in terms:
        assert re.fullmatch(r"[A-Za-z_][\w.]*(:[A-Za-z_][\w.]*)*", t), (
            f"formula term {t!r} is not supported (transformation functions are not handled)"
        )

    exprs: List[Expr] = [col(t) for t in lhs_terms]
    for t in terms:
        if ":" in t:
            parts = t.split(":")
            prod = reduce(lambda a, b: a * b, [col(p) for p in parts])
            exprs.append(prod.alias(t))
        else:
            exprs.append(col(t))
    return exprs, add_intercept


@contextmanager
def timer(msg: Optional[str] = None, precision: int = 3):
    """Wall-clock timer printing milliseconds (reference utils.py:111-118)."""
    start = time.perf_counter()
    end = None
    try:
        yield lambda: (end or time.perf_counter()) - start
    finally:
        end = time.perf_counter()
        label = msg or "task"
        print(f"{label} took: {(end - start) * 1_000:.{precision}f} ms")


@contextmanager
def trace(log_dir: str = "/tmp/pols_tpu_trace"):
    """Capture a device profile of the enclosed block (the device-side
    complement of the reference's wall-clock-only instrumentation,
    SURVEY §5): view with TensorBoard or xprof.

    Example:
        with trace("/tmp/t"):
            df.select(col("y").least_squares.ols("x1").over("g"))
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_sync(x) -> None:
    """Block until the device work behind a query result has finished."""
    import jax

    # check the CLASS, not the instance: `values` is a property on the
    # series types, and instance-level hasattr would EXECUTE the getter
    # (for StatisticsSeries that materialises every row on the host)
    from .series import StatisticsSeries

    if isinstance(x, StatisticsSeries):
        jax.block_until_ready(x._base)
        return
    leaf = x.values if hasattr(type(x), "values") else x
    jax.block_until_ready(leaf)
