"""Lazy expression AST and evaluator.

This is the engine's replacement for reference layers L5/L4 and the slice
of the polars engine (L3) the plugin relies on: named column expressions,
elementwise arithmetic with null propagation, wildcard expansion, `.over()`
window context, and the least-squares "plugin" nodes which dispatch into the
batched JAX engine (engine/fit.py).

Unlike the reference — where expressions are built by polars and the solver
is an FFI callback invoked once per group (README:19) — here the whole
expression, including the grouped solve, is evaluated as one batched JAX
program over a [num_groups, ...] layout.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Union

import numpy as np

from .config import CONFIG  # noqa: F401
import jax.numpy as jnp

from .series import ObjectSeries, Series, StructSeries

ExprOrStr = Union["Expr", str]


# --------------------------------------------------------------------------- #
# AST
# --------------------------------------------------------------------------- #
class Expr:
    """Base class for all expression nodes."""

    def _binop(self, other, op, reflected=False):
        other = _lit_or_expr(other)
        return BinExpr(op, other, self) if reflected else BinExpr(op, self, other)

    def __add__(self, other):
        return self._binop(other, "add")

    def __radd__(self, other):
        return self._binop(other, "add", True)

    def __sub__(self, other):
        return self._binop(other, "sub")

    def __rsub__(self, other):
        return self._binop(other, "sub", True)

    def __mul__(self, other):
        return self._binop(other, "mul")

    def __rmul__(self, other):
        return self._binop(other, "mul", True)

    def __truediv__(self, other):
        return self._binop(other, "div")

    def __rtruediv__(self, other):
        return self._binop(other, "div", True)

    def __neg__(self):
        return UnaryExpr("neg", self)

    # ---- comparisons & boolean algebra (filter predicates) ---- #
    # defining __eq__ would clear __hash__; expressions are identity-hashed
    __hash__ = object.__hash__

    def __gt__(self, other):
        return self._binop(other, "gt")

    def __ge__(self, other):
        return self._binop(other, "ge")

    def __lt__(self, other):
        return self._binop(other, "lt")

    def __le__(self, other):
        return self._binop(other, "le")

    def __eq__(self, other):  # noqa: PLW0177 - polars-style expression eq
        return self._binop(other, "eq")

    def __ne__(self, other):
        return self._binop(other, "ne")

    def __and__(self, other):
        return self._binop(other, "and")

    def __rand__(self, other):
        return self._binop(other, "and", True)

    def __or__(self, other):
        return self._binop(other, "or")

    def __ror__(self, other):
        return self._binop(other, "or", True)

    def __invert__(self):
        return UnaryExpr("not", self)

    def __bool__(self):
        # `expr == other` builds a BinExpr, so a bare truth test (`if e1 ==
        # e2:`, `e in exprs`) would otherwise silently evaluate True via
        # object truthiness — raise like polars does instead.
        raise TypeError(
            "the truth value of an Expr is ambiguous; to combine or compare "
            "expressions use &, |, ==, etc. and evaluate through a frame"
        )

    def add(self, other):
        return self.__add__(other)

    def sub(self, other):
        return self.__sub__(other)

    def mul(self, other):
        return self.__mul__(other)

    def sqrt(self):
        return UnaryExpr("sqrt", self)

    def abs(self):
        return UnaryExpr("abs", self)

    def log(self):
        return UnaryExpr("log", self)

    def log1p(self):
        return UnaryExpr("log1p", self)

    def exp(self):
        return UnaryExpr("exp", self)

    def __pow__(self, other):
        return self._binop(other, "pow")

    def pow(self, other):
        return self.__pow__(other)

    def clip(self, lower_bound=None, upper_bound=None):
        return ClipExpr(self, lower_bound, upper_bound)

    def shift(self, n: int = 1):
        return ShiftExpr(self, n)

    def round(self, decimals: int = 0):
        return RoundExpr(self, decimals)

    def alias(self, name: str) -> "Expr":
        return AliasExpr(self, name)

    def fill_null(self, value: float) -> "Expr":
        return FillNullExpr(self, value)

    def fill_nan(self, value) -> "Expr":
        return FillNanExpr(self, value)

    def is_null(self) -> "Expr":
        return UnaryExpr("is_null", self)

    def is_not_null(self) -> "Expr":
        return UnaryExpr("is_not_null", self)

    def forward_fill(self) -> "Expr":
        return UnaryExpr("forward_fill", self)

    # ---- aggregations (full-frame in select; per-group under agg) ---- #
    def sum(self) -> "Expr":
        return AggExpr(self, "sum")

    def mean(self) -> "Expr":
        return AggExpr(self, "mean")

    def min(self) -> "Expr":
        return AggExpr(self, "min")

    def max(self) -> "Expr":
        return AggExpr(self, "max")

    def count(self) -> "Expr":
        return AggExpr(self, "count")

    def n_unique(self) -> "Expr":
        return AggExpr(self, "n_unique")

    def std(self, ddof: int = 1) -> "Expr":
        return AggExpr(self, "std", ddof=ddof)

    def var(self, ddof: int = 1) -> "Expr":
        return AggExpr(self, "var", ddof=ddof)

    def first(self) -> "Expr":
        return AggExpr(self, "first")

    def last(self) -> "Expr":
        return AggExpr(self, "last")

    def over(self, *keys: ExprOrStr) -> "Expr":
        return OverExpr(self, [k if isinstance(k, str) else k.meta.output_name for k in keys])

    # -- metadata ---------------------------------------------------------- #
    @property
    def meta(self) -> "_ExprMeta":
        return _ExprMeta(self)

    @property
    def output_name(self) -> Optional[str]:
        return None

    # -- namespace --------------------------------------------------------- #
    @property
    def least_squares(self):
        from .namespace import LeastSquares

        return LeastSquares(self)

    # -- wildcard expansion ------------------------------------------------ #
    def expand(self, df) -> List["Expr"]:
        """Expand wildcard/regex column selectors against a frame's schema.

        Mirrors polars' ``input_wildcard_expansion`` used by the reference
        plugin registration (polars_ols/least_squares.py:226-233).
        """
        return [self]

    # -- evaluation --------------------------------------------------------- #
    def evaluate(self, df, groups: Optional[np.ndarray] = None):
        raise NotImplementedError

    def evaluate_grouped(self, df, layout, first_idx: np.ndarray):
        """Evaluate under GroupBy.agg: one output row per group.

        Default: evaluate in the grouped (.over-style) context — where
        results are group-constant, e.g. least-squares coefficients /
        statistics — and keep each group's first row. Aggregation nodes
        override this with segment reductions."""
        s = self.evaluate(df, layout)
        return s.gather(first_idx)


class _ExprMeta:
    def __init__(self, expr: Expr):
        self._expr = expr

    @property
    def output_name(self) -> Optional[str]:
        return self._expr.output_name


class ColExpr(Expr):
    """Column reference. Supports exact names, ``^regex$`` patterns and the
    prefix/suffix selectors from :mod:`polars_ols_tpu.selectors`."""

    def __init__(self, name: str, matcher: Optional[str] = None, pattern: Optional[str] = None):
        self.name = name
        self.matcher = matcher  # None | "regex" | "starts_with" | "all"
        self.pattern = pattern

    @property
    def output_name(self) -> Optional[str]:
        return None if self.matcher else self.name

    def expand(self, df) -> List[Expr]:
        if self.matcher is None:
            return [self]
        names = df.columns
        if self.matcher == "regex":
            rx = re.compile(self.pattern)
            return [ColExpr(n) for n in names if rx.search(n)]
        if self.matcher == "starts_with":
            return [ColExpr(n) for n in names if n.startswith(self.pattern)]
        if self.matcher == "all":
            return [ColExpr(n) for n in names]
        raise ValueError(self.matcher)

    def evaluate(self, df, groups=None):
        return df.get_column(self.name)


class LitExpr(Expr):
    def __init__(self, value):
        self.value = value

    @property
    def output_name(self) -> Optional[str]:
        return "literal"

    def evaluate(self, df, groups=None):
        v = self.value
        if isinstance(v, (Series, StructSeries, ObjectSeries)):
            return v
        if np.isscalar(v) or v is None:
            if v is None:
                return Series("literal", np.zeros(df.height), np.zeros(df.height, dtype=bool))
            return Series("literal", np.full(df.height, float(v)))
        arr = np.asarray(v)
        if arr.ndim == 0:
            return Series("literal", np.full(df.height, float(arr)))
        assert arr.shape[0] == df.height, "literal array length mismatch"
        return Series("literal", arr)

    def flatten(self):
        return self


class RoundExpr(Expr):
    def __init__(self, inner: Expr, decimals: int):
        self.inner = inner
        self.decimals = decimals

    @property
    def output_name(self):
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        return Series(s.name, jnp.round(jnp.asarray(s.values), self.decimals), s.validity)


class AliasExpr(Expr):
    def __init__(self, inner: Expr, name: str):
        self.inner = inner
        self.name = name

    @property
    def output_name(self) -> Optional[str]:
        return self.name

    def expand(self, df):
        return [self]

    def evaluate(self, df, groups=None):
        return self.inner.evaluate(df, groups).alias(self.name)

    def evaluate_grouped(self, df, layout, first_idx):
        return self.inner.evaluate_grouped(df, layout, first_idx).alias(self.name)


class BinExpr(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    @property
    def output_name(self) -> Optional[str]:
        return self.left.output_name or self.right.output_name

    def evaluate(self, df, groups=None):
        l = self.left.evaluate(df, groups)
        r = self.right.evaluate(df, groups)
        return _binop_series(self.op, l, r)


class UnaryExpr(Expr):
    def __init__(self, op: str, inner: Expr):
        self.op = op
        self.inner = inner

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        if self.op == "forward_fill":
            return s.forward_fill()
        if self.op == "is_null":
            return s.is_null()
        if self.op == "is_not_null":
            return s.is_not_null()
        vals = jnp.asarray(s.values, dtype=jnp.float64)
        if self.op == "neg":
            out = -vals
        elif self.op == "sqrt":
            out = jnp.sqrt(vals)
        elif self.op == "abs":
            out = jnp.abs(vals)
        elif self.op == "log":
            out = jnp.log(vals)
        elif self.op == "log1p":
            out = jnp.log1p(vals)
        elif self.op == "exp":
            out = jnp.exp(vals)
        elif self.op == "not":
            out = jnp.where(vals != 0.0, 0.0, 1.0)
        else:  # pragma: no cover
            raise ValueError(self.op)
        return Series(s.name, out, s.validity)


class ClipExpr(Expr):
    def __init__(self, inner: Expr, lower_bound=None, upper_bound=None):
        self.inner = inner
        self.lower = lower_bound
        self.upper = upper_bound

    @property
    def name(self) -> str:
        return self.inner.name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        vals = jnp.asarray(s.values, dtype=jnp.float64)
        if self.lower is not None:
            vals = jnp.maximum(vals, self.lower)
        if self.upper is not None:
            vals = jnp.minimum(vals, self.upper)
        return Series(s.name, vals, s.validity)


class ShiftExpr(Expr):
    """Column-level shift with nulls introduced at the boundary (polars
    Expr.shift semantics in a select context)."""

    def __init__(self, inner: Expr, n: int):
        self.inner = inner
        self.n = int(n)

    @property
    def name(self) -> str:
        return self.inner.name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        n = self.n
        vals = jnp.asarray(s.values, dtype=jnp.float64)
        valid = s.valid_mask()
        out = jnp.roll(vals, n)
        ok = jnp.roll(valid, n)
        idx = jnp.arange(vals.shape[0])
        edge = idx < n if n >= 0 else idx >= vals.shape[0] + n
        return Series(s.name, jnp.where(edge, 0.0, out), ok & ~edge)


class AggExpr(Expr):
    """Aggregation node: a full-frame reduction in a select context, a
    per-group segment reduction under `GroupBy.agg` (the polars engine's
    aggregation role, SURVEY layer L3)."""

    def __init__(self, inner: Expr, op: str, ddof: int = 1):
        self.inner = inner
        self.op = op
        self.ddof = ddof

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def _reduce(self, vals, valid, gids, G):
        """Segment reductions over [N] device values with validity."""
        import jax

        w = valid.astype(jnp.float64)
        seg = lambda v: jax.ops.segment_sum(v, gids, num_segments=G)
        n = seg(w)
        if self.op == "count":
            return n, None
        if self.op == "sum":
            return seg(vals * w), None
        if self.op == "mean":
            return seg(vals * w) / jnp.maximum(n, 1.0), n > 0
        if self.op in ("var", "std"):
            mean = seg(vals * w) / jnp.maximum(n, 1.0)
            dev = (vals - jnp.take(mean, gids)) * w
            den = jnp.maximum(n - self.ddof, 1.0)
            var = seg(dev * dev) / den
            out = jnp.sqrt(var) if self.op == "std" else var
            return out, n > self.ddof
        if self.op == "min":
            big = jnp.where(valid, vals, jnp.inf)
            return jax.ops.segment_min(big, gids, num_segments=G), n > 0
        if self.op == "max":
            small = jnp.where(valid, vals, -jnp.inf)
            return jax.ops.segment_max(small, gids, num_segments=G), n > 0
        raise ValueError(self.op)

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, None)
        if self.op in ("first", "last"):
            idx = 0 if self.op == "first" else len(s) - 1
            return s.gather(np.asarray([idx]))
        if self.op == "n_unique":
            vals = s.to_numpy()
            return Series(s.name, np.asarray([float(len(np.unique(vals[~np.isnan(vals)])))]))
        vals = jnp.asarray(s.values, dtype=jnp.float64)
        out, ok = self._reduce(vals, s.valid_mask(), jnp.zeros(len(s), jnp.int32), 1)
        validity = None if ok is None else ok
        return Series(s.name, out, validity)

    def evaluate_grouped(self, df, layout, first_idx):
        s = self.inner.evaluate(df, None)
        G = layout.num_groups
        if self.op in ("first", "last"):
            order = layout.order
            starts = np.zeros(G, dtype=np.int64)
            np.cumsum(layout.counts[:-1], out=starts[1:])
            idx = order[starts] if self.op == "first" else order[starts + layout.counts - 1]
            return s.gather(idx)
        if self.op == "n_unique":
            # vectorized: lexsort by (group, value), count group-starts and
            # value-changes — O(N log N) host work, no per-group loop
            vals = s.to_numpy().astype(float)
            finite = ~np.isnan(vals)
            v, g = vals[finite], layout.gids[finite]
            out = np.zeros(G)
            if len(v):
                order = np.lexsort((v, g))
                gs, vs = g[order], v[order]
                new = np.empty(len(gs), dtype=bool)
                new[0] = True
                new[1:] = (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1])
                out = np.bincount(gs[new], minlength=G)[:G].astype(float)
            return Series(s.name, out)
        vals = jnp.asarray(s.values, dtype=jnp.float64)
        out, ok = self._reduce(vals, s.valid_mask(), layout.device_gids(), G)
        return Series(s.name, out, ok)


class FillNullExpr(Expr):
    def __init__(self, inner: Expr, value: float):
        self.inner = inner
        self.value = value

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        return self.inner.evaluate(df, groups).fill_null(self.value)


class FillNanExpr(Expr):
    """``fill_nan(None)`` converts NaN values to nulls — the post-step the
    reference applies to rolling predictions (polars_ols/least_squares.py:
    407-409)."""

    def __init__(self, inner: Expr, value):
        self.inner = inner
        self.value = value

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        vals = jnp.asarray(s.values, dtype=jnp.float64)
        nan = jnp.isnan(vals)
        if self.value is None:
            validity = s.valid_mask() & ~nan
            return Series(s.name, jnp.where(nan, 0.0, vals), validity)
        return Series(s.name, jnp.where(nan, self.value, vals), s.validity)


class StructExpr(Expr):
    def __init__(self, fields: Dict[str, Expr], name: str = "struct"):
        self.fields = fields
        self.name = name

    @property
    def output_name(self) -> Optional[str]:
        return self.name

    def evaluate(self, df, groups=None):
        cols = {k: v.evaluate(df, groups) for k, v in self.fields.items()}
        # memoize the stacked struct on the first field Series: repeated
        # queries (e.g. benchmark reps, multi-target sweeps) re-evaluate to
        # the same column objects, and a stable values buffer lets the
        # engine's padded-layout caches hit across calls
        owner = next(iter(cols.values()))
        key = ("struct", self.name) + tuple(id(c) for c in cols.values())
        cache = getattr(owner, "_layout_cache", None)
        if cache is not None and key in cache:
            return cache[key][0]
        vals = jnp.stack(
            [jnp.asarray(c.values, dtype=jnp.float64) for c in cols.values()], axis=1
        )
        validity = None
        if any(c.validity is not None for c in cols.values()):
            validity = jnp.stack([c.valid_mask() for c in cols.values()], axis=1)
        out = StructSeries(self.name, list(cols.keys()), vals, validity)
        try:
            if cache is None:
                from .engine.groups import register_cache_owner

                cache = {}
                object.__setattr__(owner, "_layout_cache", cache)
                register_cache_owner(owner)
            if len(cache) >= 8:
                cache.pop(next(iter(cache)))
            cache[key] = (out, tuple(cols.values()))  # hold refs: ids in key
        except AttributeError:
            pass
        return out


class OverExpr(Expr):
    """Window context: evaluates the wrapped expression with per-row group
    ids derived from the key columns. This replaces the reference's reliance
    on polars' per-group plugin dispatch (SURVEY §2.3): instead of invoking a
    solver once per group, group ids flow into the batched engine."""

    def __init__(self, inner: Expr, keys: List[str]):
        self.inner = inner
        self.keys = keys

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        from .engine.groups import layout_for_columns

        layout = layout_for_columns([df.get_column(k) for k in self.keys])
        return self.inner.evaluate(df, layout)


class LeastSquaresExpr(Expr):
    """The 'plugin call' node: equivalent of the reference's 8 #[polars_expr]
    entry points (src/expressions.rs:390-741), dispatching into the batched
    device engine."""

    def __init__(
        self,
        function_name: str,
        target: Expr,
        features: List[Expr],
        kwargs,
        mode: str,
        multi_target: bool = False,
        weights: "Expr" = None,
        add_intercept: bool = False,
    ):
        self.function_name = function_name
        self.target = target
        self.features = features
        self.kwargs = kwargs
        self.mode = mode
        self.multi_target = multi_target
        self.weights = weights  # engine-side WLS scaling (least_squares.py)
        self.add_intercept = add_intercept  # engine-side 'const' column

    @property
    def output_name(self) -> Optional[str]:
        if self.mode in ("coefficients", "statistics"):
            return self.mode
        return self.target.output_name

    def evaluate(self, df, groups=None):
        from .engine.fit import evaluate_least_squares

        feats: List[Expr] = []
        for f in self.features:
            feats.extend(f.expand(df))
        target = self.target.evaluate(df, groups)
        feat_series = [f.evaluate(df, groups) for f in feats]
        weights = self.weights.evaluate(df, groups) if self.weights is not None else None
        return evaluate_least_squares(
            self.function_name,
            target,
            feat_series,
            self.kwargs,
            self.mode,
            groups,
            multi_target=self.multi_target,
            weights=weights,
            add_intercept=self.add_intercept,
        )


class PredictExpr(Expr):
    """Row-aligned coefficient-struct dot features — the reference's
    `predict` plugin (src/expressions.rs:706-741)."""

    def __init__(self, coefficients: Expr, features: List[Expr], null_policy: str, name: str):
        self.coefficients = coefficients
        self.features = features
        self.null_policy = null_policy
        self.name = name

    @property
    def output_name(self) -> Optional[str]:
        return self.name

    def evaluate(self, df, groups=None):
        from .engine.fit import evaluate_predict

        feats: List[Expr] = []
        for f in self.features:
            feats.extend(f.expand(df))
        coef = self.coefficients.evaluate(df, groups)
        feat_series = [f.evaluate(df, groups) for f in feats]
        return evaluate_predict(coef, feat_series, self.null_policy, self.name)


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #
def _lit_or_expr(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return LitExpr(v)


def _binop_series(op: str, l, r):
    # struct arithmetic: field-wise (multi-target residuals = target struct
    # minus predictions struct; WLS unscale = struct * series broadcast)
    if isinstance(l, StructSeries) or isinstance(r, StructSeries):
        return _binop_struct(op, l, r)
    n = max(len(l), len(r))

    def as_vals(s):
        v = jnp.asarray(s.values, dtype=jnp.float64)
        if len(s) == 1 and n > 1:
            v = jnp.broadcast_to(v, (n,))
        return v

    def as_valid(s):
        m = s.valid_mask()
        if len(s) == 1 and n > 1:
            m = jnp.broadcast_to(m, (n,))
        return m

    lv, rv = as_vals(l), as_vals(r)
    # all-valid tracking stays host-side (validity is None): a device
    # `validity.all()` fetch here would put a device-to-host sync into
    # EVERY arithmetic node
    if l.validity is None and r.validity is None:
        validity = None
    else:
        validity = as_valid(l) & as_valid(r)
    if op == "add":
        out = lv + rv
    elif op == "sub":
        out = lv - rv
    elif op == "mul":
        out = lv * rv
    elif op == "div":
        out = lv / rv
    elif op == "pow":
        out = lv**rv
    elif op in ("gt", "ge", "lt", "le", "eq", "ne", "and", "or"):
        # comparisons / boolean algebra as 0/1 floats (filter casts to
        # bool); null operands yield null like polars' non-Kleene ops
        cmp = {
            "gt": lambda a, b: a > b,
            "ge": lambda a, b: a >= b,
            "lt": lambda a, b: a < b,
            "le": lambda a, b: a <= b,
            "eq": lambda a, b: a == b,
            "ne": lambda a, b: a != b,
            "and": lambda a, b: (a != 0.0) & (b != 0.0),
            "or": lambda a, b: (a != 0.0) | (b != 0.0),
        }[op](lv, rv)
        out = cmp.astype(jnp.float64)
    else:  # pragma: no cover
        raise ValueError(op)
    name = l.name if l.name != "literal" else r.name
    return Series(name, out, validity)


def _binop_struct(op: str, l, r):
    if isinstance(l, StructSeries) and isinstance(r, StructSeries):
        assert l.field_names == r.field_names or len(l.field_names) == len(r.field_names)
        lv, rv = l.values, r.values
        lm = l.validity if l.validity is not None else jnp.ones_like(lv, dtype=bool)
        rm = r.validity if r.validity is not None else jnp.ones_like(rv, dtype=bool)
        names = l.field_names
        name = l.name
    elif isinstance(l, StructSeries):
        lv = l.values
        rv = jnp.asarray(r.values, dtype=jnp.float64)[:, None]
        lm = l.validity if l.validity is not None else jnp.ones_like(lv, dtype=bool)
        rm = r.valid_mask()[:, None]
        names, name = l.field_names, l.name
    else:
        lv = jnp.asarray(l.values, dtype=jnp.float64)[:, None]
        rv = r.values
        lm = l.valid_mask()[:, None]
        rm = r.validity if r.validity is not None else jnp.ones_like(rv, dtype=bool)
        names, name = r.field_names, r.name
    ops = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "mul": lambda a, b: a * b, "div": lambda a, b: a / b}
    return StructSeries(name, names, ops[op](lv, rv), lm & rm)


def col(name: str) -> ColExpr:
    """Column selector. ``col("^x.*$")`` expands by regex like polars."""
    if name == "*":
        return ColExpr(name, matcher="all")
    if name.startswith("^") and name.endswith("$"):
        return ColExpr(name, matcher="regex", pattern=name)
    return ColExpr(name)


def lit(value) -> LitExpr:
    return LitExpr(value)


def struct(*args, **named) -> StructExpr:
    fields: Dict[str, Expr] = {}
    for a in args:
        if isinstance(a, dict):
            for k, v in a.items():
                fields[k] = _lit_or_expr(v)
        else:
            e = _lit_or_expr(a)
            fields[e.output_name or f"field_{len(fields)}"] = e
    for k, v in named.items():
        fields[k] = _lit_or_expr(v).alias(k) if isinstance(v, Expr) else _lit_or_expr(v)
    return StructExpr(fields)


def parse_into_expr(expr: ExprOrStr) -> Expr:
    """Mirror of the reference's utils.parse_into_expr (utils.py:21-58)."""
    if isinstance(expr, Expr):
        return expr
    if isinstance(expr, str):
        return col(expr)
    return lit(expr)
