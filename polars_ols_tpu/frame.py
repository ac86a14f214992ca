"""Eager columnar DataFrame over JAX device arrays.

This is the substrate replacing the slice of the polars engine (reference
layer L3, SURVEY §1) that polars_ols depends on: column storage with
validity masks, expression evaluation with scalar broadcasting, group_by /
over dispatch, struct columns and unnesting. It is intentionally minimal —
just enough surface for the least-squares workload — but the compute path
under it is fully batched JAX/XLA.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .config import CONFIG  # noqa: F401
import jax.numpy as jnp

from .expr import Expr, col, parse_into_expr
from .series import AnySeries, ObjectSeries, Series, StatisticsSeries, StructSeries


def _to_series(name: str, data) -> AnySeries:
    if isinstance(data, (Series, StructSeries, ObjectSeries)):
        return data.alias(name)
    arr = data
    if isinstance(arr, np.ndarray) and arr.dtype == object:
        return ObjectSeries(name, list(arr))
    if isinstance(arr, (list, tuple)) and len(arr) and isinstance(arr[0], str):
        return ObjectSeries(name, list(arr))
    return Series(name, arr)


class DataFrame:
    def __init__(self, data: Optional[Dict[str, object]] = None, schema: Optional[List[str]] = None):
        self._columns: Dict[str, AnySeries] = {}
        if data is None:
            return
        if isinstance(data, dict):
            for k, v in data.items():
                self._columns[k] = _to_series(k, v)
        elif isinstance(data, np.ndarray):
            assert schema is not None, "2-D data requires a schema"
            assert data.ndim == 2 and data.shape[1] == len(schema)
            for j, name in enumerate(schema):
                self._columns[name] = Series(name, data[:, j])
        elif isinstance(data, list) and data and isinstance(data[0], (Series, StructSeries, ObjectSeries)):
            for s in data:
                self._columns[s.name] = s
        else:
            raise TypeError(f"unsupported DataFrame source: {type(data)}")
        heights = {len(c) for c in self._columns.values()}
        assert len(heights) <= 1, f"column heights differ: {heights}"

    # ---------------------------------------------------------------- #
    @classmethod
    def _from_columns(cls, cols: Sequence[AnySeries]) -> "DataFrame":
        df = cls()
        for c in cols:
            df._columns[c.name] = c
        return df

    @property
    def columns(self) -> List[str]:
        return list(self._columns.keys())

    @property
    def height(self) -> int:
        if not self._columns:
            return 0
        return len(next(iter(self._columns.values())))

    @property
    def width(self) -> int:
        return len(self._columns)

    @property
    def shape(self):
        return (self.height, self.width)

    def __len__(self) -> int:
        return self.height

    def get_column(self, name: str) -> AnySeries:
        if name not in self._columns:
            raise KeyError(f"column {name!r} not found; available: {self.columns}")
        return self._columns[name]

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.get_column(key)
        if isinstance(key, (list, tuple)):
            return self.select(*[col(k) for k in key])
        if isinstance(key, int):
            idx = np.asarray([key if key >= 0 else self.height + key])
            return DataFrame._from_columns([c.gather(idx) for c in self._columns.values()])
        if isinstance(key, slice):
            idx = np.arange(self.height)[key]
            return DataFrame._from_columns([c.gather(idx) for c in self._columns.values()])
        raise TypeError(type(key))

    # ---------------------------------------------------------------- #
    def _evaluate_exprs(self, exprs, named) -> List[AnySeries]:
        all_exprs: List[Expr] = []
        for e in exprs:
            e = parse_into_expr(e)
            all_exprs.extend(e.expand(self))
        for name, e in named.items():
            all_exprs.append(parse_into_expr(e).alias(name))
        if len(all_exprs) > 1:
            # two or more fit expressions in one select compile into ONE
            # device program (engine/batch.py): one dispatch for all
            from .engine.batch import try_fused_select

            fused = try_fused_select(self, all_exprs)
            if fused is not None:
                return fused
        return [e.evaluate(self) for e in all_exprs]

    def select(self, *exprs, **named) -> "DataFrame":
        results = self._evaluate_exprs(exprs, named)
        if not results:
            return DataFrame()
        heights = {len(r) for r in results}
        if len(heights) > 1:
            # mixed scalar/full-length: broadcast scalars (polars semantics,
            # exercised by reference tests/test_ols.py:404-433)
            n = max(heights)
            results = [_broadcast(r, n) for r in results]
        return DataFrame._from_columns(results)

    def with_columns(self, *exprs, **named) -> "DataFrame":
        results = self._evaluate_exprs(exprs, named)
        out = dict(self._columns)
        for r in results:
            out[r.name] = _broadcast(r, self.height)
        return DataFrame._from_columns(list(out.values()))

    def with_row_index(self, name: str = "index") -> "DataFrame":
        idx = Series(name, np.arange(self.height, dtype=np.float64))
        return DataFrame._from_columns([idx, *self._columns.values()])

    def drop(self, *names: str) -> "DataFrame":
        drop = set()
        for n in names:
            drop.update(n if isinstance(n, (list, tuple)) else [n])
        return DataFrame._from_columns(
            [c for k, c in self._columns.items() if k not in drop]
        )

    def rename(self, mapping: Dict[str, str]) -> "DataFrame":
        return DataFrame._from_columns(
            [c.alias(mapping.get(k, k)) for k, c in self._columns.items()]
        )

    # ---------------------------------------------------------------- #
    def filter(self, mask) -> "DataFrame":
        if isinstance(mask, Expr):
            s = mask.evaluate(self)
            m = np.asarray(s.values).astype(bool) & np.asarray(s.valid_mask())
        else:
            m = np.asarray(mask, dtype=bool)
        return DataFrame._from_columns([c.filter(m) for c in self._columns.values()])

    def fill_null(self, value: float) -> "DataFrame":
        cols = []
        for c in self._columns.values():
            cols.append(c.fill_null(value) if isinstance(c, Series) else c)
        return DataFrame._from_columns(cols)

    def fill_nan(self, value) -> "DataFrame":
        cols = []
        for c in self._columns.values():
            if isinstance(c, Series) and c.is_float:
                vals = jnp.asarray(c.values)
                nan = jnp.isnan(vals)
                if value is None:
                    cols.append(Series(c.name, jnp.where(nan, 0.0, vals), c.valid_mask() & ~nan))
                else:
                    cols.append(Series(c.name, jnp.where(nan, value, vals), c.validity))
            else:
                cols.append(c)
        return DataFrame._from_columns(cols)

    def drop_nulls(self, subset: Optional[List[str]] = None) -> "DataFrame":
        names = subset or self.columns
        mask = np.ones(self.height, dtype=bool)
        for n in names:
            c = self.get_column(n)
            if isinstance(c, (Series, StructSeries)):
                mask &= np.asarray(c.valid_mask())
        return self.filter(mask)

    # ---------------------------------------------------------------- #
    def unnest(self, *names: str) -> "DataFrame":
        out: List[AnySeries] = []
        for k, c in self._columns.items():
            if k in names:
                if isinstance(c, StatisticsSeries):
                    # scalar metric fields stay device arrays; list fields
                    # become host object columns only here, at the explicit
                    # unnest boundary
                    for fk in c.SCALAR_FIELDS:
                        out.append(Series(fk, c.arrays[fk]))
                    out.append(
                        ObjectSeries(
                            "feature_names", [list(c.feature_names)] * len(c)
                        )
                    )
                    for fk in c.LIST_FIELDS:
                        host = np.asarray(c.arrays[fk])
                        out.append(ObjectSeries(fk, [r.tolist() for r in host]))
                elif isinstance(c, StructSeries):
                    out.extend(c.fields())
                elif isinstance(c, ObjectSeries) and c.values and isinstance(c.values[0], dict):
                    keys = c.values[0].keys()
                    for fk in keys:
                        vals = [row[fk] for row in c.values]
                        if vals and isinstance(vals[0], (list, np.ndarray)):
                            out.append(ObjectSeries(fk, vals))
                        elif vals and isinstance(vals[0], str):
                            out.append(ObjectSeries(fk, vals))
                        else:
                            out.append(Series(fk, np.asarray(vals, dtype=np.float64)))
                else:
                    raise TypeError(f"column {k!r} is not a struct")
            else:
                out.append(c)
        return DataFrame._from_columns(out)

    def explode(self, names: List[str]) -> "DataFrame":
        names = list(names)
        first = self.get_column(names[0])
        lengths = [len(v) for v in first.values] if isinstance(first, ObjectSeries) else None
        assert lengths is not None, "explode expects list-valued object columns"
        out: List[AnySeries] = []
        row_rep = np.repeat(np.arange(self.height), lengths)
        for k, c in self._columns.items():
            if k in names:
                flat: list = []
                for v in c.values:
                    flat.extend(list(v))
                if flat and isinstance(flat[0], str):
                    out.append(ObjectSeries(k, flat))
                else:
                    out.append(Series(k, np.asarray(flat, dtype=np.float64)))
            else:
                out.append(c.gather(row_rep))
        return DataFrame._from_columns(out)

    # ---------------------------------------------------------------- #
    def _take_rows(self, idx: np.ndarray) -> "DataFrame":
        return DataFrame._from_columns(
            [c.gather(idx) for c in self._columns.values()]
        )

    def head(self, n: int = 5) -> "DataFrame":
        return self._take_rows(np.arange(min(max(n, 0), self.height)))

    def tail(self, n: int = 5) -> "DataFrame":
        h = self.height
        return self._take_rows(np.arange(max(h - max(n, 0), 0), h))

    def slice(self, offset: int, length: Optional[int] = None) -> "DataFrame":
        h = self.height
        start = offset if offset >= 0 else max(h + offset, 0)
        stop = h if length is None else min(start + length, h)
        return self._take_rows(np.arange(min(start, h), stop))

    def _key_array(self, keys: List[str]) -> np.ndarray:
        cols = []
        for k in keys:
            c = self.get_column(k)
            v = c.to_numpy()
            cols.append(v)
        if len(cols) == 1:
            return cols[0]
        return np.rec.fromarrays(cols)

    def group_by(self, *keys: str) -> "GroupBy":
        keys = [k if isinstance(k, str) else k.meta.output_name for k in keys]
        return GroupBy(self, list(keys))

    def partition_by(self, *keys: str) -> List["DataFrame"]:
        ks = self._key_array(list(keys))
        out = []
        for v in np.unique(ks):
            out.append(self.filter(ks == v))
        return out

    def unique(self) -> "DataFrame":
        # typed key columns: numeric values (+ validity when nulls exist)
        # for Series, field columns for structs, the deferred group index
        # (or scalar metric fields) for statistics structs, and reprs for
        # object columns — a frame-wide float view would choke on the
        # non-numeric column types
        keys: List[np.ndarray] = []
        for c in self._columns.values():
            if isinstance(c, Series):
                keys.append(c.to_numpy())
                if c.validity is not None:
                    keys.append(np.asarray(c.valid_mask()))
            elif isinstance(c, StructSeries):
                m = np.asarray(c.values)
                keys.extend(m[:, j] for j in range(m.shape[1]))
                if c.validity is not None:
                    v = np.asarray(c.validity)
                    keys.extend(v[:, j] for j in range(v.shape[1]))
            elif isinstance(c, StatisticsSeries):
                if c._row_index is not None:
                    keys.append(c.composed_index())
                else:
                    for fk in c.SCALAR_FIELDS:
                        keys.append(np.asarray(c.arrays[fk]))
                    for fk in c.LIST_FIELDS:
                        # rows can tie exactly on the scalar metrics (e.g.
                        # two exact-fit groups both at r2=1, mae=mse=0) while
                        # differing in coefficients — key every field
                        m = np.asarray(c.arrays[fk])
                        keys.extend(m[:, j] for j in range(m.shape[1]))
            else:  # ObjectSeries
                keys.append(np.asarray([repr(v) for v in c.values]))
        rec = keys[0] if len(keys) == 1 else np.rec.fromarrays(keys)
        _, idx = np.unique(rec, return_index=True)
        return DataFrame._from_columns(
            [c.gather(np.sort(idx)) for c in self._columns.values()]
        )

    def sort(
        self,
        by: Union[str, List[str]],
        descending: Union[bool, List[bool]] = False,
    ) -> "DataFrame":
        """Stable multi-key sort; ``descending`` may be a single bool or a
        per-key list (polars signature). NaN keys sort last in either
        direction, matching numpy's argsort placement."""
        by = [by] if isinstance(by, str) else list(by)
        desc = (
            [descending] * len(by)
            if isinstance(descending, bool)
            else list(descending)
        )
        assert len(desc) == len(by), "descending must match the number of sort keys"
        keys = []
        for k, d in zip(by, desc):
            v = np.asarray(self.get_column(k).to_numpy())
            if v.dtype == object or v.dtype.kind in "US":
                _, v = np.unique(v, return_inverse=True)  # dense rank codes
            if d:
                if v.dtype.kind == "b":
                    v = ~v
                elif v.dtype.kind == "u":
                    v = -v.astype(np.int64)
                else:
                    v = -v
            keys.append(v)
        order = np.lexsort(keys[::-1])  # lexsort's primary key is the LAST array
        return DataFrame._from_columns([c.gather(order) for c in self._columns.values()])

    def _join_codes(self, other: "DataFrame", on: List[str]):
        """Shared dense key codes for a join via the native O(N) hash
        factorizer (engine/native/factorize.cpp) — no sort of the combined
        key set. Returns None when a key column needs the generic
        unique-sort path (object dtype or NaN keys)."""
        from .engine.groups import _factorize_numeric

        arrays = []
        for k in on:
            lv = np.asarray(self.get_column(k).to_numpy())
            rv = np.asarray(other.get_column(k).to_numpy())
            if lv.dtype == object or rv.dtype == object:
                return None
            v = np.concatenate([lv, rv])
            if np.issubdtype(v.dtype, np.floating) and np.isnan(v).any():
                return None
            arrays.append(_factorize_numeric(v).astype(np.int64))
        combined = arrays[0]
        for a in arrays[1:]:
            radix = int(a.max(initial=0)) + 1
            if int(combined.max(initial=0)) > (2**62) // radix:
                # the mixed-radix code would overflow int64 (numpy wraps
                # silently, colliding distinct key tuples) — compact the
                # running code to dense [0, n_distinct) first
                combined = _factorize_numeric(combined).astype(np.int64)
                if int(combined.max(initial=0)) > (2**62) // radix:
                    return None  # still too wide: generic sort-merge path
            combined = combined * radix + a
        if len(arrays) > 1:
            combined = _factorize_numeric(combined)
        return combined[: self.height], combined[self.height :]

    def join(
        self,
        other: "DataFrame",
        on: Union[str, List[str], None] = None,
        how: str = "inner",
    ) -> "DataFrame":
        """Vectorized hash join: native O(n+m) hash codes + counting-sort
        positions; generic keys (object / NaN) fall back to sort-merge. No
        per-row Python loops either way. ``how`` covers inner / left /
        full (alias outer, key columns coalesced) / semi / anti / cross."""
        assert how in ("inner", "left", "full", "outer", "semi", "anti", "cross"), how
        if how == "cross":
            assert on is None, "cross join takes no key columns"
            n, m = self.height, len(other)
            li = np.repeat(np.arange(n), m)
            ri = np.tile(np.arange(m), n)
            cols = [c.gather(li) for c in self._columns.values()]
            for k, c in other._columns.items():
                cols.append(c.gather(ri).alias(k + "_right" if k in self._columns else k))
            return DataFrame._from_columns(cols)
        on = [on] if isinstance(on, str) else list(on)
        fast = self._join_codes(other, on) if self.height and len(other) else None
        if fast is not None:
            lcode, rcode = fast
            ncodes = int(max(lcode.max(initial=-1), rcode.max(initial=-1))) + 1
            cnt = np.bincount(rcode, minlength=ncodes)
            code_starts = np.zeros(ncodes, dtype=np.int64)
            np.cumsum(cnt[:-1], out=code_starts[1:])
            r_order = np.argsort(rcode, kind="stable")
            starts = code_starts[lcode]
            counts = cnt[lcode]
        else:
            lk, rk = self._key_array(on), other._key_array(on)
            _, inv = np.unique(np.concatenate([lk, rk]), return_inverse=True)
            lcode, rcode = inv[: len(lk)], inv[len(lk):]
            r_order = np.argsort(rcode, kind="stable")
            r_sorted = rcode[r_order]
            starts = np.searchsorted(r_sorted, lcode, "left")
            counts = np.searchsorted(r_sorted, lcode, "right") - starts
        if how == "semi":
            return self._take_rows(np.where(counts > 0)[0])
        if how == "anti":
            return self._take_rows(np.where(counts == 0)[0])
        if how in ("full", "outer"):
            out = self._join_with_positions(other, on, "left", counts, starts, r_order)
            # right rows whose key never appears on the left, appended with
            # nulls in the left-only columns and coalesced key values
            if len(rcode):
                l_present = np.isin(rcode, lcode) if fast is None else (
                    np.bincount(lcode, minlength=int(rcode.max(initial=-1)) + 1)[rcode] > 0
                )
            else:
                l_present = np.zeros(0, dtype=bool)
            extra_r = np.where(~l_present)[0]
            if len(extra_r) == 0:
                return out
            cols2: List[AnySeries] = []
            for k, c in self._columns.items():
                if k in on:
                    cols2.append(other.get_column(k).gather(extra_r).alias(k))
                else:
                    cols2.append(_null_column(c, len(extra_r)))
            for k, c in other._columns.items():
                if k in on:
                    continue
                name = k + "_right" if k in self._columns else k
                cols2.append(c.gather(extra_r).alias(name))
            return concat([out, DataFrame._from_columns(cols2)])
        return self._join_with_positions(other, on, how, counts, starts, r_order)

    def _join_with_positions(self, other, on, how, counts, starts, r_order) -> "DataFrame":
        if how == "left":
            matched = counts > 0
            counts = np.maximum(counts, 1)  # unmatched keep one null row
        total = int(counts.sum())
        li = np.repeat(np.arange(self.height), counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total) - np.repeat(offsets, counts)
        ri_pos = np.repeat(starts, counts) + within
        if how == "left":
            valid_r = np.repeat(matched, counts)
            if len(r_order) == 0:  # empty right frame: all rows unmatched
                ri = np.zeros(total, dtype=np.int64)
            else:
                ri = r_order[np.where(valid_r, np.minimum(ri_pos, len(r_order) - 1), 0)]
        else:
            valid_r = None
            ri = r_order[ri_pos]
        cols = [c.gather(li) for c in self._columns.values()]
        for k, c in other._columns.items():
            if k in self._columns:
                if k in on:
                    continue
                c = c.alias(k + "_right")
            if valid_r is not None and len(other) == 0:
                cols.append(_null_column(c, total))
                continue
            rcol = c.gather(ri)
            if valid_r is not None:
                rcol = _mask_rows(rcol, valid_r)
            cols.append(rcol)
        return DataFrame._from_columns(cols)

    # ---------------------------------------------------------------- #
    def to_numpy(self) -> np.ndarray:
        arrs = []
        for c in self._columns.values():
            a = c.to_numpy()
            arrs.append(a[:, None] if a.ndim == 1 else a)
        if any(a.dtype == object for a in arrs):
            arrs = [a.astype(object) for a in arrs]
        else:
            arrs = [a.astype(np.float64) for a in arrs]
        return np.concatenate(arrs, axis=1)

    def to_dict(self, as_series: bool = True):
        if as_series:
            return dict(self._columns)
        return {k: c.to_numpy() for k, c in self._columns.items()}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: list(c.to_numpy()) for k, c in self._columns.items()})

    def lazy(self) -> "LazyFrame":
        return LazyFrame(self)

    def rechunk(self) -> "DataFrame":
        return self

    def item(self):
        assert self.shape == (1, 1)
        return next(iter(self._columns.values())).item()

    def count(self) -> "DataFrame":
        return DataFrame(
            {k: np.asarray([float(c.count() if isinstance(c, Series) else len(c))])
             for k, c in self._columns.items()}
        )

    def max_horizontal(self) -> Series:
        arr = self.to_numpy().astype(np.float64)
        return Series("max", arr.max(axis=1))

    def __repr__(self) -> str:  # pragma: no cover
        return f"DataFrame(shape={self.shape}, columns={self.columns})"


def _mask_rows(col: AnySeries, keep: np.ndarray) -> AnySeries:
    """Null-out rows of any column type where ``keep`` is False (left-join
    unmatched rows). Float/struct columns carry validity; statistics columns
    NaN their metric arrays; object columns take None."""
    if isinstance(col, Series):
        return Series(col.name, col._values, col.valid_mask() & jnp.asarray(keep))
    if isinstance(col, StructSeries):
        valid = col.validity if col.validity is not None else jnp.ones_like(col.values, dtype=bool)
        return StructSeries(col.name, col.field_names, col.values,
                            valid & jnp.asarray(keep)[:, None])
    if isinstance(col, StatisticsSeries):
        kd = jnp.asarray(keep)
        arrays = {
            k: jnp.where(kd if v.ndim == 1 else kd[:, None], v, jnp.nan)
            for k, v in col.arrays.items()
        }
        return StatisticsSeries(col.name, col.feature_names, arrays)
    if isinstance(col, ObjectSeries):
        return ObjectSeries(
            col.name, [v if ok else None for v, ok in zip(col.values, keep)]
        )
    return col


def _null_column(col: AnySeries, n: int) -> AnySeries:
    """An all-null column of height ``n`` matching ``col``'s type (left join
    against an empty right frame)."""
    if isinstance(col, StructSeries):
        k = len(col.field_names)
        return StructSeries(col.name, col.field_names, jnp.zeros((n, k)),
                            jnp.zeros((n, k), dtype=bool))
    if isinstance(col, StatisticsSeries):
        arrays = {
            k: jnp.full((n,) + v.shape[1:], jnp.nan) for k, v in col.arrays.items()
        }
        return StatisticsSeries(col.name, col.feature_names, arrays)
    if isinstance(col, ObjectSeries):
        return ObjectSeries(col.name, [None] * n)
    return Series(col.name, np.zeros(n), np.zeros(n, dtype=bool))


def _broadcast(s: AnySeries, n: int) -> AnySeries:
    if len(s) == n:
        return s
    assert len(s) == 1, f"cannot broadcast column {s.name!r} of height {len(s)} to {n}"
    idx = np.zeros(n, dtype=int)
    return s.gather(idx)


class GroupBy:
    def __init__(self, df: DataFrame, keys: List[str]):
        self._df = df
        self._keys = keys

    def _layout(self):
        from .engine.groups import layout_for_columns

        return layout_for_columns([self._df.get_column(k) for k in self._keys])

    def _boundary_indices(self):
        """Vectorized per-group (first_idx, last_idx) row positions."""
        layout = self._layout()
        starts = np.zeros(layout.num_groups, dtype=np.int64)
        np.cumsum(layout.counts[:-1], out=starts[1:])
        first_idx = layout.order[starts]
        last_idx = layout.order[starts + layout.counts - 1]
        return layout, first_idx, last_idx

    def last(self) -> DataFrame:
        _, _, last_idx = self._boundary_indices()
        return DataFrame._from_columns(
            [c.gather(last_idx) for c in self._df._columns.values()]
        )

    def first(self) -> DataFrame:
        _, first_idx, _ = self._boundary_indices()
        return DataFrame._from_columns(
            [c.gather(first_idx) for c in self._df._columns.values()]
        )

    def agg(self, *exprs, **named) -> DataFrame:
        """One output row per group: aggregation expressions reduce with
        segment ops; other expressions (e.g. least-squares coefficients /
        statistics, which are group-constant under the grouped engine)
        evaluate in the .over context and keep each group's first row —
        the role polars' aggregation engine plays for the reference
        (SURVEY layer L3)."""
        layout, first_idx, _ = self._boundary_indices()
        out: List[AnySeries] = [
            self._df.get_column(k).gather(first_idx) for k in self._keys
        ]
        all_exprs: List[Expr] = []
        for e in exprs:
            e = parse_into_expr(e)
            all_exprs.extend(e.expand(self._df))
        for name, e in named.items():
            all_exprs.append(parse_into_expr(e).alias(name))
        for e in all_exprs:
            out.append(e.evaluate_grouped(self._df, layout, first_idx))
        return DataFrame._from_columns(out)


class LazyFrame:
    """Deferred query plan over a DataFrame.

    Chained operations record (method, args) plan nodes; nothing executes —
    no expression evaluation, no device work — until `.collect()` replays
    the plan (the role of the polars lazy planner the reference relies on,
    SURVEY layer L3). The engine's per-query fusion happens inside each
    expression evaluation, so collect-time replay preserves the fused
    device programs while keeping plan construction free."""

    def __init__(self, df: DataFrame, plan: Optional[List] = None):
        self._df = df
        self._plan = plan or []
        self._collected: Optional[DataFrame] = None

    def collect(self) -> DataFrame:
        # plans are immutable (deferral builds a new LazyFrame), so the
        # collected frame is cached: metadata access (.columns, .height...)
        # between collects no longer replays the whole plan each time
        if self._collected is None:
            out = self._df
            for name, args, kwargs in self._plan:
                out = getattr(out, name)(*args, **kwargs)
            self._collected = out
        return self._collected

    def explain(self) -> str:
        """Render the deferred plan (top = first executed)."""
        lines = [f"DF [{', '.join(self._df.columns)}]"]
        lines += [f"  .{name}(...)" for name, _, _ in self._plan]
        return "\n".join(lines)

    # frame -> frame transformations defer; anything else (to_numpy, item,
    # metadata) forces a collect so values come back eagerly
    _DEFERRABLE = frozenset(
        {
            "select", "with_columns", "with_row_index", "filter", "fill_null",
            "fill_nan", "drop_nulls", "drop", "rename", "unnest", "explode",
            "sort", "join", "unique", "head", "tail", "slice",
        }
    )

    def __getattr__(self, name):
        if name in LazyFrame._DEFERRABLE:
            def defer(*args, **kwargs):
                return LazyFrame(self._df, self._plan + [(name, args, kwargs)])

            return defer
        return getattr(self.collect(), name)


def concat(frames: List[DataFrame], how: str = "vertical", rechunk: bool = True) -> DataFrame:
    assert how in ("vertical", "horizontal"), how
    if how == "horizontal":
        heights = {f.height for f in frames}
        assert len(heights) == 1, f"horizontal concat requires equal heights, got {heights}"
        cols: List[AnySeries] = []
        seen: set = set()
        for f in frames:
            for name, c in f._columns.items():
                assert name not in seen, f"duplicate column {name!r} in horizontal concat"
                seen.add(name)
                cols.append(c)
        return DataFrame._from_columns(cols)
    names = frames[0].columns
    cols: List[AnySeries] = []
    for name in names:
        parts = [f.get_column(name) for f in frames]
        if isinstance(parts[0], Series):
            if all(isinstance(p, Series) and p.is_float for p in parts):
                # stay on device and carry validity through: a to_numpy
                # round-trip would re-derive validity as ~isnan, silently
                # turning valid NaN values into nulls (null != NaN here,
                # like polars — see series.py construction semantics)
                vals = jnp.concatenate([jnp.asarray(p.values) for p in parts])
                if all(p.validity is None for p in parts):
                    validity = None
                else:
                    validity = jnp.concatenate([p.valid_mask() for p in parts])
                cols.append(Series(name, vals, validity))
            else:
                vals = np.concatenate([p.to_numpy() for p in parts])
                validity = ~np.isnan(vals) if np.isnan(vals).any() else None
                cols.append(Series(name, vals, validity))
        elif isinstance(parts[0], StructSeries):
            vals = jnp.concatenate([p.values for p in parts], axis=0)
            valid = jnp.concatenate([p.validity if p.validity is not None
                                     else jnp.ones_like(p.values, dtype=bool) for p in parts], axis=0)
            cols.append(StructSeries(name, parts[0].field_names, vals, valid))
        elif isinstance(parts[0], StatisticsSeries):
            assert all(
                isinstance(p, StatisticsSeries)
                and p.feature_names == parts[0].feature_names
                for p in parts
            ), "statistics columns with differing features cannot be concatenated"
            arrays = {
                k: jnp.concatenate([p.arrays[k] for p in parts], axis=0)
                for k in parts[0].SCALAR_FIELDS + parts[0].LIST_FIELDS
            }
            cols.append(StatisticsSeries(name, parts[0].feature_names, arrays))
        else:
            items: list = []
            for p in parts:
                items.extend(p.values)
            cols.append(ObjectSeries(name, items))
    return DataFrame._from_columns(cols)
