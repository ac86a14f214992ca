"""Columnar series types backed by JAX device arrays.

A :class:`Series` stores values plus an explicit validity mask. Like polars
(and unlike raw numpy), *null* is distinct from *NaN*: validity is carried as
a separate boolean array so the six null policies of the reference
(src/expressions.rs:201-296) can be expressed as pure mask transforms on
device. Invalid slots may contain arbitrary values; all consumers must go
through the validity mask. ``to_numpy`` materialises invalid slots as NaN,
matching how the reference converts null -> NaN at its FFI boundary.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from .config import CONFIG  # noqa: F401  (ensures x64 is enabled first)

import jax
import jax.numpy as jnp


def _is_float_dtype(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.floating)


class BlockPermuted:
    """Deferred row-order view of block-laid-out values.

    The grouped engine computes per-row results in its split-padded block
    layout; restoring row order is a pure [N]-element permutation gather.
    Most consumers never need row order on
    device (reductions, tail checks, host fetches of slices), so the
    permutation is carried symbolically and materialised once on first
    full-column access. Point/slice access gathers through the index map
    (two tiny gathers) without touching the other N-1 rows.
    """

    __slots__ = ("flat", "idx", "pair")

    def __init__(self, flat, idx, pair: bool = False) -> None:
        self.flat = flat  # [S*R] block-ordered values
        self.idx = idx  # [N] row-order gather map into flat
        self.pair = pair  # gather as f32 (hi, lo) pairs (exact to 2^-48)

    def __len__(self) -> int:
        return int(self.idx.shape[0])

    @property
    def shape(self):
        return (len(self),)

    @property
    def dtype(self):
        return self.flat.dtype

    def materialize(self) -> jnp.ndarray:
        if not self.pair:
            return jnp.take(self.flat, self.idx, axis=0)
        hi = self.flat.astype(jnp.float32)
        lo = (self.flat - hi.astype(jnp.float64)).astype(jnp.float32)
        pairs = jnp.stack([hi, lo], axis=-1)
        out = jnp.take(pairs, self.idx, axis=0)
        return out[:, 0].astype(jnp.float64) + out[:, 1].astype(jnp.float64)

    def take(self, indices) -> jnp.ndarray:
        """Row-order point access: two small gathers, no full permutation."""
        return jnp.take(self.flat, jnp.take(self.idx, jnp.asarray(indices)), axis=0)


class Series:
    """A named 1-D column with optional validity mask.

    Numeric float data lives on device (jnp arrays, f64 by default). Integer
    and object (string) data — typically group keys — stays host-side as
    numpy arrays, since group factorization runs on host.
    """

    __slots__ = ("name", "_values", "validity", "_layout_cache", "__weakref__")

    def __init__(
        self,
        name: str,
        values,
        validity: Optional[np.ndarray] = None,
    ) -> None:
        self.name = name
        if isinstance(values, Series):
            validity = values.validity if validity is None else validity
            values = values._values
        if isinstance(values, BlockPermuted):
            self._values = values
            self.validity = (
                jnp.asarray(validity, dtype=bool) if validity is not None else None
            )
            return
        if isinstance(values, (list, tuple)):
            arr = np.asarray(values, dtype=object)
            none_mask = np.array([v is None for v in values], dtype=bool)
            if none_mask.any():
                filled = [0.0 if v is None else v for v in values]
                try:
                    values = np.asarray(filled, dtype=np.float64)
                except (TypeError, ValueError):
                    values = arr
                if validity is None:
                    validity = ~none_mask
            else:
                try:
                    values = np.asarray(values)
                except (TypeError, ValueError):
                    values = arr
        if isinstance(values, np.ndarray) and _is_float_dtype(values.dtype):
            nan_mask = np.isnan(values)
            if nan_mask.any() and validity is None:
                # NaN stays NaN (valid) on construction — polars semantics.
                pass
            values = jnp.asarray(values, dtype=jnp.float64)
        self._values = values
        if validity is not None:
            validity = jnp.asarray(validity, dtype=bool)
        self.validity = validity

    # ------------------------------------------------------------------ #
    @property
    def values(self):
        """Column values; a deferred block permutation materialises (and is
        cached) on first full-column access."""
        v = self._values
        if isinstance(v, BlockPermuted):
            v = v.materialize()
            self._values = v
        return v

    @values.setter
    def values(self, v) -> None:
        self._values = v

    @property
    def is_lazy(self) -> bool:
        return isinstance(self._values, BlockPermuted)

    @property
    def is_float(self) -> bool:
        if isinstance(self._values, BlockPermuted):
            return True
        return isinstance(self._values, jnp.ndarray) and jnp.issubdtype(
            self._values.dtype, jnp.floating
        )

    def __len__(self) -> int:
        return int(self._values.shape[0])

    @property
    def height(self) -> int:
        return len(self)

    def alias(self, name: str) -> "Series":
        return Series(name, self._values, self.validity)

    def valid_mask(self) -> jnp.ndarray:
        """Validity as a device bool array (all-True if no mask)."""
        if self.validity is None:
            return jnp.ones(len(self), dtype=bool)
        return self.validity

    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int((~self.validity).sum())

    def is_null(self) -> "Series":
        return Series(self.name, np.asarray(~self.valid_mask()))

    def is_not_null(self) -> "Series":
        return Series(self.name, np.asarray(self.valid_mask()))

    def fill_null(self, value: float) -> "Series":
        if self.validity is None:
            return self
        vals = jnp.where(self.validity, jnp.asarray(self.values), value)
        return Series(self.name, vals, None)

    def forward_fill(self) -> "Series":
        vals = self.to_numpy()
        mask = np.isnan(vals)
        idx = np.where(~mask, np.arange(len(vals)), -1)
        np.maximum.accumulate(idx, out=idx)
        out = np.where(idx >= 0, vals[np.maximum(idx, 0)], np.nan)
        validity = ~np.isnan(out)
        return Series(self.name, np.nan_to_num(out), validity)

    # ------------------------------------------------------------------ #
    def to_numpy(self) -> np.ndarray:
        """Materialise with invalid slots as NaN (float) / None (object)."""
        if isinstance(self.values, jnp.ndarray):
            vals = np.asarray(self.values)
        else:
            vals = self.values
        if self.validity is not None:
            mask = np.asarray(self.validity)
            if _is_float_dtype(vals.dtype):
                vals = np.where(mask, vals, np.nan)
            else:
                vals = np.asarray(
                    [v if ok else None for v, ok in zip(vals.tolist(), mask)],
                    dtype=object,
                )
        return vals

    def to_list(self) -> list:
        vals = self.to_numpy()
        return [None if (isinstance(v, float) and np.isnan(v)) else v for v in vals.tolist()]

    def gather(self, indices: np.ndarray) -> "Series":
        if isinstance(self._values, BlockPermuted):
            vals = self._values.take(indices)  # two-hop gather, stays lazy-cheap
        elif isinstance(self._values, jnp.ndarray):
            vals = jnp.take(self._values, jnp.asarray(indices), axis=0)
        else:
            vals = self._values[np.asarray(indices)]
        validity = None
        if self.validity is not None:
            validity = jnp.take(self.validity, jnp.asarray(indices), axis=0)
        return Series(self.name, vals, validity)

    def head(self, n: int) -> "Series":
        return self.gather(np.arange(min(n, len(self))))

    def tail(self, n: int) -> "Series":
        m = len(self)
        return self.gather(np.arange(max(0, m - n), m))

    def filter(self, mask: np.ndarray) -> "Series":
        mask = np.asarray(mask, dtype=bool)
        return self.gather(np.nonzero(mask)[0])

    def slice(self, offset: int, length: Optional[int] = None) -> "Series":
        stop = len(self) if length is None else offset + length
        idx = np.arange(offset, min(stop, len(self)))
        return self.gather(idx)

    def __getitem__(self, i):
        if isinstance(i, slice):
            idx = np.arange(len(self))[i]
            return self.gather(idx)
        v = self.to_numpy()[i]
        return v

    def item(self):
        assert len(self) == 1, f"Series {self.name} has {len(self)} values"
        return self[0]

    # ---- null-aware scalar reductions (polars Series surface) ---- #
    def _valid_values(self) -> np.ndarray:
        vals = self.to_numpy()
        if self.validity is None:
            return vals
        return vals[np.asarray(self.valid_mask())]

    def sum(self) -> float:
        v = self._valid_values()
        return float(v.sum()) if len(v) else 0.0

    def mean(self) -> Optional[float]:
        v = self._valid_values()
        return float(v.mean()) if len(v) else None

    def min(self) -> Optional[float]:
        v = self._valid_values()
        return float(v.min()) if len(v) else None

    def max(self) -> Optional[float]:
        v = self._valid_values()
        return float(v.max()) if len(v) else None

    def std(self, ddof: int = 1) -> Optional[float]:
        v = self._valid_values()
        return float(v.std(ddof=ddof)) if len(v) > ddof else None

    def var(self, ddof: int = 1) -> Optional[float]:
        v = self._valid_values()
        return float(v.var(ddof=ddof)) if len(v) > ddof else None

    def median(self) -> Optional[float]:
        v = self._valid_values()
        return float(np.median(v)) if len(v) else None

    def count(self) -> int:
        return len(self) - self.null_count()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Series(name={self.name!r}, len={len(self)}, nulls={self.null_count()})"


class StructSeries:
    """A struct-typed column: named fields over a shared [N, K] value matrix.

    This mirrors the reference's coefficient/prediction struct outputs
    (src/expressions.rs:114-143): a 2-D f64 array with per-field validity
    (NaN entries become nulls) plus an optional per-row outer validity.
    """

    __slots__ = ("name", "field_names", "values", "validity")

    def __init__(
        self,
        name: str,
        field_names: Sequence[str],
        values,
        validity: Optional[jnp.ndarray] = None,
    ) -> None:
        self.name = name
        self.field_names = list(field_names)
        self.values = jnp.asarray(values, dtype=jnp.float64)
        assert self.values.ndim == 2 and self.values.shape[1] == len(self.field_names)
        if validity is not None:
            validity = jnp.asarray(validity, dtype=bool)
            if validity.ndim == 1:
                validity = validity[:, None] & jnp.ones_like(self.values, dtype=bool)
        self.validity = validity

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def height(self) -> int:
        return len(self)

    def alias(self, name: str) -> "StructSeries":
        return StructSeries(name, self.field_names, self.values, self.validity)

    def fields(self) -> List[Series]:
        cols = []
        for j, fname in enumerate(self.field_names):
            validity = None if self.validity is None else self.validity[:, j]
            cols.append(Series(fname, self.values[:, j], validity))
        return cols

    def field(self, fname: str) -> Series:
        j = self.field_names.index(fname)
        validity = None if self.validity is None else self.validity[:, j]
        return Series(fname, self.values[:, j], validity)

    def to_numpy(self) -> np.ndarray:
        vals = np.asarray(self.values)
        if self.validity is not None:
            vals = np.where(np.asarray(self.validity), vals, np.nan)
        return vals

    def gather(self, indices: np.ndarray) -> "StructSeries":
        idx = jnp.asarray(indices)
        validity = None if self.validity is None else jnp.take(self.validity, idx, axis=0)
        return StructSeries(
            self.name, self.field_names, jnp.take(self.values, idx, axis=0), validity
        )

    def filter(self, mask: np.ndarray) -> "StructSeries":
        mask = np.asarray(mask, dtype=bool)
        return self.gather(np.nonzero(mask)[0])

    def valid_mask(self) -> jnp.ndarray:
        """Per-row validity: a struct row is null if all fields are null."""
        if self.validity is None:
            return jnp.ones(len(self), dtype=bool)
        return self.validity.any(axis=1)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"StructSeries(name={self.name!r}, fields={self.field_names}, len={len(self)})"
        )


@jax.jit
def _gather_fields(base, chain):
    """Gather every statistics field with one compiled program (an eager
    per-field loop pays a dispatch per field).

    ``chain`` is a tuple of index maps applied outermost-first: the final
    row index is chain[0][chain[1][...]] — gathers of gathers compose
    inside this one program instead of paying an eager dispatch each.

    All fields are packed into ONE [G, 3+4K] matrix and broadcast to rows
    with a single slice-size-C gather: one gather of C-wide slices in
    place of 7 separate takes."""
    idx = chain[-1]
    for link in chain[-2::-1]:
        idx = jnp.take(link, idx, axis=0)
    cols = [v[:, None] if v.ndim == 1 else v for v in base]
    packed = jnp.concatenate(cols, axis=1)
    out = jnp.take(packed, idx, axis=0)
    outs = []
    off = 0
    for v, m in zip(base, cols):
        w = m.shape[1]
        sl = out[:, off : off + w]
        outs.append(sl[:, 0] if v.ndim == 1 else sl)
        off += w
    return tuple(outs)


@jax.jit
def _pack_fields(scalars, lists):
    """[len] scalar fields + [len, K] list fields -> one [len, 3+4K] array
    so host materialisation is a single device->host transfer."""
    cols = [s[:, None] for s in scalars] + list(lists)
    return jnp.concatenate(cols, axis=1)


class StatisticsSeries:
    """Device-native statistics struct column.

    The reference returns a typed struct Series with scalar fields
    (r2/mae/mse) and list fields (feature_names, coefficients,
    standard_errors, t_values, p_values) — src/expressions.rs:448-509.
    Here every numeric field stays a device array ([G] scalars, [G, K]
    lists): queries over 10k groups do O(1) host work, gathers/joins stay
    on device, and the dict-row representation is materialised lazily (one
    fetch per field) only when a host consumer asks for it.

    Row broadcast is deferred: ``.over(keys)`` (and joins/filters) record
    an index map over the [G]-level base arrays instead of gathering
    (3 + 4K) x N elements per query — the BlockPermuted idea applied to
    struct columns. Gathers compose *lazily* (a chain of index maps folded
    inside one device program); ``.arrays`` materialises (and caches) the
    row-level view on first access.
    """

    __slots__ = ("name", "feature_names", "_base", "_row_index", "_mat", "_rows")

    SCALAR_FIELDS = ("r2", "mae", "mse")
    LIST_FIELDS = ("coefficients", "standard_errors", "t_values", "p_values")

    def __init__(
        self,
        name: str,
        feature_names: Sequence[str],
        arrays: dict,
        row_index=None,
    ) -> None:
        self.name = name
        self.feature_names = list(feature_names)
        self._base = arrays  # field -> device array, [G] or [G, K]
        # chain of index maps into the base, applied outermost-first
        # (composed lazily inside `_gather_fields`), or None
        if row_index is not None and not isinstance(row_index, tuple):
            row_index = (row_index,)
        self._row_index = row_index
        self._mat = None
        self._rows = None

    def __len__(self) -> int:
        if self._row_index is not None:
            return int(self._row_index[-1].shape[0])
        return int(self._base["r2"].shape[0])

    @property
    def height(self) -> int:
        return len(self)

    @property
    def arrays(self) -> dict:
        """Row-level field arrays (materialises a deferred broadcast).

        All fields gather in ONE device program (`_gather_fields`) over the
        lazily-composed index chain, not one dispatch per field. The suite
        row `statistics_mat` times this full row view."""
        if self._row_index is None:
            return self._base
        if self._mat is None:
            keys = tuple(self._base.keys())
            gathered = _gather_fields(
                tuple(self._base[k] for k in keys), self._row_index
            )
            self._mat = dict(zip(keys, gathered))
        return self._mat

    def composed_index(self):
        """Final per-row index into the base arrays (host numpy), or None
        when the series is base-level (host consumers, e.g. unique-keying)."""
        if self._row_index is None:
            return None
        idx = np.asarray(self._row_index[-1])
        for link in self._row_index[-2::-1]:
            idx = np.asarray(link)[idx]
        return idx

    def head(self, n: int = 5) -> "StatisticsSeries":
        return self.gather(np.arange(min(n, len(self))))

    def tail(self, n: int = 5) -> "StatisticsSeries":
        return self.gather(np.arange(max(0, len(self) - n), len(self)))

    def alias(self, name: str) -> "StatisticsSeries":
        return StatisticsSeries(
            name, self.feature_names, self._base, self._row_index
        )

    def gather(self, indices) -> "StatisticsSeries":
        # keep device-resident indices on device (a numpy round-trip would
        # fetch + re-upload an [N]-sized map per call)
        if isinstance(indices, jax.Array):
            idx = indices
        else:
            idx = jnp.asarray(np.asarray(indices))
        # defer composition: an eager take here would pay a dispatch per
        # gather-of-gather; the chain folds inside `_gather_fields`
        chain = (idx,) if self._row_index is None else self._row_index + (idx,)
        return StatisticsSeries(self.name, self.feature_names, self._base, chain)

    def filter(self, mask) -> "StatisticsSeries":
        mask = np.asarray(mask, dtype=bool)
        return self.gather(np.nonzero(mask)[0])

    # ---- host materialisation (lazy) ---- #
    @property
    def values(self) -> list:
        if self._rows is None:
            # pack every field into one [len, 3 + 4K] array on device and
            # fetch it in ONE transfer (not one per field)
            arrays = self.arrays
            packed = np.asarray(_pack_fields(
                tuple(arrays[k] for k in self.SCALAR_FIELDS),
                tuple(arrays[k] for k in self.LIST_FIELDS),
            ))
            k = len(self.feature_names)
            rows = []
            for g in range(len(self)):
                row = {
                    key: float(packed[g, i])
                    for i, key in enumerate(self.SCALAR_FIELDS)
                }
                row["feature_names"] = list(self.feature_names)
                for j, key in enumerate(self.LIST_FIELDS):
                    lo = len(self.SCALAR_FIELDS) + j * k
                    row[key] = packed[g, lo : lo + k].tolist()
                rows.append(row)
            self._rows = rows
        return self._rows

    def to_list(self) -> list:
        return list(self.values)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.values, dtype=object)

    def __getitem__(self, i):
        return self.values[i]

    def item(self):
        assert len(self) == 1
        return self.values[0]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"StatisticsSeries(name={self.name!r}, len={len(self)}, "
            f"features={self.feature_names})"
        )


class ObjectSeries:
    """Host-side column of arbitrary Python objects (e.g. list-valued
    statistics fields mirroring the reference's statistics struct,
    src/expressions.rs:448-466)."""

    __slots__ = ("name", "values", "_layout_cache", "__weakref__")

    def __init__(self, name: str, values: Iterable) -> None:
        self.name = name
        self.values = list(values)

    def __len__(self) -> int:
        return len(self.values)

    @property
    def height(self) -> int:
        return len(self)

    def alias(self, name: str) -> "ObjectSeries":
        return ObjectSeries(name, self.values)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.values, dtype=object)

    def to_list(self) -> list:
        return list(self.values)

    def gather(self, indices) -> "ObjectSeries":
        return ObjectSeries(self.name, [self.values[int(i)] for i in np.asarray(indices)])

    def filter(self, mask) -> "ObjectSeries":
        mask = np.asarray(mask, dtype=bool)
        return ObjectSeries(self.name, [v for v, m in zip(self.values, mask) if m])

    def __getitem__(self, i):
        return self.values[i]

    def item(self):
        assert len(self.values) == 1
        return self.values[0]


AnySeries = Union[Series, StructSeries, ObjectSeries, StatisticsSeries]
