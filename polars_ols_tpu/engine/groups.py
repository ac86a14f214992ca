"""Group factorization and batched layouts.

This replaces the polars engine's hash-partitioned group_by/over dispatch
(reference layer L3; the plugin was invoked once per group on rayon threads,
README:19). Here groups become a *batch axis*: rows are factorized into
integer group ids on the host, then laid out on device either as

  * split-padded row blocks ``[S, R_cap, ...]`` feeding batched matmuls
    for moment (XtX / Xty) accumulation — heavy groups are split into
    multiple blocks whose partial moments are segment-summed (this is the
    same associativity that lets multi-chip shards psum-merge partial
    moments, SURVEY §2.3); or
  * fully-padded per-group layouts ``[G, R_max, ...]`` for solvers that need
    whole groups contiguous (SVD minimum-norm, coordinate descent, scans).

If the native C++ accelerator (engine/native) is built, factorization of
integer keys uses its O(N) hash table instead of numpy's sort-based unique.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# owners of device-resident caches (GroupLayouts and Series); clear_caches()
# walks this to release materialized partitions / digit planes / layouts
_CACHE_OWNERS: "weakref.WeakSet" = weakref.WeakSet()

# single-group (no .over()) layouts memoized on row count: the layout's
# content depends only on n, and rebuilding it per query used to discard the
# device-resident blocks/digit caches hanging off `_dev` — every single-frame
# query re-paid the padded gather + digit decompose dispatches. Small LRU:
# big-N host index arrays are hundreds of MB.
_SINGLE_LAYOUTS: Dict[int, "GroupLayout"] = {}
_SINGLE_LAYOUTS_LIMIT = 4


def single_layout(n_rows: int) -> "GroupLayout":
    layout = _SINGLE_LAYOUTS.get(n_rows)
    if layout is None:
        layout = build_layout(None, n_rows)
        register_cache_owner(layout)
        if len(_SINGLE_LAYOUTS) >= _SINGLE_LAYOUTS_LIMIT:
            _SINGLE_LAYOUTS.pop(next(iter(_SINGLE_LAYOUTS)))
        _SINGLE_LAYOUTS[n_rows] = layout
    else:
        _SINGLE_LAYOUTS[n_rows] = _SINGLE_LAYOUTS.pop(n_rows)  # LRU touch
    return layout


def register_cache_owner(obj) -> None:
    try:
        _CACHE_OWNERS.add(obj)
    except TypeError:
        # genuinely non-weakref-able (e.g. __slots__ without __weakref__)
        pass


def clear_caches() -> None:
    """Release all device-resident caches (materialized partitions, digit
    planes, layout index tensors, column stacks). Frees accelerator memory
    between unrelated workloads; subsequent queries rebuild lazily."""
    for obj in list(_CACHE_OWNERS):
        if isinstance(obj, GroupLayout):
            obj._dev.clear()
        else:
            cache = getattr(obj, "_layout_cache", None)
            if cache:
                cache.clear()
    _SINGLE_LAYOUTS.clear()

from ..series import ObjectSeries, Series


def factorize_columns(cols: Sequence) -> np.ndarray:
    """Factorize one or more key columns into dense group ids [N] (host)."""
    arrays = []
    for c in cols:
        if isinstance(c, ObjectSeries):
            _, inv = np.unique(np.asarray(c.values, dtype=object), return_inverse=True)
        else:
            vals = c.to_numpy()
            if vals.dtype == object:
                _, inv = np.unique(vals.astype(str), return_inverse=True)
            else:
                inv = _factorize_numeric(np.asarray(vals))
        arrays.append(inv.astype(np.int64))
    if len(arrays) == 1:
        return arrays[0]
    combined = arrays[0]
    for a in arrays[1:]:
        radix = int(a.max(initial=0)) + 1
        if int(combined.max(initial=0)) > (2**62) // radix:
            # compact before the mixed-radix step: numpy wraps int64
            # silently, which would collide distinct key tuples
            combined = _factorize_numeric(combined)
        combined = combined * radix + a
    return _factorize_numeric(combined).astype(np.int64)


def _factorize_numeric(vals: np.ndarray) -> np.ndarray:
    from .native import native_factorize

    if np.issubdtype(vals.dtype, np.floating):
        ints = vals.astype(np.int64)
        if np.all(ints.astype(vals.dtype) == vals):
            vals = ints
        elif not np.isnan(vals).any():
            # non-integral floats: factorize the canonicalized bit pattern
            # (+0.0 == -0.0; bit equality == value equality without NaNs),
            # then remap first-seen ids to sorted-unique order in native.py
            canon = np.where(vals == 0.0, 0.0, vals.astype(np.float64))
            out = native_factorize(canon.view(np.int64), sort_keys=canon)
            if out is not None:
                return out
    if np.issubdtype(vals.dtype, np.integer):
        vals = vals.astype(np.int64)
        if len(vals):
            # dense-range fast path (the common case: group keys are small
            # integers): two passes through cache-resident value tables
            # beat the open-addressing probes over a 2N-slot hash table.
            # Output ids are value-sorted by
            # construction — numpy.unique parity without any remap.
            lo, hi = int(vals.min()), int(vals.max())
            span = hi - lo
            if 0 <= span <= max(min(4 * len(vals), 1 << 20), 1024):
                off = vals - lo
                present = np.zeros(span + 1, dtype=bool)
                present[off] = True
                ids = np.cumsum(present, dtype=np.int64) - 1
                return ids[off]
        out = native_factorize(vals)
        if out is not None:
            return out
    _, inv = np.unique(vals, return_inverse=True)
    return inv


@dataclass(eq=False)  # identity hash/eq: layouts must be weakref-registrable
class GroupLayout:
    """Host-computed layout metadata for a batch of groups.

    Device index tensors derived from it (gather maps for the padded and
    split-padded layouts, per-row group ids) are built once and memoized in
    ``_dev`` — layouts are cached per group-key column (see
    `factorize_cached`), so steady-state evaluation re-uses device-resident
    indices and never re-uploads them.
    """

    gids: np.ndarray  # [N] group id per row
    num_groups: int
    counts: np.ndarray  # [G] rows per group
    order: np.ndarray  # [N] stable argsort of gids (rows grouped contiguously)
    rank_in_group: np.ndarray  # [N] 0-based position of each row inside its group
    _dev: Dict = field(default_factory=dict, repr=False, compare=False)

    def device_gids(self):
        """Per-row group ids as a device int32 array."""
        import jax.numpy as jnp

        if "gids" not in self._dev:
            self._dev["gids"] = jnp.asarray(self.gids, dtype=jnp.int32)
        return self._dev["gids"]

    def device_padded(self):
        """(gather [G,R], pad_mask [G,R], R) as device arrays, memoized."""
        import jax.numpy as jnp

        if "padded" not in self._dev:
            gather, pmask, R = padded_indices(self)
            self._dev["padded"] = (
                jnp.asarray(gather.reshape(-1), dtype=jnp.int32),
                jnp.asarray(pmask),
                R,
            )
        return self._dev["padded"]

    def device_split(self, r_cap: int):
        """(gather [S*R_cap], pad_mask [S,R_cap], block_group [S], S) device
        arrays for the split-padded moment layout, memoized per r_cap."""
        import jax.numpy as jnp

        key = ("split", r_cap)
        if key not in self._dev:
            gather, pmask, block_group, S = split_padded_indices(self, r_cap)
            self._dev[key] = (
                jnp.asarray(gather.reshape(-1), dtype=jnp.int32),
                jnp.asarray(pmask),
                jnp.asarray(block_group, dtype=jnp.int32),
                S,
            )
        return self._dev[key]

    def device_split_unpad(self, r_cap: int):
        """Row-order gather map [N] out of the flattened split-padded
        [S * r_cap] layout (inverse of device_split's gather)."""
        import jax.numpy as jnp

        key = ("split_unpad", r_cap)
        if key not in self._dev:
            from .native import native_unpad_map

            counts = self.counts
            n_blocks = np.maximum(1, -(-counts // r_cap))
            block_first = np.zeros(self.num_groups, dtype=np.int64)
            np.cumsum(n_blocks[:-1], out=block_first[1:])
            flat = native_unpad_map(
                self.gids, self.rank_in_group, block_first, r_cap
            )
            if flat is None:  # numpy fallback (native library unavailable)
                blk = block_first[self.gids] + self.rank_in_group // r_cap
                flat = blk * r_cap + self.rank_in_group % r_cap
            self._dev[key] = jnp.asarray(flat, dtype=jnp.int32)
        return self._dev[key]

    def device_unpad(self, R: int):
        """Row-order scatter map [N] out of a padded [G, R] layout."""
        import jax.numpy as jnp

        key = ("unpad", R)
        if key not in self._dev:
            from .native import native_unpad_map

            flat = native_unpad_map(
                self.gids, self.rank_in_group,
                np.arange(self.num_groups, dtype=np.int64), R,
            )
            if flat is None:
                flat = self.gids * R + self.rank_in_group
            self._dev[key] = jnp.asarray(flat, dtype=jnp.int32)
        return self._dev[key]


def layout_for_columns(cols: Sequence) -> GroupLayout:
    """Factorize key columns into a GroupLayout, memoized on the first key
    column (columns are immutable; derived frames share Series objects, so
    repeated `.over()` evaluations against the same keys reuse the layout
    and its device-resident index tensors)."""
    cache = getattr(cols[0], "_layout_cache", None)
    key = tuple(id(c) for c in cols)
    if cache is not None and key in cache:
        return cache[key][0]
    gids = factorize_columns(cols)
    layout = build_layout(gids, len(gids))
    register_cache_owner(layout)
    try:
        if cache is None:
            cache = {}
            object.__setattr__(cols[0], "_layout_cache", cache)
            register_cache_owner(cols[0])
        # hold refs to the key columns so the ids in `key` stay valid
        cache[key] = (layout, tuple(cols))
    except AttributeError:  # __slots__ without cache support
        pass
    return layout


def build_layout(gids: Optional[np.ndarray], n_rows: int) -> GroupLayout:
    if gids is None:
        gids = np.zeros(n_rows, dtype=np.int64)
    if n_rows > 0:
        # native counting-sort layout: two linear passes, no argsort and no
        # N-element fancy-index gathers (the numpy fallback does both)
        from .native import native_layout_build

        num_groups = int(gids.max()) + 1
        nat = native_layout_build(gids, num_groups)
        if nat is not None:
            counts, order, rank = nat
            return GroupLayout(gids, num_groups, counts, order, rank)
    counts = np.bincount(gids).astype(np.int64)
    num_groups = len(counts)
    order = np.argsort(gids, kind="stable")
    sorted_gids = gids[order]
    # rank within group for sorted rows: index - first index of the group
    first = np.zeros(num_groups, dtype=np.int64)
    np.cumsum(counts[:-1], out=first[1:])
    rank_sorted = np.arange(n_rows, dtype=np.int64) - first[sorted_gids]
    rank = np.empty(n_rows, dtype=np.int64)
    rank[order] = rank_sorted
    return GroupLayout(gids, num_groups, counts, order, rank)


def bucket_size(n: int) -> int:
    """Round ``n`` up to a shape bucket (8 sub-buckets per power of two,
    <=12.5% padding waste). Jitted programs are keyed on array shapes, so
    bucketing the padded layout width lets one compiled program serve every
    max-group-size in the bucket instead of recompiling per exact size."""
    if n <= 8:
        return max(n, 1)
    # for n in (2^(b-1), 2^b] the step is 2^(b-4): 8 sub-buckets per octave,
    # so padded-row compute waste stays <= 12.5% while a whole octave of
    # max-group-sizes shares 8 compiled program shapes
    step = 1 << (max(0, (n - 1).bit_length() - 4))
    return -(-n // step) * step


def padded_indices(layout: GroupLayout) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row-gather indices for the fully padded [G, R_max] layout.

    Returns (gather_idx [G, R], pad_mask [G, R], R). Padding rows gather row 0
    and are masked out. R is bucketed (see `bucket_size`) to bound the number
    of distinct compiled programs across query shapes.
    """
    from .native import native_scatter_blocks

    G = layout.num_groups
    R = bucket_size(int(layout.counts.max())) if G else 0
    nat = native_scatter_blocks(
        layout.gids, layout.rank_in_group,
        np.arange(G, dtype=np.int64), R, G,
    ) if R else None
    if nat is not None:
        return nat[0], nat[1], R
    gather = np.zeros((G, R), dtype=np.int64)
    mask = np.zeros((G, R), dtype=bool)
    rows = np.arange(len(layout.gids), dtype=np.int64)
    gather[layout.gids, layout.rank_in_group] = rows
    mask[layout.gids, layout.rank_in_group] = True
    return gather, mask, R


def split_padded_indices(
    layout: GroupLayout, r_cap: int = 512
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Row-gather indices for the split-padded [S, R_cap] layout.

    Groups larger than ``r_cap`` rows are split across several blocks; the
    block -> group map enables segment-summing partial moments back to [G].
    Returns (gather_idx [S, R_cap], pad_mask [S, R_cap], block_group [S], S).
    """
    from .native import native_scatter_blocks

    counts = layout.counts
    n_blocks_per_group = np.maximum(1, -(-counts // r_cap))
    S = int(n_blocks_per_group.sum())
    block_group = np.repeat(np.arange(layout.num_groups, dtype=np.int64), n_blocks_per_group)
    block_first = np.zeros(layout.num_groups, dtype=np.int64)
    np.cumsum(n_blocks_per_group[:-1], out=block_first[1:])

    nat = native_scatter_blocks(
        layout.gids, layout.rank_in_group, block_first, r_cap, S
    )
    if nat is not None:
        return nat[0], nat[1], block_group, S

    rows = np.arange(len(layout.gids), dtype=np.int64)
    block_of_row = block_first[layout.gids] + layout.rank_in_group // r_cap
    slot_of_row = layout.rank_in_group % r_cap

    gather = np.zeros((S, r_cap), dtype=np.int64)
    mask = np.zeros((S, r_cap), dtype=bool)
    gather[block_of_row, slot_of_row] = rows
    mask[block_of_row, slot_of_row] = True
    return gather, mask, block_group, S
