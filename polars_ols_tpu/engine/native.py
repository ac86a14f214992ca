"""ctypes bindings to the native C++ runtime helpers (engine/native/).

The reference keeps its hot host-side machinery (group hashing, series ->
ndarray conversion) in native Rust inside polars itself; our equivalent is a
small C++ shared library providing O(N) open-addressing hash factorization
of group keys — the host-side step that precedes every grouped solve. The
device compute path itself is pure XLA and needs no native code.

The library is built at first use (``make -C polars_ols_tpu/engine/native``,
with ``-march=native`` for the machine that runs it). When it cannot be
built or loaded, the layouts fall back to numpy and a warning says why.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_LIB = None
_TRIED = False


def _make(native_dir, force=False) -> Optional[str]:
    """Build the shared library (g++ is part of the supported toolchain).
    Returns None on success, else what make (or starting it) reported."""
    import subprocess

    try:
        proc = subprocess.run(
            ["make", "-C", native_dir] + (["-B"] if force else []),
            capture_output=True,
            text=True,
            timeout=120,
            check=False,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    return None if proc.returncode == 0 else (proc.stderr or proc.stdout)[-2000:]


# any symbol introduced by the newest source revision: its absence from the
# shared object's bytes marks a stale build (checked BEFORE dlopen — glibc
# dedups dlopen of the same path in-process, so a stale handle can never be
# replaced by rebuilding afterwards)
_NEWEST_SYMBOL = b"pols_unpad_map"


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    native_dir = os.path.join(os.path.dirname(__file__), "native")
    path = os.path.join(native_dir, "libpols_native.so")
    # make's dependency rule rebuilds when the source is newer (no-op
    # otherwise) — covers the git-pull-over-stale-.so case
    err = _make(native_dir)
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                if _NEWEST_SYMBOL not in f.read():
                    err = _make(native_dir, force=True)
        except OSError:
            pass
    if not os.path.exists(path):
        logger.warning(
            "native layout library not built; host layouts use numpy: %s", err
        )
        return None
    def bind():
        lib = ctypes.CDLL(path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pols_factorize_i64.argtypes = [i64p, ctypes.c_int64, i64p]
        lib.pols_factorize_i64.restype = ctypes.c_int64
        lib.pols_layout_build.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
        ]
        lib.pols_layout_build.restype = ctypes.c_int64
        lib.pols_scatter_blocks.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pols_scatter_blocks.restype = None
        lib.pols_unpad_map.argtypes = [
            i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pols_unpad_map.restype = None
        return lib

    try:
        _LIB = bind()
    except (OSError, AttributeError) as e:
        # rebuilding here cannot help: dlopen of the same path returns the
        # already-loaded handle for the rest of the process (the staleness
        # pre-checks above run BEFORE the first dlopen for exactly this
        # reason), so fall back to numpy everywhere
        logger.warning(
            "native layout library failed to load; host layouts use numpy: %s", e
        )
        _LIB = None
    return _LIB


def native_factorize(
    keys: np.ndarray, sort_keys: Optional[np.ndarray] = None
) -> Optional[np.ndarray]:
    """Dense-factorize int64 keys into group ids in first-seen order.

    Returns None when the native library is unavailable (caller falls back
    to numpy). First-seen order is remapped to sorted-unique order to match
    numpy.unique semantics; ``sort_keys`` supplies the value used for that
    ordering when ``keys`` are raw bit patterns (e.g. of floats).
    """
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    out = np.empty(len(keys), dtype=np.int64)
    n_groups = lib.pols_factorize_i64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n_groups < 0:
        return None
    # remap first-seen ids -> ids sorted by key value (numpy.unique order)
    order_vals = keys if sort_keys is None else sort_keys
    first_pos = np.full(n_groups, len(keys), dtype=np.int64)
    np.minimum.at(first_pos, out, np.arange(len(keys), dtype=np.int64))
    remap = np.argsort(np.argsort(order_vals[first_pos]))
    return remap[out]


def native_layout_build(gids: np.ndarray, num_groups: int):
    """Counting-sort group layout: (counts, order, rank) in two linear
    passes (no argsort, no 8M-element fancy-index gathers). Returns None
    when the native library is unavailable or a gid is out of range
    (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    gids = np.ascontiguousarray(gids, dtype=np.int64)
    n = len(gids)
    counts = np.empty(num_groups, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    rank = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.pols_layout_build(
        gids.ctypes.data_as(i64p), n, num_groups,
        counts.ctypes.data_as(i64p), order.ctypes.data_as(i64p),
        rank.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    return counts, order, rank


def native_scatter_blocks(
    gids: np.ndarray, rank: np.ndarray, block_first: np.ndarray,
    r_cap: int, n_blocks: int,
):
    """One-pass scatter of rows into a blocked [S, r_cap] gather/mask pair
    (the padded and split-padded device layouts). Returns None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    gids = np.ascontiguousarray(gids, dtype=np.int64)
    rank = np.ascontiguousarray(rank, dtype=np.int64)
    block_first = np.ascontiguousarray(block_first, dtype=np.int64)
    gather = np.zeros((n_blocks, r_cap), dtype=np.int64)
    mask = np.zeros((n_blocks, r_cap), dtype=bool)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pols_scatter_blocks(
        gids.ctypes.data_as(i64p), rank.ctypes.data_as(i64p),
        block_first.ctypes.data_as(i64p), r_cap, len(gids),
        gather.ctypes.data_as(i64p),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return gather, mask


def native_unpad_map(
    gids: np.ndarray, rank: np.ndarray, block_first: np.ndarray, r_cap: int
):
    """Row-order gather map out of the blocked [S, r_cap] layout as int32,
    one pass (inverse of `native_scatter_blocks`). None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "pols_unpad_map"):
        return None
    gids = np.ascontiguousarray(gids, dtype=np.int64)
    rank = np.ascontiguousarray(rank, dtype=np.int64)
    block_first = np.ascontiguousarray(block_first, dtype=np.int64)
    out = np.empty(len(gids), dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pols_unpad_map(
        gids.ctypes.data_as(i64p), rank.ctypes.data_as(i64p),
        block_first.ctypes.data_as(i64p), r_cap, len(gids),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
