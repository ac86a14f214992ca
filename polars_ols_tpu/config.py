"""Global configuration for the least-squares engine.

The reference implementation (azmyrajab/polars_ols) computes everything in
f64 on the host CPU (src/expressions.rs:22-63 casts every series to Float64).
Both backends this engine runs on, the CPU and an NVIDIA GPU, have f64
arithmetic units, so solver math defaults to f64 (parity with
numpy.linalg.lstsq) with f32 as an opt-in for throughput-bound paths.

Importing the package also points JAX's persistent compilation cache at a
fixed directory, unless ``JAX_COMPILATION_CACHE_DIR`` already names one.
"""

from __future__ import annotations

import os

# x64 must be enabled before any jax array is created.
import jax

jax.config.update("jax_enable_x64", True)

# JAX reads JAX_COMPILATION_CACHE_DIR itself. Otherwise the cache sits at a
# fixed path beside the package, so that every process of this checkout
# finds the programs an earlier one compiled.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
        ),
    )

import jax.numpy as jnp  # noqa: E402

# Defaults of the backend-specific paths below, by JAX backend. Each GPU
# value was chosen by an A/B on one H100 (PERF.md, Findings): the int8 digit
# moments and the lane-major moving kernels were faster there; the f32 pair
# gather was no faster and read f32-level error there (as if XLA's GPU
# compiler folded its hi/lo split). A backend not listed (the CPU) takes
# the plain path.
BACKEND_DEFAULTS = {
    "gpu": {"use_ozaki": True, "pair_gather": False, "moving_lanes": True},
}


class Config:
    """Runtime configuration knobs.

    Attributes:
        solve_dtype: dtype used for moment accumulation and factorizations.
        moment_chunk_rows: row-block size used by streaming/rolling moment
            kernels (bounds peak memory at chunk_rows * K^2 * 8 bytes).
        dense_group_pad_waste: maximum tolerated padding blow-up before the
            grouped engine switches from the padded batched-matmul layout to
            the chunked segment-sum layout.
    """

    def __init__(self) -> None:
        self.solve_dtype = jnp.float64
        self.moment_chunk_rows = int(os.environ.get("POLS_TPU_CHUNK_ROWS", 512))
        self.dense_group_pad_waste = float(
            os.environ.get("POLS_TPU_PAD_WASTE", 4.0)
        )
        # overrides for the lazy backend-dependent defaults below
        self._use_ozaki = _env_flag("POLS_TPU_OZAKI")
        self._pair_gather = _env_flag("POLS_TPU_PAIR_GATHER")
        self._moving_lanes = _env_flag("POLS_TPU_MOVING_LANES")
        # defer the row-order unpad permutation of grouped predictions: the
        # output Series carries (block values, index map) and materialises
        # row order on first full-column access (an [N] gather that
        # reductions/slices never need)
        self.lazy_row_order = bool(int(os.environ.get("POLS_TPU_LAZY", "1")))
        # materialized grouped predictions: compute row-order output
        # directly from the cached [N, 1+K] row stack (K tiny-table beta
        # gathers + K fmas, exact f64) instead of permuting the block-layout
        # output with an [N] gather. Off until measured faster on the card.
        self.row_epilogue = bool(int(os.environ.get("POLS_TPU_ROW_EPILOGUE", "0")))
        # fuse a multi-expression select()'s independent fit queries into
        # ONE device program (engine/batch.py): one dispatch instead of M,
        # and XLA shares the subcomputations the queries have in common
        self.fused_select = bool(int(os.environ.get("POLS_TPU_FUSED_SELECT", "1")))
        # route grouped fits through the mesh-sharded engine
        # (parallel/sharded.py): rows stay in place, partial moments
        # psum_scatter-merge across shards; moving models shard the group
        # batch axis. Defaults ON when >1 device is visible.
        self._auto_shard = _env_flag("POLS_TPU_AUTO_SHARD")

    def _backend_default(self, name: str) -> bool:
        return BACKEND_DEFAULTS.get(jax.default_backend(), {}).get(name, False)

    @property
    def use_ozaki(self) -> bool:
        """int8 digit-matmul moments (ops/ozaki.py), exact to ~2^-58, in
        place of the f64 moment einsum. Default from BACKEND_DEFAULTS.
        Override with POLS_TPU_OZAKI=0/1 or CONFIG.use_ozaki = True."""
        if self._use_ozaki is None:
            self._use_ozaki = self._backend_default("use_ozaki")
        return self._use_ozaki

    @use_ozaki.setter
    def use_ozaki(self, v) -> None:
        self._use_ozaki = bool(v)

    @property
    def pair_gather(self) -> bool:
        """Gather f64 row data as f32 (hi, lo) pairs: same bytes, exact to
        2^-48 where the compiler keeps the split (the CPU; on the GPU it
        read f32-level error). Output-only path.
        Default from BACKEND_DEFAULTS. Override with
        POLS_TPU_PAIR_GATHER=0/1."""
        if self._pair_gather is None:
            self._pair_gather = self._backend_default("pair_gather")
        return self._pair_gather

    @pair_gather.setter
    def pair_gather(self, v) -> None:
        self._pair_gather = bool(v)

    @property
    def moving_lanes(self) -> bool:
        """Lane-major moving-window kernels (ops/moving.py): the group/chunk
        batch axis is laid out minor-most, so every elementwise step of the
        scan body runs over all groups at once. Default from
        BACKEND_DEFAULTS. Override with POLS_TPU_MOVING_LANES=0/1."""
        if self._moving_lanes is None:
            self._moving_lanes = self._backend_default("moving_lanes")
        return self._moving_lanes

    @moving_lanes.setter
    def moving_lanes(self, v) -> None:
        self._moving_lanes = bool(v)

    @property
    def auto_shard(self) -> bool:
        """Distribute grouped queries across all visible devices. On by
        default with >1 accelerator device; off on CPU meshes (every query
        shape would pay an 8-way SPMD recompile — the sharded paths are
        exercised there explicitly by tests/test_autoshard.py). Override
        with POLS_TPU_AUTO_SHARD=0/1."""
        if self._auto_shard is None:
            self._auto_shard = (
                jax.device_count() > 1 and jax.default_backend() != "cpu"
            )
        return self._auto_shard

    @auto_shard.setter
    def auto_shard(self, v) -> None:
        self._auto_shard = bool(v)


def _env_flag(name: str):
    env = os.environ.get(name)
    return None if env is None else bool(int(env))


CONFIG = Config()

# Default epsilon used when filling null sample weights, mirroring the
# reference's `_EPSILON` (polars_ols/least_squares.py:63).
EPSILON: float = 1.0e-12
