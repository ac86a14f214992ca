"""Multi-device scaling-efficiency harness (BASELINE gate: >=80% 1->N).

Measures the distributed grouped-OLS fit (parallel.fit_moments_sharded —
partial-moment psum_scatter merges) and the group-sharded moving models at
mesh sizes 1/2/4/..., printing rows/s and parallel efficiency vs the
1-device run. Mirrors the role of the reference's tests/benchmark.py
(pyperf harness) for the dimension the reference does not have: scale-out.

On a CPU host run with:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python benchmarks/scaling.py
(on a host with several GPUs, no flags are needed).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from polars_ols_tpu.parallel import (  # noqa: E402
    fit_moments_sharded,
    make_mesh,
)
from polars_ols_tpu.parallel.sharded import (  # noqa: E402
    mesh_row_axes,
    shard_group_axis,
)
from polars_ols_tpu.ops.moving import solve_rolling_lanes  # noqa: E402
from functools import partial  # noqa: E402


from polars_ols_tpu.parallel.introspect import collective_bytes  # noqa: E402


def _sync(x):
    return jax.block_until_ready(x)


def _time(fn, reps=3):
    _sync(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    n_dev = jax.device_count()
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    rng = np.random.default_rng(0)

    # --- distributed static fit: 2M rows x 5 features x 10k groups ---
    N, K, G = 500_000, 5, 4_000
    X = jnp.asarray(rng.normal(size=(N, K)))
    y = jnp.asarray(X.sum(axis=1) + 0.1 * rng.normal(size=N))
    w = jnp.ones(N, dtype=bool)
    gids = jnp.asarray(rng.integers(G, size=N), dtype=jnp.int32)

    print(f"# static grouped OLS: {N:,} rows x {K} feats x {G:,} groups")
    print(f"{'devices':>8} {'ms':>10} {'rows/s':>14} {'efficiency':>11} {'comm':>10}")
    base = None
    for s in sizes:
        mesh = make_mesh(s)
        # compile ONCE; the same executable serves the timing loop and the
        # collective-bytes readout
        compiled = (
            jax.jit(
                lambda X_, y_, w_, g_: fit_moments_sharded(
                    mesh, X_, y_, w_, g_, G  # noqa: B023 - rebound per size
                )[1]
            )
            .lower(X, y, w, gids)
            .compile()
        )
        comm = collective_bytes(compiled.as_text())
        dt = _time(lambda: compiled(X, y, w, gids))
        rps = N / dt
        base = base or rps
        eff = rps / (base * s)
        print(
            f"{s:>8} {dt*1e3:>9.1f} {rps:>14,.0f} {eff:>10.1%} "
            f"{comm / 1e6:>8.2f}MB"
        )
    row_mb = N * (K + 1) * 8 / 1e6
    print(f"(row data read per query: ~{row_mb:.0f} MB; collective bytes above "
          f"are the total cross-device traffic per executed program)")

    # --- group-sharded moving model: rolling OLS over the group batch ---
    Gm, R, Km = 1_024, 128, 4
    Xm = jnp.asarray(rng.normal(size=(Gm, R, Km)))
    ym = jnp.asarray(np.einsum("grk->gr", np.asarray(Xm)) + 0.1 * rng.normal(size=(Gm, R)))
    vm = jnp.ones((Gm, R), dtype=bool)

    print(f"\n# rolling OLS (lane kernels): {Gm:,} groups x {R} rows x {Km} feats")
    print(f"{'devices':>8} {'ms':>10} {'rows/s':>14} {'efficiency':>11} {'comm':>10}")
    base = None
    for s in sizes:
        mesh = make_mesh(s)
        # whole-group solvers shard the batch axis with ZERO collectives —
        # measure it rather than assert it; one compile serves timing + HLO
        placed, _ = shard_group_axis(mesh, (Xm, ym, vm))
        compiled = (
            jax.jit(
                partial(
                    solve_rolling_lanes,
                    window=60, min_periods=4, alpha=0.0, positional=True,
                ),
                out_shardings=NamedSharding(
                    mesh, PartitionSpec(mesh_row_axes(mesh))
                ),
            )
            .lower(*placed)
            .compile()
        )
        comm = collective_bytes(compiled.as_text())
        dt = _time(lambda: compiled(*placed), reps=3)
        rps = Gm * R / dt
        base = base or rps
        eff = rps / (base * s)
        print(f"{s:>8} {dt*1e3:>9.1f} {rps:>14,.0f} {eff:>10.1%} "
              f"{comm / 1e6:>8.2f}MB")


if __name__ == "__main__":
    main()
