"""Model-family benchmark suite mirroring the reference's tests/benchmark.py.

Times fit + predict for every model family at the reference's two README
configurations (2,000 x 5 and 10,000 x 100; reference README.md:204-236)
plus the grouped configurations the engine is built for.
Reference wall times are the published Apple M2 Max numbers (BASELINE.md).

Run: python benchmarks/suite.py [--config small|large|grouped|all]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import polars_ols_tpu as pls  # noqa: E402
from polars_ols_tpu import col
from polars_ols_tpu.series import StatisticsSeries  # noqa: E402


# published reference wall times in ms (BASELINE.md; Apple M2 Max)
REFERENCE_MS = {
    "small": {
        "ols_qr": 0.195, "ols_svd": 0.247, "ridge_chol": 0.171,
        "ridge_svd": 0.238, "wls": 0.334, "elastic_net": 0.227,
        "rls": 1.12, "rolling": 1.99,
    },
    "large": {
        "ols_qr": 17.6, "ols_svd": 23.8, "ridge_chol": 5.36,
        "ridge_svd": 30.2, "wls": 18.8, "elastic_net": 22.7,
        "rls": 270.0, "rolling": 371.0,
    },
}


def dispatch_floor(reps: int = 9) -> float:
    """The cost of ONE trivial program (dispatch + block_until_ready), in ms:
    the part of every eager query that the fused multi-query select
    (engine/batch.py) pays once instead of once per query."""
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros(8)
    f(x).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.min(times) * 1e3)


def _make_df(n: int, k: int, n_groups=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    y = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    data = {"y": y, **{f"x{i+1}": x[:, i] for i in range(k)}}
    data["y2"] = x @ rng.normal(size=k) + rng.normal(size=n, scale=0.1)
    data["w"] = rng.random(n) + 0.1
    if n_groups:
        data["g"] = rng.integers(n_groups, size=n).astype(float)
    return pls.DataFrame(data)


def _sync(out):
    """Block until a query's device work is done. The statistics row waits
    on the per-group fields and leaves the per-row broadcast deferred, as
    the reference's lazy collect would; `statistics_mat` returns the
    materialized field arrays.

    NB: the type check must NOT be an instance-level ``hasattr(out,
    "arrays")`` — ``arrays`` is a property, and hasattr would EXECUTE it,
    materialising the full [N]-row broadcast of every field per rep."""
    if isinstance(out, dict):  # statistics_mat: materialized field arrays
        jax.block_until_ready(out)
    elif isinstance(out, StatisticsSeries):
        jax.block_until_ready(out._base)
    else:
        jax.block_until_ready(out.values)


def _time(fn, reps=7):
    """Returns (min_s, median_s, iqr_s) of `reps` runs after one warm-up
    call that compiles."""
    fn()  # compile + warm caches
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(out)
        times.append(time.perf_counter() - t0)
    arr = np.sort(np.asarray(times))
    q1, q3 = np.percentile(arr, [25, 75])
    return float(arr[0]), float(np.median(arr)), float(q3 - q1)


def _queries(df, k: int, grouped: bool):
    feats = [col(f"x{i+1}") for i in range(k)]
    ls = col("y").least_squares

    def over(e):
        return e.over("g") if grouped else e

    out = {
        "ols_qr": lambda: df.select(over(ls.ols(*feats, solve_method=None if grouped else "qr")))["y"],
        "ols_svd": lambda: df.select(over(ls.ols(*feats, solve_method="svd")))["y"],
        "ridge_chol": lambda: df.select(over(ls.ridge(*feats, alpha=0.1)))["y"],
        "ridge_svd": lambda: df.select(over(ls.ridge(*feats, alpha=0.1, solve_method="svd")))["y"],
        "wls": lambda: df.select(over(ls.wls(*feats, sample_weights=col("w"))))["y"],
        "elastic_net": lambda: df.select(
            over(ls.elastic_net(*feats, alpha=0.1, l1_ratio=0.5, max_iter=200))
        )["y"],
        "rls": lambda: df.select(over(ls.rls(*feats, half_life=252.0)))["y"],
        "rolling": lambda: df.select(over(ls.rolling_ols(*feats, window_size=252)))["y"],
    }
    if grouped:
        out["ols_qr_explicit"] = lambda: df.select(
            over(ls.ols(*feats, solve_method="qr"))
        )["y"]
        out["statistics"] = lambda: df.select(
            over(ls.ols(*feats, mode="statistics")).alias("s")
        )["s"]
        # same query, but force the full [N]-row broadcast of every field
        # (the conservative materialized reading; `statistics` above defers
        # the row view like the reference's lazy collect would)
        out["statistics_mat"] = lambda: df.select(
            over(ls.ols(*feats, mode="statistics")).alias("s")
        )["s"].arrays
        out["multi_target"] = lambda: df.select(
            over(
                pls.struct(col("y"), col("y2"))
                .least_squares.multi_target_ols(*feats)
            ).alias("m")
        )["m"]
    return out


def run_config(name: str, n: int, k: int, n_groups=None, models=None):
    grouped = n_groups is not None
    df = _make_df(n, k, n_groups)
    ref = REFERENCE_MS.get(name, {})
    print(f"\n## config '{name}': n={n:,} k={k}"
          + (f" groups={n_groups:,}" if grouped else ""))
    print(f"{'model':<14} {'min':>10} {'median':>10} {'IQR':>8} "
          f"{'reference':>10} {'speedup':>9}")
    queries = _queries(df, k, grouped)
    if models is not None:
        queries = {m: queries[m] for m in models if m in queries}
    for model, fn in queries.items():
        try:
            pls.clear_caches()  # release device caches between families
            mn, med, iqr = (v * 1e3 for v in _time(fn))
        except Exception as e:  # pragma: no cover
            print(f"{model:<14} FAILED: {str(e)[:2000]}")
            continue
        r = ref.get(model)
        rtxt = f"{r:8.3f}ms" if r else " " * 10
        stxt = f"{r / mn:8.1f}x" if r else ""
        print(f"{model:<14} {mn:8.3f}ms {med:8.3f}ms {iqr:6.1f}ms {rtxt} {stxt}")


def run_batch_config(n: int, k: int, batch_sizes=(4, 8), models=None):
    """Amortized multi-query cost: M independent fits (distinct targets on a
    shared design — a cross-sectional screening workload) in ONE select
    compile into ONE device program (engine/batch.py). Reported per-query
    cost is what a reference user doing M queries would compare against its
    per-call wall time (17.6 ms for ols_qr at 10k x 100, README.md:229)."""
    rng = np.random.default_rng(0)
    m_max = max(batch_sizes)
    x = rng.normal(size=(n, k))
    data = {f"x{i+1}": x[:, i] for i in range(k)}
    for j in range(m_max):
        data[f"y{j}"] = x @ rng.normal(size=k) + rng.normal(size=n, scale=0.1)
    df = pls.DataFrame(data)
    feats = [col(f"x{i+1}") for i in range(k)]
    floor = dispatch_floor()
    print(f"\n## config 'batch': n={n:,} k={k} (fused multi-query select)")
    print(f"dispatch floor (1 trivial program round trip): {floor:.2f} ms")
    print(f"{'queries':<22} {'total min':>10} {'per-query':>10} {'reference':>10} {'speedup':>9}")
    ref = REFERENCE_MS["large"]["ols_qr"] if (n, k) == (10_000, 100) else None
    for m in batch_sizes:
        if models is not None and f"batch{m}" not in models:
            continue
        def fn(m=m):
            return df.select(
                *[
                    col(f"y{j}").least_squares.ols(
                        *feats, solve_method="qr"
                    ).alias(f"p{j}")
                    for j in range(m)
                ]
            )[f"p{m-1}"]

        mn, med, iqr = (v * 1e3 for v in _time(fn))
        per = mn / m
        rtxt = f"{ref:8.3f}ms" if ref else " " * 10
        stxt = f"{ref / per:8.1f}x" if ref else ""
        print(f"{m:>2} x ols_qr fused     {mn:8.3f}ms {per:8.3f}ms {rtxt} {stxt}")
    if models is not None and "sweep" not in models:
        return
    # hyperparameter sweep: same target, 8 ridge alphas in one program
    def sweep():
        return df.select(
            *[
                col("y0").least_squares.ridge(*feats, alpha=a).alias(f"r{i}")
                for i, a in enumerate((0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0))
            ]
        )["r7"]

    mn, med, iqr = (v * 1e3 for v in _time(sweep))
    rref = REFERENCE_MS["large"]["ridge_chol"] if (n, k) == (10_000, 100) else None
    rtxt = f"{rref:8.3f}ms" if rref else " " * 10
    stxt = f"{rref / (mn / 8):8.1f}x" if rref else ""
    print(f" 8 x ridge alpha sweep {mn:8.3f}ms {mn/8:8.3f}ms {rtxt} {stxt}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="all",
                    choices=["small", "large", "grouped", "grouped_largek",
                             "batch", "all"])
    ap.add_argument("--models", default=None,
                    help="comma-separated subset of model rows to run "
                    "(e.g. 'statistics,multi_target')")
    ap.add_argument("--count-compiles", action="store_true",
                    help="report the number of distinct XLA backend compiles "
                    "the suite triggers (the shape-bucketing cold-start "
                    "metric: one compiled program should serve a family of "
                    "query sizes)")
    args = ap.parse_args()
    compiles = []
    if args.count_compiles:
        import jax.monitoring

        jax.monitoring.register_event_duration_secs_listener(
            lambda key, dur, **kw: compiles.append(dur)
            if key == "/jax/core/compile/backend_compile_duration"
            else None
        )
    subset = args.models.split(",") if args.models else None

    def pick(models):
        if subset is None:
            return models
        return [m for m in subset if models is None or m in models] or None

    if args.config in ("small", "all"):
        run_config("small", 2_000, 5, models=subset)
    if args.config in ("large", "all"):
        run_config("large", 10_000, 100, models=subset)
    if args.config in ("grouped", "all"):
        run_config("grouped", 2_000_000, 5, n_groups=10_000, models=subset)
    if args.config in ("batch", "all"):
        run_batch_config(10_000, 100, models=subset)
    if args.config in ("grouped_largek", "all"):
        # grouped moving models beyond the lane-chol tier (K > 32): the
        # refined-SM group-block path (the reference covers this regime
        # with its per-group Woodbury loop, src/least_squares.rs:848-1032)
        largek = pick(["rls", "rolling"])
        if largek:
            run_config(
                "grouped_largek", 500_000, 40, n_groups=1_000, models=largek,
            )
    if compiles:
        print(f"\nXLA backend compiles: {len(compiles)} programs, "
              f"{sum(compiles):.1f} s total compile time")


if __name__ == "__main__":
    main()
