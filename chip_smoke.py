"""Smoke check of the engine on an NVIDIA GPU, through the public API.

Run from the root of a checkout:

    python chip_smoke.py               # phases 0-3 on one card
    python chip_smoke.py --devices 4   # only the four-card phase

Phases (one process; phase 1 runs in a child before this process imports
JAX, so that one JAX process holds the card at a time):

0. the card: nvidia-smi name and power limit, JAX devices (platform must be
   ``gpu``, there is no CPU fallback), the native layout library, the
   effective CONFIG defaults and the compile-cache directory;
1. the ``gpu``-marked tests (``pytest -m gpu``) in a child process;
2. the headline grouped OLS (8,000,000 rows x 5 features x 10,000 uniform
   groups, BASELINE.json's north star) with the row order materialized and
   lazy, against a numpy f64 oracle;
3. the other model families at the reference's published widths
   (10,000 x 100 single frame; grouped 2,000,000 x 5 x 10,000 moving
   models; grouped 500,000 x 40 x 1,000 rolling), each against a numpy or
   scipy oracle.

``--devices 4`` runs the multi-card checks instead: the headline, a grouped
rolling fit and a heavy group that spans every shard, each with
``auto_shard`` on against one card with ``auto_shard`` off in the same
process and against the oracle.

Data comes from ``--seed``. Any failure raises and exits non-zero. The last
line of standard output is one JSON object, printed only when every phase
passed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HEADLINE = dict(n=8_000_000, k=5, groups=10_000)
WARM_REPS = 5


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no GPU")
    return "; ".join(lines)


def run_gpu_tests() -> None:
    """Phase 1: the gpu-marked tests, in a child process on the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    cmd = [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
           "-p", "no:xdist", "-p", "no:cacheprovider"]
    proc = subprocess.run(cmd, cwd=HERE, env=env, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 1: gpu tests failed (exit {proc.returncode})")


def require_gpu(count: int = 1):
    """The JAX devices, or an error unless they are `count` or more GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devs[0].platform!r}; this check has no "
            "CPU fallback"
        )
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    return devs


def describe_setup() -> None:
    """Phase 0 after JAX is up: library, native layout, CONFIG, cache."""
    import jax

    from polars_ols_tpu import CONFIG
    from polars_ols_tpu.engine import native

    devs = jax.devices()
    print(f"jax {jax.__version__}; device_kind {devs[0].device_kind!r}; "
          f"{len(devs)} device(s)")
    lib = native._load()
    print(f"native layout library loaded: {lib is not None}")
    if lib is None:
        raise RuntimeError(
            "native layout library did not load (make -C "
            "polars_ols_tpu/engine/native failed); host timings would be "
            "numpy's"
        )
    print("CONFIG: " + json.dumps({
        "use_ozaki": CONFIG.use_ozaki,
        "pair_gather": CONFIG.pair_gather,
        "moving_lanes": CONFIG.moving_lanes,
        "lazy_row_order": CONFIG.lazy_row_order,
        "row_epilogue": CONFIG.row_epilogue,
        "fused_select": CONFIG.fused_select,
        "auto_shard": CONFIG.auto_shard,
        "moment_chunk_rows": CONFIG.moment_chunk_rows,
    }))
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")


# --------------------------------------------------------------------------- #
# data, timing and oracles
# --------------------------------------------------------------------------- #
def make_frame(n: int, k: int, groups=None, seed: int = 0, weights=False):
    """The benchmark data (bench.py, benchmarks/suite.py): normal features,
    y = sum(x) + 0.1 noise, uniform integer group keys stored as floats."""
    import polars_ols_tpu as pls

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    y = X.sum(axis=1) + rng.normal(size=n) * 0.1
    data = {"y": y, **{f"x{i + 1}": X[:, i] for i in range(k)}}
    g = w = None
    if groups:
        g = rng.integers(groups, size=n)
        data["group"] = g.astype(float)
    if weights:
        w = rng.random(n) + 0.1
        data["w"] = w
    return pls.DataFrame(data), X, y, g, w


def block(result) -> None:
    """Wait for a query's device work. A lazy row-order column is waited on
    in its block layout, without materializing the permutation."""
    import jax

    from polars_ols_tpu.series import BlockPermuted, Series, StatisticsSeries

    if isinstance(result, StatisticsSeries):
        jax.block_until_ready(result._base)
    elif isinstance(result, Series):
        v = result._values
        jax.block_until_ready(v.flat if isinstance(v, BlockPermuted) else v)
    else:
        jax.block_until_ready(result.values)


def timed(run, reps: int = WARM_REPS):
    """(last result, first-call seconds, warm median seconds); every call
    ends in block_until_ready."""
    t0 = time.perf_counter()
    out = run()
    block(out)
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        block(out)
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm)


def time_query(name: str, run, card: str, reps: int = 3, rows=None):
    """Run a query with `timed`, print its times beside the card, and
    return its last result."""
    out, first, warm = timed(run, reps)
    rate = f", {rows / warm / 1e6:.1f}M rows/s" if rows else ""
    print(f"{name}: first call {first * 1e3:.1f} ms (compile included), warm "
          f"median {warm * 1e3:.3f} ms of {reps}{rate} [{card}]")
    return out


def grouped_ols_oracle(X, y, g, G):
    """Per-group normal equations in numpy f64 (bincount moments, batched
    solve) and the predictions they give at every row."""
    Z = np.column_stack([X, y])
    C = Z.shape[1]
    M = np.empty((G, C, C))
    for i in range(C):
        for j in range(i, C):
            M[:, i, j] = M[:, j, i] = np.bincount(
                g, weights=Z[:, i] * Z[:, j], minlength=G
            )
    K = C - 1
    beta = np.linalg.solve(M[:, :K, :K], M[:, :K, K:])[..., 0]
    return beta, np.einsum("nk,nk->n", X, beta[g])


def check(name: str, got, want, rtol: float, why: str, echo: bool = True):
    """max |got - want| <= rtol * max |want|, NaN where the oracle has NaN;
    returns the error."""
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != oracle {want.shape}")
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        raise AssertionError(f"{name}: NaN pattern differs from the oracle")
    scale = float(np.abs(want[~nan]).max()) if (~nan).any() else 1.0
    err = float(np.abs(got[~nan] - want[~nan]).max()) / max(scale, 1e-300)
    if echo:
        print(f"  {name}: max rel err {err:.3e} <= {rtol:.0e} ({why})")
    if not err <= rtol:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {rtol:.0e}")
    return err


def report(name: str, errs, rtol: float, why: str) -> None:
    print(f"  {name}: max rel err {max(errs):.3e} <= {rtol:.0e} over "
          f"{len(errs)} sampled groups ({why})")


def group_index(g):
    """(number of groups, rows of group i in row order as a function)."""
    G = int(g.max()) + 1
    order = np.argsort(g, kind="stable")
    starts = np.searchsorted(g[order], np.arange(G + 1))
    return G, lambda i: order[starts[i]:starts[i + 1]]


def sample_groups(G: int, n: int, seed: int):
    return np.random.default_rng(seed + 1).choice(G, size=min(n, G), replace=False)


# tolerances, with their reasons
TOL_NE = (1e-9, "f64 normal equations, well conditioned; atomic segment "
          "sums reorder the f64 additions from run to run")
TOL_QR = (1e-9, "QR-grade solve against LAPACK lstsq at cond(X) ~ 1")
TOL_SCAN = (1e-7, "exact-f64 lane scans over up to 10k rows accumulate "
            "rounding along the recursion")
TOL_SM = (1e-6, "refined Sherman-Morrison lanes: f32 preconditioner, two "
          "f64 refinement passes")


# --------------------------------------------------------------------------- #
# phase 2: the headline
# --------------------------------------------------------------------------- #
def headline(n: int, k: int, groups: int, seed: int, card: str) -> None:
    import polars_ols_tpu as pls
    from polars_ols_tpu import CONFIG, col

    df, X, y, g, _ = make_frame(n, k, groups, seed)
    G, rows_of = group_index(g)
    beta, pred_oracle = grouped_ols_oracle(X, y, g, G)
    expr = col("y").least_squares.ols(
        *[col(f"x{i + 1}") for i in range(k)]
    ).over("group")
    lazy0 = CONFIG.lazy_row_order
    try:
        for lazy in (False, True):
            CONFIG.lazy_row_order = lazy
            label = "lazy" if lazy else "materialized"
            preds = time_query(f"headline {label} {n}x{k}x{groups}",
                               lambda: df.select(expr)["y"], card,
                               reps=WARM_REPS, rows=n).to_numpy()
            check(f"headline {label} predictions vs normal equations",
                  preds, pred_oracle, *TOL_NE)
    finally:
        CONFIG.lazy_row_order = lazy0
    errs = []
    for gi in sample_groups(G, 20, seed):
        rows = rows_of(gi)
        b = np.linalg.lstsq(X[rows], y[rows], rcond=None)[0]
        if not np.allclose(beta[gi], b, rtol=1e-9, atol=1e-12):
            raise AssertionError(f"oracle self-check: group {gi} normal "
                                 "equations disagree with lstsq")
        errs.append(check(f"headline group {gi} vs lstsq", preds[rows],
                          X[rows] @ b, *TOL_QR, echo=False))
    report("headline vs lstsq", errs, *TOL_QR)
    pls.clear_caches()


# --------------------------------------------------------------------------- #
# phase 3: the other families
# --------------------------------------------------------------------------- #
def rls_oracle(X, y, half_life, cov0=10.0):
    """The reference's sequential Kalman-style recursion
    (src/least_squares.rs:494-598); returns per-row predictions."""
    n, K = X.shape
    ff = np.exp(np.log(0.5) / half_life) if half_life else 1.0
    P = np.eye(K) * cov0
    coef = np.zeros(K)
    out = np.empty(n)
    for t in range(n):
        x = X[t]
        Px = P @ x
        r = 1.0 + x @ Px / ff
        kal = Px / (r * ff)
        coef = coef + kal * (y[t] - x @ coef)
        P = P / ff - np.outer(kal, kal) * r
        out[t] = x @ coef
    return out


def rolling_oracle(X, y, window, rows=None):
    """Per-row solve over the last `window` rows, NaN before K rows (the
    default min_periods); returns per-row predictions. `rows` limits the
    rows solved (the others stay NaN)."""
    n, K = X.shape
    out = np.full(n, np.nan)
    for t in range(K - 1, n) if rows is None else rows:
        Xw, yw = X[max(0, t + 1 - window):t + 1], y[max(0, t + 1 - window):t + 1]
        out[t] = X[t] @ np.linalg.solve(Xw.T @ Xw, Xw.T @ yw)
    return out


def check_moving(name, model, got, X, y, tol) -> float:
    """One group's moving-model predictions against the numpy recursion;
    returns the error. Rolling rows before min_periods must be null; rows
    whose window holds fewer than 2K rows are left out of the numeric
    check, because the engine's diffuse prior (1e-10 of the data scale)
    moves a nearly square system by more than the tolerance."""
    K = X.shape[1]
    if model == "rls":
        return check(name, got, rls_oracle(X, y, 252.0), *tol, echo=False)
    want = rolling_oracle(X, y, 252)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{name}: null rows differ from min_periods = K")
    return check(name, got[2 * K - 1:], want[2 * K - 1:], *tol, echo=False)


def enet_kkt(X, y, w, alpha, l1_ratio):
    """Largest violation of the elastic-net optimality conditions of the
    reference's objective (src/least_squares.rs:386-492, a = alpha * n),
    relative to the l1 weight a * l1_ratio."""
    a = alpha * X.shape[0]
    grad = X.T @ (y - X @ w) - a * (1.0 - l1_ratio) * w
    on = w != 0
    viol = np.where(on, np.abs(grad - a * l1_ratio * np.sign(w)),
                    np.maximum(np.abs(grad) - a * l1_ratio, 0.0))
    return float(viol.max() / (a * l1_ratio))


def moving_sizes(G: int, R: int, K: int, half_life=None, rolling=False) -> dict:
    """The chunk and group-block sizes the moving kernels pick at a shape."""
    import math

    from polars_ols_tpu.engine.fit import _moving_group_block, _pick_chunk
    from polars_ols_tpu.ops import moving as mv

    lane_chol = mv._use_lane_chol(K, G)
    ln_inv_ff = math.log(2.0) / half_life if half_life else 0.0
    sm = mv._sm_chunk(R, ln_inv_ff, K)
    return {
        "G": G, "R": R, "K": K,
        "lane_tier": "lane-chol" if lane_chol else "refined-SM",
        "lane_chunk": mv._chol_chunk(K, G) if lane_chol
        else (min(sm, 256) if rolling else sm),
        "lane_group_block": mv.lanes_group_block(G, R, K, half_life, rolling),
        "classic_chunk": _pick_chunk(G, K),
        "classic_group_block": _moving_group_block(G, K),
    }


def single_frame(n: int, k: int, seed: int, card: str, rolling_rows: int = 40):
    import polars_ols_tpu as pls
    from polars_ols_tpu import col

    df, X, y, _, w = make_frame(n, k, None, seed, weights=True)
    feats = [col(f"x{i + 1}") for i in range(k)]
    ls = col("y").least_squares
    b_ols = np.linalg.lstsq(X, y, rcond=None)[0]
    a = 0.1
    aug_X = np.vstack([X, np.sqrt(a) * np.eye(k)])
    b_ridge = np.linalg.lstsq(aug_X, np.concatenate([y, np.zeros(k)]), rcond=None)[0]
    sw = np.sqrt(w)
    b_wls = np.linalg.lstsq(X * sw[:, None], y * sw, rcond=None)[0]

    def query(name, expr, key="y"):
        return time_query(f"{name} {n}x{k}", lambda: df.select(expr)[key], card)

    def run(name, expr, want, tol):
        check(name, query(name, expr).to_numpy(), want, *tol)

    for method in ("qr", "svd", "lu"):
        run(f"ols_{method}", ls.ols(*feats, solve_method=method), X @ b_ols, TOL_QR)
    run("ridge_chol", ls.ridge(*feats, alpha=a), X @ b_ridge, TOL_QR)
    run("ridge_svd", ls.ridge(*feats, alpha=a, solve_method="svd"), X @ b_ridge, TOL_QR)
    run("wls", ls.wls(*feats, sample_weights=col("w")), X @ b_wls, TOL_QR)

    enet = ls.elastic_net(*feats, alpha=0.1, l1_ratio=0.5, max_iter=200,
                          mode="coefficients")
    coef = np.asarray(query("elastic_net", enet, "coefficients").values,
                      dtype=float).reshape(-1, k)[0]
    kkt = enet_kkt(X, y, coef, 0.1, 0.5)
    print(f"  elastic_net: KKT violation {kkt:.3e} <= 1e-4 (of the l1 "
          "weight; the solver stops, like the reference's, at tol=1e-5 on "
          "the coefficient step)")
    if not kkt <= 1e-4:
        raise AssertionError(f"elastic_net KKT violation {kkt:.3e}")

    for model, half_life in (("rls", 252.0), ("rolling", None)):
        print(f"moving sizes single-frame {model}: " + json.dumps(
            moving_sizes(1, n, k, half_life, rolling=model == "rolling")))
    run("rls", ls.rls(*feats, half_life=252.0), rls_oracle(X, y, 252.0), TOL_SM)
    rows = np.sort(np.random.default_rng(seed).choice(
        np.arange(2 * k - 1, n), size=min(rolling_rows, n - 2 * k + 1),
        replace=False))
    got = query("rolling_ols", ls.rolling_ols(*feats, window_size=252)).to_numpy()
    if not (np.isnan(got[: k - 1]).all() and not np.isnan(got[k - 1:]).any()):
        raise AssertionError("rolling_ols: null rows differ from min_periods = K")
    check("rolling_ols (sampled rows)", got[rows],
          rolling_oracle(X, y, 252, rows)[rows], *TOL_SM)

    stats = query("statistics", ls.ols(*feats, mode="statistics").alias("s"), "s")
    f = {key: np.asarray(v, dtype=float) for key, v in stats.arrays.items()}
    resid = y - X @ b_ols
    rss = float(resid @ resid)
    se = np.sqrt(rss / (n - k) * np.diag(np.linalg.inv(X.T @ X)))
    r2 = 1.0 - rss / float(((y - y.mean()) ** 2).sum())
    check("statistics coefficients", f["coefficients"].reshape(-1)[:k], b_ols, *TOL_QR)
    check("statistics standard_errors", f["standard_errors"].reshape(-1)[:k], se, *TOL_QR)
    check("statistics r2", f["r2"].reshape(-1)[:1], [r2], *TOL_QR)
    pls.clear_caches()


def grouped_moving(n: int, k: int, groups: int, seed: int, card: str,
                   models=("rls", "rolling"), n_sample: int = 10) -> None:
    import polars_ols_tpu as pls
    from polars_ols_tpu import col

    df, X, y, g, _ = make_frame(n, k, groups, seed)
    G, rows_of = group_index(g)
    R = max(len(rows_of(i)) for i in range(G))
    feats = [col(f"x{i + 1}") for i in range(k)]
    ls = col("y").least_squares
    tol = TOL_SCAN if k <= 16 else TOL_SM
    for model in models:
        half_life = 252.0 if model == "rls" else None
        print(f"moving sizes {model}: " + json.dumps(
            moving_sizes(G, R, k, half_life, rolling=model == "rolling")))
        expr = (ls.rls(*feats, half_life=252.0) if model == "rls"
                else ls.rolling_ols(*feats, window_size=252)).over("group")
        got = time_query(f"grouped {model} {n}x{k}x{groups}",
                         lambda: df.select(expr)["y"], card).to_numpy()
        report(f"grouped {model}", [
            check_moving(f"grouped {model} group {gi}", model,
                         got[rows_of(gi)], X[rows_of(gi)], y[rows_of(gi)], tol)
            for gi in sample_groups(G, n_sample, seed)
        ], *tol)
    pls.clear_caches()


# --------------------------------------------------------------------------- #
# --devices 4
# --------------------------------------------------------------------------- #
def _shard_report(program: str) -> None:
    from polars_ols_tpu.parallel.introspect import (
        LAST_PROGRAMS,
        last_program_collective_bytes,
    )

    jitted, args, kwargs = LAST_PROGRAMS[program]
    compiled = jitted.lower(*args, **kwargs).compile()
    first_in = compiled.input_shardings[0][0]
    print(f"  {program}: collective bytes "
          f"{last_program_collective_bytes(program)}; first input sharding "
          f"{first_in} over {len(first_in.device_set)} device(s)")


def _sharded_vs_single(name, df, expr, card, program):
    """Run `expr` on one card (auto_shard off) and on every card (on);
    returns {sharded: host predictions}."""
    from polars_ols_tpu import CONFIG
    from polars_ols_tpu.series import BlockPermuted

    shard0 = CONFIG._auto_shard
    results = {}
    try:
        for shard in (False, True):
            CONFIG.auto_shard = shard
            label = "all cards, auto_shard" if shard else "1 card"
            out = time_query(f"{name} [{label}]", lambda: df.select(expr)["y"],
                             card, reps=WARM_REPS)
            if shard:
                v = out._values
                v = v.flat if isinstance(v, BlockPermuted) else v
                print("  output rows per device: " + ", ".join(
                    f"{s.device.id}:{s.data.shape[0]}"
                    for s in v.addressable_shards))
                _shard_report(program)
            results[shard] = out.to_numpy()
    finally:
        CONFIG._auto_shard = shard0
    return results


def multi_card(seed: int, card: str, scale: float = 1.0) -> None:
    """(a) the headline, rows sharded with psum_scatter moment merges;
    (b) grouped rolling, the group-sharded lane scan; (c) one heavy group
    with 70% of the rows, which spans every shard. `scale` shrinks the
    row and group counts (for a rehearsal on virtual CPU devices)."""
    import polars_ols_tpu as pls
    from polars_ols_tpu import col

    def size(v):
        return max(2, int(v * scale))

    k = HEADLINE["k"]
    feats = [col(f"x{i + 1}") for i in range(k)]
    ls = col("y").least_squares

    df, X, y, g, _ = make_frame(size(HEADLINE["n"]), k, size(HEADLINE["groups"]), seed)
    _, pred = grouped_ols_oracle(X, y, g, int(g.max()) + 1)
    res = _sharded_vs_single("(a) headline ols", df, ls.ols(*feats).over("group"),
                             card, "fit_moments")
    check("(a) all cards vs 1 card", res[True], res[False], *TOL_NE)
    for shard, got in res.items():
        check(f"(a) {'all cards' if shard else '1 card'} vs oracle", got, pred, *TOL_NE)
    pls.clear_caches()

    df, X, y, g, _ = make_frame(size(2_000_000), k, size(10_000), seed + 1)
    res = _sharded_vs_single(
        "(b) grouped rolling_ols", df,
        ls.rolling_ols(*feats, window_size=252).over("group"), card,
        "groups_sharded")
    check("(b) all cards vs 1 card", res[True], res[False], *TOL_SCAN)
    G, rows_of = group_index(g)
    for shard, got in res.items():
        report(f"(b) {'all cards' if shard else '1 card'} vs oracle", [
            check_moving(f"(b) group {gi}", "rolling", got[rows_of(gi)],
                         X[rows_of(gi)], y[rows_of(gi)], TOL_SCAN)
            for gi in sample_groups(G, 10, seed)
        ], *TOL_SCAN)
    pls.clear_caches()

    rng = np.random.default_rng(seed + 2)
    n = size(2_000_000)
    heavy = rng.random(n) < 0.7
    g = np.where(heavy, 0, rng.integers(1, size(1_000), size=n))
    X = rng.normal(size=(n, k))
    y = X.sum(axis=1) + rng.normal(size=n) * 0.1
    df = pls.DataFrame({"y": y, **{f"x{i + 1}": X[:, i] for i in range(k)},
                        "group": g.astype(float)})
    _, pred = grouped_ols_oracle(X, y, g, int(g.max()) + 1)
    b0 = np.linalg.lstsq(X[heavy], y[heavy], rcond=None)[0]
    check("(c) oracle self-check, heavy group vs lstsq",
          pred[heavy], X[heavy] @ b0, *TOL_QR)
    res = _sharded_vs_single("(c) heavy-group ols", df,
                             ls.ols(*feats).over("group"), card, "fit_moments")
    check("(c) all cards vs 1 card", res[True], res[False], *TOL_NE)
    for shard, got in res.items():
        check(f"(c) {'all cards' if shard else '1 card'} vs oracle", got, pred, *TOL_NE)
    pls.clear_caches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase")
    args = ap.parse_args(argv)

    card = card_line()
    print(f"card: {card}")
    if args.devices == 1:
        run_gpu_tests()
    devs = require_gpu(args.devices)
    describe_setup()
    if args.devices == 4:
        multi_card(args.seed, card)
    else:
        headline(HEADLINE["n"], HEADLINE["k"], HEADLINE["groups"], args.seed, card)
        single_frame(10_000, 100, args.seed, card)
        grouped_moving(2_000_000, 5, 10_000, args.seed, card)
        grouped_moving(500_000, 40, 1_000, args.seed, card, models=("rolling",))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
