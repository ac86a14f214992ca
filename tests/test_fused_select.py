"""Fused multi-query select parity (engine/batch.py).

A select() holding several fit expressions compiles them into ONE device
program; results must match the eager per-expression path exactly. The
reference has no analog (each plugin expression is its own pyO3 call); the
fused program pays one dispatch for all its queries, so parity here is what
licenses the benchmark's per-query numbers.
"""

import numpy as np
import pytest

import polars_ols_tpu as pot
from polars_ols_tpu import col
from polars_ols_tpu.config import CONFIG


@pytest.fixture
def df():
    rng = np.random.default_rng(7)
    n = 400
    x = rng.normal(size=(n, 5))
    data = {f"x{i+1}": x[:, i] for i in range(5)}
    data["y"] = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    data["y2"] = x @ rng.normal(size=5) + rng.normal(size=n, scale=0.1)
    data["w"] = rng.random(n) + 0.1
    data["g"] = rng.integers(0, 8, size=n).astype(float)
    return pot.DataFrame(data)


def _compare(df, *exprs, atol=1e-12):
    """Evaluate the same select fused and eager; require identical frames."""
    assert CONFIG.fused_select
    fused = df.select(*exprs)
    CONFIG.fused_select = False
    try:
        eager = df.select(*exprs)
    finally:
        CONFIG.fused_select = True
    assert fused.columns == eager.columns
    for name in fused.columns:
        a, b = fused[name], eager[name]
        if hasattr(a, "field_names"):  # struct columns
            av = np.asarray(a.values, dtype=float)
            bv = np.asarray(b.values, dtype=float)
        else:
            av, bv = a.to_numpy(), b.to_numpy()
        assert np.allclose(av, bv, atol=atol, equal_nan=True), name
    return fused


def test_fused_two_plain_fits(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    out = _compare(
        df,
        ls.ols(*feats).alias("a"),
        ls.ridge(*feats, alpha=0.3).alias("b"),
    )
    assert out.shape == (400, 2)


def test_fused_mixed_solvers(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    _compare(
        df,
        ls.ols(*feats, solve_method="qr").alias("qr"),
        ls.ols(*feats, solve_method="svd").alias("svd"),
        ls.ols(*feats, solve_method="lu").alias("lu"),
        ls.elastic_net(*feats, alpha=0.1, l1_ratio=0.5).alias("en"),
        atol=1e-10,
    )


def test_fused_wls_and_modes(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    out = _compare(
        df,
        ls.wls(*feats, sample_weights=col("w")).alias("wls"),
        ls.ols(*feats, mode="residuals").alias("res"),
        ls.ols(*feats, mode="coefficients"),
    )
    # residuals really are y - predictions
    preds = df.select(ls.ols(*feats)).to_numpy().ravel()
    res = out["res"].to_numpy()
    assert np.allclose(res, df["y"].to_numpy() - preds, atol=1e-12)


def test_fused_wls_residuals(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    _compare(
        df,
        ls.wls(*feats, sample_weights=col("w"), mode="residuals").alias("a"),
        ls.ridge(*feats, alpha=0.2, mode="residuals").alias("b"),
    )


def test_fused_grouped(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    out = _compare(
        df,
        ls.ols(*feats).over("g").alias("a"),
        ls.ridge(*feats, alpha=0.1).over("g").alias("b"),
        ls.ols(*feats, mode="coefficients").over("g"),
    )
    assert out.shape == (400, 3)


def test_fused_grouped_and_single_mixed(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(3)]
    _compare(
        df,
        ls.ols(*feats).over("g").alias("grouped"),
        ls.ols(*feats).alias("pooled"),
    )


def test_fused_distinct_targets(df):
    feats = [col(f"x{i+1}") for i in range(5)]
    _compare(
        df,
        col("y").least_squares.ols(*feats).alias("a"),
        col("y2").least_squares.ols(*feats).alias("b"),
    )


def test_fused_with_nonfusable_columns(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    out = _compare(
        df,
        col("g"),
        ls.ols(*feats).alias("a"),
        ls.rls(*feats, half_life=50.0).alias("rls"),  # moving: eager fallback
        ls.ridge(*feats, alpha=0.1).alias("b"),
    )
    assert out.columns == ["g", "a", "rls", "b"]


def test_fused_null_policies():
    rng = np.random.default_rng(3)
    n = 300
    x = rng.normal(size=(n, 2))
    y = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    y[::17] = np.nan
    df = pot.DataFrame({"x1": x[:, 0], "x2": x[:, 1], "y": y}).with_columns(
        col("y").fill_nan(None).alias("y")
    )
    ls = col("y").least_squares
    _compare(
        df,
        ls.ols(col("x1"), col("x2"), null_policy="zero").alias("z"),
        ls.ols(col("x1"), col("x2"), null_policy="drop").alias("d"),
    )


def test_fused_intercept(df):
    ls = col("y").least_squares
    _compare(
        df,
        ls.ols(col("x1"), col("x2"), add_intercept=True).alias("a"),
        ls.ridge(col("x1"), col("x2"), alpha=0.1, add_intercept=True).alias("b"),
    )


def test_fused_single_fit_falls_back(df):
    # one fusable expression -> no fusion; result identical regardless
    ls = col("y").least_squares
    out = df.select(col("g"), ls.ols(col("x1")).alias("a"))
    assert out.columns == ["g", "a"]


def test_fused_statistics(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    exprs = (
        ls.ols(*feats, mode="statistics").alias("s"),
        ls.ridge(*feats, alpha=0.1).alias("p"),
    )
    fused = df.select(*exprs)
    CONFIG.fused_select = False
    try:
        eager = df.select(*exprs)
    finally:
        CONFIG.fused_select = True
    for key in ("r2", "mae", "coefficients", "standard_errors", "p_values"):
        a = np.asarray(fused["s"].arrays[key])
        b = np.asarray(eager["s"].arrays[key])
        assert np.allclose(a, b, atol=1e-12, equal_nan=True), key
    assert np.allclose(fused["p"].to_numpy(), eager["p"].to_numpy(), atol=1e-12)


def test_fused_grouped_statistics(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(3)]
    exprs = (
        ls.ols(*feats, mode="statistics").over("g").alias("s"),
        ls.ols(*feats).over("g").alias("p"),
    )
    fused = df.select(*exprs)
    CONFIG.fused_select = False
    try:
        eager = df.select(*exprs)
    finally:
        CONFIG.fused_select = True
    for key in ("r2", "coefficients", "t_values"):
        a = np.asarray(fused["s"].arrays[key])
        b = np.asarray(eager["s"].arrays[key])
        assert np.allclose(a, b, atol=1e-12, equal_nan=True), key


def test_fused_moving(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(3)]
    _compare(
        df,
        ls.rls(*feats, half_life=30.0).alias("rls"),
        ls.rolling_ols(*feats, window_size=60).alias("roll"),
        ls.expanding_ols(*feats).alias("exp"),
        ls.ols(*feats).alias("static"),
    )


def test_fused_moving_grouped(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(2)]
    _compare(
        df,
        ls.rls(*feats, half_life=20.0).over("g").alias("rls"),
        ls.rolling_ols(*feats, window_size=30).over("g").alias("roll"),
    )


def test_fused_moving_wls(df):
    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(2)]
    _compare(
        df,
        ls.rls(*feats, half_life=20.0, sample_weights=col("w")).alias("a"),
        ls.rolling_ols(*feats, window_size=40, sample_weights=col("w")).alias("b"),
    )


def test_fused_program_reuse(df):
    # same select twice: second call reuses the cached outer program
    from polars_ols_tpu.engine import batch

    ls = col("y").least_squares
    feats = [col(f"x{i+1}") for i in range(5)]
    exprs = lambda: (ls.ols(*feats).alias("a"), ls.ridge(*feats, alpha=0.1).alias("b"))
    df.select(*exprs())
    n_before = len(batch._RUNNERS)
    out1 = df.select(*exprs())
    assert len(batch._RUNNERS) == n_before
    out2 = df.select(*exprs())
    assert np.allclose(out1.to_numpy(), out2.to_numpy(), atol=0)
