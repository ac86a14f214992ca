"""Round-3 engine-side pre-processing and device-native statistics tests.

Covers: zero mid-query host fetches for weighted/intercept queries (the
expression layer must not hide device syncs), CD/weighted statistics through
the fused device kernel, and the frame fixes (left-join null masking for all
column types, concat preserving the NaN != null distinction).
"""

import numpy as np
import pytest

import jax

import polars_ols_tpu as pot
from polars_ols_tpu import col
from polars_ols_tpu.series import ObjectSeries, Series, StatisticsSeries, StructSeries

import oracles


def _make_weighted(n=400, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    y = x.sum(axis=1) + rng.normal(size=n) * 0.1
    w = rng.uniform(0.25, 4.0, size=n)
    g = rng.integers(4, size=n).astype(float)
    return pot.DataFrame(
        {"y": y, "x1": x[:, 0], "x2": x[:, 1], "w": w, "g": g}
    ), x, y, w, g


# --------------------------------------------------------------------------- #
# no hidden device syncs
# --------------------------------------------------------------------------- #
def test_no_host_fetch_in_wls_rolling_query():
    """A grouped WLS rolling query with add_intercept must issue ZERO
    device->host transfers after warm-up: intercept injection and WLS
    scaling are folded into the engine (VERDICT r2 task 2 — the expression
    layer previously paid a blocking `validity.all()` fetch per arithmetic
    node and one kernel per scaled column)."""
    df, *_ = _make_weighted()
    expr = (
        col("y")
        .least_squares.rolling_ols(
            col("x1"), col("x2"),
            window_size=50, min_periods=5,
            sample_weights=col("w"), add_intercept=True,
        )
        .over("g")
    )
    warm = df.select(expr)  # compile + populate layout/stack caches
    np.asarray(warm["y"].to_numpy())
    with jax.transfer_guard_device_to_host("disallow"):
        out = df.select(expr)
    assert np.isfinite(out["y"].to_numpy()[np.asarray(out["y"].valid_mask())]).all()


def test_no_host_fetch_in_wls_statistics_query():
    """Weighted grouped statistics likewise run fetch-free after warm-up and
    return a device-native statistics column (no per-group host loop)."""
    df, *_ = _make_weighted()
    expr = (
        col("y")
        .least_squares.ols(
            col("x1"), col("x2"),
            mode="statistics", sample_weights=col("w"), add_intercept=True,
        )
        .over("g")
    )
    warm = df.select(expr)
    assert isinstance(warm["statistics"], StatisticsSeries)
    with jax.transfer_guard_device_to_host("disallow"):
        out = df.select(expr)
        assert isinstance(out["statistics"], StatisticsSeries)
    assert np.isfinite(out["statistics"][0]["r2"])


def test_binop_keeps_validity_without_sync():
    """Arithmetic on columns with validity keeps a correct mask (no
    device-sync shortcut): null slots stay null through +,*."""
    a = pot.Series("a", np.array([1.0, 2.0, 3.0]), np.array([True, False, True]))
    df = pot.DataFrame({"a": a, "b": np.array([1.0, 1.0, 1.0])})
    out = df.select((col("a") * 2.0 + col("b")).alias("c"))
    assert out["c"].to_list() == [3.0, None, 7.0]


# --------------------------------------------------------------------------- #
# statistics: CD / weighted / explicit-svd all device-native
# --------------------------------------------------------------------------- #
def test_cd_statistics_oracle():
    """mode='statistics' with an elastic-net solve: the coefficients field
    (and its residual metrics) report the CD solution (reference dispatch,
    src/expressions.rs:475) while se/t/p keep the normal-equation recompute
    (src/statistics.rs:116)."""
    rng = np.random.default_rng(11)
    n = 500
    x = rng.normal(size=(n, 3))
    y = x[:, 0] + 0.5 * x[:, 1] + rng.normal(size=n) * 0.1
    df = pot.DataFrame({"y": y, "x1": x[:, 0], "x2": x[:, 1], "x3": x[:, 2]})
    alpha, l1_ratio = 0.01, 1.0
    stats_col = df.select(
        col("y").least_squares.least_squares(
            col("x1"), col("x2"), col("x3"),
            mode="statistics", alpha=alpha, l1_ratio=l1_ratio,
        )
    )["statistics"]
    assert isinstance(stats_col, StatisticsSeries)
    row = stats_col[0]

    beta_cd = oracles.elastic_net_cd(x, y, alpha=alpha, l1_ratio=l1_ratio)
    np.testing.assert_allclose(row["coefficients"], beta_cd, rtol=1e-4, atol=1e-6)
    resid = y - x @ beta_cd
    assert row["mse"] == pytest.approx(float(resid @ resid) / n, rel=1e-4)
    assert row["mae"] == pytest.approx(float(np.abs(resid).mean()), rel=1e-4)
    sst = float(((y - y.mean()) ** 2).sum())
    assert row["r2"] == pytest.approx(1.0 - float(resid @ resid) / sst, rel=1e-4)

    # se/t/p from the ridge-aware normal-equation recompute
    res_ne = oracles.ridge_statistics(x, y, alpha)
    np.testing.assert_allclose(row["standard_errors"], res_ne["se"], rtol=1e-6)
    np.testing.assert_allclose(row["t_values"], res_ne["t"], rtol=1e-6)
    np.testing.assert_allclose(row["p_values"], res_ne["p"], rtol=1e-5, atol=1e-12)


def test_weighted_statistics_oracle():
    """WLS statistics equal OLS statistics of the sqrt-weight-scaled data —
    exactly what the reference computes, since its scaling happens before
    the plugin call (polars_ols/least_squares.py:190-196)."""
    df, x, y, w, _ = _make_weighted()
    stats_col = df.select(
        col("y").least_squares.ols(
            col("x1"), col("x2"), mode="statistics", sample_weights=col("w")
        )
    )["statistics"]
    assert isinstance(stats_col, StatisticsSeries)
    row = stats_col[0]
    sw = np.sqrt(w)
    res = oracles.ols_statistics(x * sw[:, None], y * sw)
    np.testing.assert_allclose(row["coefficients"], res["coef"], rtol=1e-8)
    np.testing.assert_allclose(row["standard_errors"], res["se"], rtol=1e-6)
    np.testing.assert_allclose(row["p_values"], res["p"], rtol=1e-5, atol=1e-12)
    assert row["r2"] == pytest.approx(res["r2"], rel=1e-6)


def test_svd_statistics_device_native():
    """Explicit solve_method='svd' statistics flow through the general path,
    which must also return the device-native statistics column."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 2))
    y = x.sum(axis=1) + rng.normal(size=300) * 0.1
    df = pot.DataFrame({"y": y, "x1": x[:, 0], "x2": x[:, 1]})
    stats_col = df.select(
        col("y").least_squares.least_squares(
            col("x1"), col("x2"), mode="statistics", solve_method="svd"
        )
    )["statistics"]
    assert isinstance(stats_col, StatisticsSeries)
    res = oracles.ols_statistics(x, y)
    row = stats_col[0]
    np.testing.assert_allclose(row["coefficients"], res["coef"], rtol=1e-8)
    np.testing.assert_allclose(row["standard_errors"], res["se"], rtol=1e-6)


# --------------------------------------------------------------------------- #
# frame fixes
# --------------------------------------------------------------------------- #
def test_left_join_masks_struct_and_object_columns():
    left = pot.DataFrame({"k": np.array([0.0, 1.0, 2.0]), "a": np.array([1.0, 2.0, 3.0])})
    coef = StructSeries("c", ["x1", "x2"], np.array([[1.0, 2.0], [3.0, 4.0]]))
    obj = ObjectSeries("o", [["p"], ["q"]])
    right = pot.DataFrame({"k": np.array([0.0, 1.0]), "c": coef, "o": obj})
    out = left.join(right, on="k", how="left")
    # matched rows keep values; the unmatched row (k=2) must be null
    c = out["c"]
    assert np.asarray(c.valid_mask())[:2].all()
    assert not np.asarray(c.valid_mask())[2]
    assert out["o"].to_list() == [["p"], ["q"], None]


def test_left_join_empty_right_frame():
    left = pot.DataFrame({"k": np.array([0.0, 1.0]), "a": np.array([1.0, 2.0])})
    right = pot.DataFrame({"k": np.array([]), "b": np.array([])})
    out = left.join(right, on="k", how="left")
    assert out.height == 2
    assert out["b"].to_list() == [None, None]
    assert out["a"].to_list() == [1.0, 2.0]


def test_concat_preserves_valid_nan_values():
    """Valid NaN values (not nulls) must survive concat: NaN != null in this
    substrate (series.py construction semantics)."""
    s1 = Series("v", np.array([1.0, np.nan]))  # NaN but valid
    s2 = Series("v", np.array([3.0, 4.0]), np.array([True, False]))  # one null
    df = pot.concat([
        pot.DataFrame({"v": s1}),
        pot.DataFrame({"v": s2}),
    ])
    out = df["v"]
    validity = np.asarray(out.valid_mask())
    np.testing.assert_array_equal(validity, [True, True, True, False])
    vals = np.asarray(out.values)
    assert np.isnan(vals[1])  # the valid NaN is still a NaN value
    assert out.to_list()[3] is None  # the null stays null


def test_lazyframe_caches_collect():
    df = pot.DataFrame({"a": np.arange(4.0)})
    lf = df.lazy().with_columns(b=col("a") * 2.0)
    first = lf.collect()
    assert lf.collect() is first  # plan replay happens once
    assert lf.columns == ["a", "b"]


def test_alpha_sweep_reuses_compiled_program():
    """alpha is a traced operand in the static-fit kernels: after the first
    ridge query compiles, further queries at different alphas (and plain ols,
    which shares the auto->chol path) must trigger ZERO new XLA backend
    compiles — the cold-start property for regularization sweeps (each
    compile costs seconds on the card)."""
    import jax.monitoring

    rng = np.random.default_rng(9)
    x = rng.normal(size=(600, 3))
    y = x.sum(axis=1) + rng.normal(size=600) * 0.1
    g = rng.integers(6, size=600).astype(float)
    df = pot.DataFrame(
        {"y": y, "x1": x[:, 0], "x2": x[:, 1], "x3": x[:, 2], "g": g}
    )
    feats = [col("x1"), col("x2"), col("x3")]

    def run(alpha):
        out = df.select(
            col("y").least_squares.ridge(*feats, alpha=alpha).over("g")
        )["y"]
        np.asarray(out.values[-2:])
        return out

    compiles = []
    listener = (
        lambda key, dur, **kw: compiles.append(key)
        if key == "/jax/core/compile/backend_compile_duration"
        else None
    )
    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        run(0.125)  # first alpha: compiles the program set (or reuses an
        # earlier test's cache — either way the sweep below must add zero)
        n_first = len(compiles)
        for alpha in (0.25, 0.5, 2.0):
            run(alpha)
        assert len(compiles) == n_first, (
            f"alpha sweep recompiled: {len(compiles) - n_first} extra programs"
        )
    finally:
        jax.monitoring.unregister_event_duration_listener(listener)
    # numeric parity across the sweep (traced alpha must not change results)
    for alpha in (0.125, 2.0):
        out = np.asarray(
            df.select(
                col("y").least_squares.ridge(
                    *feats, alpha=alpha, mode="coefficients"
                ).over("g")
            )["coefficients"].values
        )
        for gi in range(6):
            m = g == gi
            ref = np.linalg.solve(
                x[m].T @ x[m] + alpha * np.eye(3), x[m].T @ y[m]
            )
            np.testing.assert_allclose(out[m][0], ref, atol=1e-8)
