"""Executable walkthrough of the polars_ols_tpu API.

Mirrors the feature tour of the reference's demo notebook
(/root/reference/notebooks/polars_ols_demo.ipynb) section by section, but
written against this engine: every example runs on whatever JAX backend is
active and asserts its claims against numpy/sklearn oracles.

Run on the CPU mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/demo.py --cpu
or on the default backend (a GPU where JAX finds one):
    python examples/demo.py
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
args = ap.parse_args()
if args.cpu:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import polars_ols_tpu as pls  # noqa: E402
from polars_ols_tpu import col, selectors, struct  # noqa: E402


def make_data(n=2_000, k=3, n_groups=5, noise=0.1, missing=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    y = x @ np.arange(1.0, k + 1) + rng.normal(size=n, scale=noise)
    cols = {f"x{i + 1}": x[:, i] for i in range(k)}
    if missing:
        mask = rng.random(n) < 0.1
        cols["y"] = pls.Series("y", np.where(mask, 0.0, y), ~mask)
        for i in (1,):
            m = rng.random(n) < 0.1
            cols[f"x{i + 1}"] = pls.Series(
                f"x{i + 1}", np.where(m, 0.0, x[:, i]), ~m
            )
    else:
        cols["y"] = y
    cols["group"] = rng.integers(n_groups, size=n).astype(float)
    cols["sample_weights"] = rng.random(n) + 0.1
    return pls.DataFrame(cols)


def section(title):
    print(f"\n=== {title} ===")


# ------------------------------------------------------------------------- #
section("1A. Basic usage: OLS / WLS")
# ------------------------------------------------------------------------- #
df = make_data()

# module-level compute function and the registered namespace are equivalent;
# features can be strings, col() expressions, or wildcard/selector exprs
ols_expr = pls.compute_least_squares(
    col("y"),
    selectors.starts_with("x"),
    mode="predictions",
    ols_kwargs=pls.OLSKwargs(null_policy="drop", solve_method="svd"),
)
out1 = df.select(ols_expr.alias("p"))["p"].to_numpy()
out2 = df.select(
    col("y").least_squares.ols(col("^x.*$"), solve_method="svd").alias("p")
)["p"].to_numpy()
np.testing.assert_allclose(out1, out2, atol=1e-12)

# expressions compose: per-group fits with .over(), lazily if you like
wls_expr = col("y").least_squares.wls(
    "x1", "x2", "x3", sample_weights=col("sample_weights")
)
frame = (
    df.lazy()
    .with_columns(
        ols_expr.over("group").alias("predictions_ols_group"),
        ols_expr.alias("predictions_ols"),
        (wls_expr * (col("group") == 2)).alias("predictions_wls_masked"),
    )
    .collect()
)
print(frame.select("predictions_ols", "predictions_ols_group").tail(3).to_numpy())

# mode="coefficients" returns a compact struct (one field per feature)
coefs = df.select(
    col("y").least_squares.ols(
        col("^x.*$"), add_intercept=True, mode="coefficients"
    ).alias("coefficients")
)
print("coefficient struct fields:", coefs["coefficients"].field_names)

# grouped coefficients broadcast to the frame's shape; unnest() unpacks them
df_coefs = df.select(
    "group",
    col("y").least_squares.ols(
        "x1", "x2", "x3", mode="coefficients"
    ).over("group").alias("coefficients"),
)
print(df_coefs.unnest("coefficients").head(2).to_numpy())

# ------------------------------------------------------------------------- #
section("1B. Null policies and solve methods")
# ------------------------------------------------------------------------- #
df_missing = make_data(missing=True)

# "zero" == fill nulls with 0 before fitting
pred_zero = df_missing.select(
    col("y").least_squares.ols(col("^x.*$"), null_policy="zero").alias("p")
)["p"].to_numpy()
expected = df_missing.fill_null(0.0).select(
    col("y").least_squares.ols(col("^x.*$")).alias("p")
)["p"].to_numpy()
np.testing.assert_allclose(pred_zero, expected, atol=1e-12)

# "drop" == drop any row with a null target/feature before fitting
coef_drop = df_missing.select(
    col("y").least_squares.ols(
        "x1", "x2", mode="coefficients", null_policy="drop"
    ).alias("c")
).unnest("c").to_numpy()
expected = df_missing.drop_nulls(subset=["y", "x1", "x2"]).select(
    col("y").least_squares.ols("x1", "x2", mode="coefficients").alias("c")
).unnest("c").to_numpy()
np.testing.assert_allclose(coef_drop, expected, atol=1e-12)

# "drop_y_zero_x" == drop null-target rows, zero-fill remaining nulls
coef_dyzx = df_missing.select(
    col("y").least_squares.ols(
        "x1", "x2", mode="coefficients", null_policy="drop_y_zero_x"
    ).alias("c")
).unnest("c").to_numpy()
expected = df_missing.drop_nulls(subset=["y"]).fill_null(0.0).select(
    col("y").least_squares.ols("x1", "x2", mode="coefficients").alias("c")
).unnest("c").to_numpy()
np.testing.assert_allclose(coef_dyzx, expected, atol=1e-12)

# multicollinear data: "svd" recovers the numpy-lstsq minimum-norm solution
x12 = df.select("x1", "x2").to_numpy()
dfc = pls.DataFrame(
    {
        "x1": x12[:, 0],
        "x2": x12[:, 1],
        "x3": x12[:, 1],  # exact copy: rank-deficient
        "y": x12[:, 0] + 2 * x12[:, 1],
    }
)
coef_svd = dfc.select(
    col("y").least_squares.ols(
        "x1", "x2", "x3", solve_method="svd", mode="coefficients"
    ).alias("c")
).unnest("c").to_numpy()[0]
xs = dfc.select("x1", "x2", "x3").to_numpy()
expected = np.linalg.lstsq(xs, dfc["y"].to_numpy(), rcond=None)[0]
np.testing.assert_allclose(coef_svd, expected, atol=1e-8)
print("minimum-norm SVD solution:", np.round(coef_svd, 6))

# ------------------------------------------------------------------------- #
section("2. Regularized models (ridge / lasso / elastic net / NNLS)")
# ------------------------------------------------------------------------- #
enet_nn = df.select(
    col("y").least_squares.elastic_net(
        col("x1"), col("x2"), col("x3"),
        alpha=1e-4, l1_ratio=0.5, positive=True, mode="coefficients",
    ).alias("c")
).unnest("c").to_numpy()[0]
assert (enet_nn >= 0).all(), "NNLS constraint violated"
print("non-negative elastic net:", np.round(enet_nn, 4))

try:
    from sklearn.linear_model import ElasticNet

    dfw = make_data(n=500, k=20, seed=3)
    feats = [col(f"x{i + 1}") for i in range(20)]
    coef = dfw.select(
        col("y").least_squares.elastic_net(
            *feats, l1_ratio=0.5, alpha=0.1, max_iter=1_000, tol=1e-4,
            mode="coefficients",
        ).alias("c")
    ).unnest("c").to_numpy()[0]
    X = dfw.select(*[f"x{i + 1}" for i in range(20)]).to_numpy()
    mdl = ElasticNet(l1_ratio=0.5, alpha=0.1, max_iter=1_000, tol=1e-4,
                     fit_intercept=False)
    mdl.fit(X, dfw["y"].to_numpy())
    np.testing.assert_allclose(coef, mdl.coef_, rtol=1e-4, atol=1e-4)
    print("coordinate descent matches sklearn ElasticNet")
except ImportError:  # pragma: no cover
    print("sklearn unavailable; skipping the oracle comparison")

# ------------------------------------------------------------------------- #
section("3. Formula API")
# ------------------------------------------------------------------------- #
resid_1 = df.select(
    pls.compute_least_squares_from_formula(
        "y ~ x1 + x2:x3 -1", mode="residuals"
    ).alias("r")
)["r"].to_numpy()
resid_2 = df.select(
    (col("y") - col("y").least_squares.from_formula(
        "x1 + x2:x3 -1", mode="predictions"
    )).alias("r")
)["r"].to_numpy()
np.testing.assert_allclose(resid_1, resid_2, atol=1e-10)
print("formula residuals == target - formula predictions")

# ------------------------------------------------------------------------- #
section("4. Dynamic regression (rolling / expanding / RLS)")
# ------------------------------------------------------------------------- #
dyn = df.select(
    col("y").least_squares.rolling_ols(
        "x1", "x2", "x3", window_size=252, min_periods=5, alpha=1e-4,
        mode="coefficients",
    ).over("group").alias("rolling_ridge_coef"),
    col("y").least_squares.rls(
        "x1", "x2", "x3", half_life=21.0,
        initial_state_mean=[-1.0, -1.0, -1.0], initial_state_covariance=0.2,
        mode="coefficients",
    ).over("group").alias("rls_coef"),
    col("y").least_squares.expanding_ols(
        "x1", "x2", "x3", mode="coefficients"
    ).over("group").alias("expanding_coef"),
)
print("dynamic coefficient columns:", dyn.columns)

# ------------------------------------------------------------------------- #
section("5. Out-of-sample prediction")
# ------------------------------------------------------------------------- #
df_coefficients = df.select(
    "group",
    col("y").least_squares.ols(
        col("x1"), col("x2"), mode="coefficients"
    ).over("group").alias("coefficients"),
).unique()

df_test = make_data(seed=7)
predictions = (
    df_test.join(df_coefficients, on="group")
    .select(
        "group", "x1", "x2",
        col("coefficients").least_squares.predict(
            col("x1"), col("x2"), name="predictions_test"
        ),
    )
)
print("test predictions:", predictions["predictions_test"].to_numpy()[:3])

# ------------------------------------------------------------------------- #
section("6. Multi-target regression (shared factorization)")
# ------------------------------------------------------------------------- #
df_multi = df.with_columns(
    struct(
        (col("x1") + col("x2") + col("x3")).alias("y1"),
        (col("x1") - col("x2") + col("x3")).alias("y2"),
    ).alias("targets")
)
multi = df_multi.with_columns(
    col("targets").least_squares.multi_target_ols(
        "x1", "x2", "x3", mode="residuals"
    ).over("group").alias("residuals")
)
res = multi["residuals"]
print("multi-target residual struct fields:", res.field_names)

print("\nAll demo sections passed.")
