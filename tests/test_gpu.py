"""Tests that need a GPU backend: the default configuration on the card.

Run on a machine with a GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Elsewhere every test here skips (the decision is made in a fixture, so
that every pytest worker collects the same tests).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import polars_ols_tpu as pot
from polars_ols_tpu import col

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU backend; JAX runs on {jax.default_backend()!r}")


def _grouped_problem(n=20_000, k=4, g=50, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)) * np.asarray([1.0, 10.0, 0.1, 100.0])[:k]
    gids = rng.integers(g, size=n)
    y = X @ rng.normal(size=k) + rng.normal(size=n) * 0.1
    df = pot.DataFrame(
        {"y": y, **{f"x{i+1}": X[:, i] for i in range(k)}, "g": gids.astype(float)}
    )
    return df, X, y, gids, [col(f"x{i+1}") for i in range(k)]


def test_grouped_ols_default_config_matches_lstsq(gpu):
    df, X, y, gids, feats = _grouped_problem()
    preds = df.select(col("y").least_squares.ols(*feats).over("g"))["y"].to_numpy()
    coefs = np.asarray(df.select(
        col("y").least_squares.ols(*feats, mode="coefficients").over("g")
    )["coefficients"].values)
    for gi in range(gids.max() + 1):
        m = gids == gi
        beta = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(coefs[m][0], beta, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(preds[m], X[m] @ beta, rtol=1e-8, atol=1e-10)


def test_ozaki_moments_match_plain_f64(gpu):
    """int8 digit moments on the card agree with the plain f64 moments."""
    from polars_ols_tpu.ops.direct import grouped_moments
    from polars_ols_tpu.ops.ozaki import decompose_blocks, moments_from_digits

    rng = np.random.default_rng(1)
    S, R, C, G = 64, 256, 6, 16
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 4)
    wp = rng.random((S, R)) > 0.15
    bg = (np.arange(S) % G).astype(np.int32)
    digits, m = decompose_blocks(jnp.asarray(Zp), jnp.asarray(wp))
    M = np.asarray(
        moments_from_digits(digits, m, jnp.asarray(wp), jnp.asarray(bg), G)[0]
    )
    XtX, Xty, _ = grouped_moments(
        jnp.asarray(Zp[..., 1:]), jnp.asarray(Zp[..., 0]), jnp.asarray(wp),
        jnp.asarray(bg), G,
    )
    scale = np.abs(M).max()
    np.testing.assert_allclose(M[:, 1:, 1:], np.asarray(XtX), rtol=5e-13,
                               atol=1e-13 * scale)
    np.testing.assert_allclose(M[:, 1:, 0], np.asarray(Xty), rtol=5e-13,
                               atol=1e-13 * scale)


@pytest.mark.parametrize("model", ["rls", "rolling"])
def test_grouped_moving_default_config(gpu, model):
    """Grouped moving models on the card's default kernels agree with the
    exact sequential recursions."""
    from oracles import recursive_least_squares, rolling_ols_valid_window

    df, X, y, gids, feats = _grouped_problem(n=6_000, k=3, g=80, seed=2)
    ls = col("y").least_squares
    expr = (ls.rls(*feats, half_life=30.0, mode="coefficients") if model == "rls"
            else ls.rolling_ols(*feats, window_size=40, mode="coefficients"))
    coefs = np.asarray(df.select(expr.over("g"))["coefficients"].values)
    for gi in (0, 41, 79):
        m = gids == gi
        if model == "rls":
            want = recursive_least_squares(X[m], y[m], np.ones(m.sum(), bool),
                                           half_life=30.0)
            np.testing.assert_allclose(coefs[m], want, rtol=1e-6, atol=1e-8)
        else:
            # rows whose window holds < 2K rows feel the engine's diffuse
            # prior (1e-10 of the data scale) on a nearly square system
            want = rolling_ols_valid_window(X[m], y[m], 40)
            np.testing.assert_allclose(coefs[m][6:], want[6:], rtol=1e-6, atol=1e-8)
