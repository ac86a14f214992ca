"""int8 digit-moment (Ozaki) and pair-gather path tests.

These paths default on only where config.BACKEND_DEFAULTS says so (the
digit moments on the GPU); here they are forced on so the CPU suite
exercises the same code.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import polars_ols_tpu as pot
from polars_ols_tpu import CONFIG, col
from polars_ols_tpu.ops.ozaki import decompose_blocks, moments_from_digits


@pytest.fixture
def force_digit_paths():
    oz, pg = CONFIG._use_ozaki, CONFIG._pair_gather
    CONFIG.use_ozaki = True
    CONFIG.pair_gather = True
    yield
    CONFIG._use_ozaki, CONFIG._pair_gather = oz, pg


def test_digit_moments_match_f64_einsum():
    rng = np.random.default_rng(0)
    S, R, C, G = 24, 128, 5, 6
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 4)
    wp = rng.random((S, R)) > 0.15
    bg = (np.arange(S) % G).astype(np.int32)
    digits, m = decompose_blocks(jnp.asarray(Zp), jnp.asarray(wp))
    M = np.asarray(
        moments_from_digits(digits, m, jnp.asarray(wp), jnp.asarray(bg), G)[0]
    )
    Zm = Zp * wp[..., None]
    ref = np.zeros((G, C, C))
    for s in range(S):
        ref[bg[s]] += Zm[s].T @ Zm[s]
    np.testing.assert_allclose(M, ref, rtol=5e-13, atol=1e-13 * np.abs(ref).max())


def test_grouped_ols_with_ozaki_matches_lstsq(force_digit_paths):
    rng = np.random.default_rng(1)
    n, k, g = 4_000, 4, 13
    X = rng.normal(size=(n, k)) * np.asarray([1.0, 10.0, 0.1, 100.0])
    gids = rng.integers(g, size=n)
    y = X @ np.asarray([1.0, -0.5, 2.0, 0.25]) + rng.normal(size=n) * 0.1
    df = pot.DataFrame(
        {"y": y, **{f"x{i+1}": X[:, i] for i in range(k)}, "g": gids.astype(float)}
    )
    feats = [col(f"x{i+1}") for i in range(k)]
    preds = df.select(col("y").least_squares.ols(*feats).over("g"))["y"].to_numpy()
    coefs = df.select(
        col("y").least_squares.ols(*feats, mode="coefficients").over("g")
    )["coefficients"]
    cm = np.asarray(coefs.values)
    for gi in range(g):
        m = gids == gi
        beta = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(cm[m][0], beta, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(preds[m], X[m] @ beta, rtol=1e-8, atol=1e-10)


def test_ridge_with_ozaki_matches_normal_equations(force_digit_paths):
    rng = np.random.default_rng(2)
    n, k, g = 2_000, 3, 7
    X = rng.normal(size=(n, k))
    gids = rng.integers(g, size=n)
    y = X.sum(axis=1) + rng.normal(size=n) * 0.1
    alpha = 0.7
    df = pot.DataFrame(
        {"y": y, **{f"x{i+1}": X[:, i] for i in range(k)}, "g": gids.astype(float)}
    )
    preds = df.select(
        col("y").least_squares.ridge("x1", "x2", "x3", alpha=alpha).over("g")
    )["y"].to_numpy()
    for gi in range(g):
        m = gids == gi
        beta = np.linalg.solve(X[m].T @ X[m] + alpha * np.eye(k), X[m].T @ y[m])
        np.testing.assert_allclose(preds[m], X[m] @ beta, rtol=1e-8, atol=1e-10)

