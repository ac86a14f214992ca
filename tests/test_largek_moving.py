"""Large-K moving-window paths (Sherman-Morrison / Woodbury scans).

Above K=32 the moving models switch from chunked prefix kernels to per-row
rank-1 update scans — the reference's own Woodbury strategy for k > 60
(src/least_squares.rs:629-787). Verified here against direct oracles.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import polars_ols_tpu as pot
from polars_ols_tpu import col

from polars_ols_tpu.ops.recursive import solve_recursive_least_squares
from polars_ols_tpu.ops.rolling import solve_rolling_ols


def _kalman_oracle(X, y, v, ff, c):
    K = X.shape[1]
    P = np.eye(K) * c
    coef = np.zeros(K)
    out = np.zeros_like(X)
    for t in range(len(y)):
        if v[t]:
            Px = P @ X[t]
            r = 1.0 + X[t] @ Px / ff
            k = Px / (r * ff)
            coef = coef + k * (y[t] - X[t] @ coef)
            P = P / ff - np.outer(k, k) * r
        out[t] = coef
    return out


def test_rls_sm_scan_matches_kalman_oracle():
    rng = np.random.default_rng(0)
    R, K = 400, 40  # K > 32 -> Sherman-Morrison path
    X = rng.normal(size=(R, K))
    y = X @ rng.normal(size=K) + rng.normal(size=R) * 0.1
    v = rng.random(R) > 0.1
    ff = np.exp(np.log(0.5) / 60.0)
    out = solve_recursive_least_squares(
        jnp.asarray(X)[None], jnp.asarray(y)[None], jnp.asarray(v)[None],
        half_life=60.0, initial_state_covariance=10.0,
        initial_state_mean=None, chunk=64,
    )
    expected = _kalman_oracle(X, y, v, ff, 10.0)
    np.testing.assert_allclose(np.asarray(out[0]), expected, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("alpha", [0.5, 0.0])
def test_rolling_sm_scan_matches_per_window_solve(alpha):
    rng = np.random.default_rng(1)
    R, K, W = 300, 40, 120
    X = rng.normal(size=(R, K))
    y = X @ rng.normal(size=K) + rng.normal(size=R) * 0.1
    out = np.asarray(
        solve_rolling_ols(
            jnp.asarray(X)[None], jnp.asarray(y)[None],
            jnp.ones((1, R), dtype=bool),
            window=W, min_periods=None, alpha=alpha, positional=True, chunk=64,
        )[0]
    )
    # exact with ridge; diffuse prior (~1e-10 of data scale) without
    tol = 1e-8 if alpha > 0 else 1e-5
    for t in (K, K + 37, R // 2, R - 1):
        lo = max(0, t - W + 1)
        Xw, yw = X[lo : t + 1], y[lo : t + 1]
        beta = np.linalg.solve(Xw.T @ Xw + alpha * np.eye(K), Xw.T @ yw)
        np.testing.assert_allclose(out[t], beta, rtol=tol, atol=tol)


def test_classic_moving_group_blocking_parity(monkeypatch):
    """When G * K^2 scan state would overflow the backend budget, the
    classic kernels run over sequential group blocks; forcing a tiny block
    size must reproduce the unblocked output exactly for both rls and
    rolling."""
    import polars_ols_tpu.engine.fit as fit
    from polars_ols_tpu.config import CONFIG

    rng = np.random.default_rng(11)
    n, G, K = 6_000, 23, 4
    X = rng.normal(size=(n, K))
    y = X @ rng.normal(size=K) + rng.normal(size=n) * 0.1
    d = {f"x{i}": X[:, i] for i in range(K)}
    d["y"] = y
    d["g"] = rng.integers(G, size=n).astype(float)
    df = pot.DataFrame(d)
    feats = [col(f"x{i}") for i in range(K)]

    def run():
        pot.clear_caches()
        rls = df.select(
            col("y").least_squares.rls(*feats, half_life=60.0).over("g").alias("p")
        )["p"].to_numpy()
        roll = df.select(
            col("y").least_squares.rolling_ols(*feats, window_size=100)
            .over("g").alias("p")
        )["p"].to_numpy()
        return rls, roll

    assert not CONFIG.moving_lanes  # classic kernels are the CPU default
    base = run()
    monkeypatch.setattr(fit, "_moving_group_block", lambda G, k: 5)
    blocked = run()
    for a, b in zip(base, blocked):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_rolling_refined_sm_grouped_largek():
    """Grouped rolling at K > 32 (beyond the lane-chol tier) rides the
    refined-SM lanes with an f64 P-state: the diffuse chunk-0 seed is
    f64-stable, so many-group batches no longer need a per-group direct
    pass (the reference's Woodbury path covers every K uniformly,
    src/least_squares.rs:848-1032)."""
    from polars_ols_tpu.ops.moving import _use_lane_chol, solve_rolling_lanes

    rng = np.random.default_rng(21)
    G, R, K = 10, 192, 40
    W, MP = 96, 44
    assert not _use_lane_chol(K, G)  # must exercise refined-SM
    X = rng.normal(size=(G, R, K))
    beta_true = rng.normal(size=(G, K))
    y = np.einsum("grk,gk->gr", X, beta_true) + rng.normal(size=(G, R)) * 0.1
    v = rng.random((G, R)) > 0.08
    X = X * v[..., None]
    y = y * v
    out = np.asarray(
        solve_rolling_lanes(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(v),
            window=W, min_periods=MP, alpha=0.0, positional=False,
        )
    )
    scale = float(np.mean(X * X) * min(W, R))
    for g in (0, 4, G - 1):
        valid_idx = np.flatnonzero(v[g])
        for t in (MP + 20, R // 2, R - 1):
            upto = valid_idx[valid_idx <= t]
            if len(upto) < MP:
                continue
            rows = upto[-W:]
            Xw, yw = X[g][rows], y[g][rows]
            beta = np.linalg.solve(
                Xw.T @ Xw + 1e-10 * scale * np.eye(K), Xw.T @ yw
            )
            np.testing.assert_allclose(out[g, t], beta, rtol=2e-5, atol=2e-5)


def test_sm_chunk_respects_backend_element_cap():
    """chunk * K^2 must stay under the 2^19 scan-state element cap: the
    K=40 grouped RLS benchmark shape would otherwise pick chunk=512 (819k
    elements). The classic kernels cap this in engine/fit.py _pick_chunk; the
    refined-SM tier must too."""
    import math

    from polars_ols_tpu.ops.moving import _sm_chunk

    for K in (33, 40, 64, 100):
        for R in (512, 600, 1024, 4096):
            for ln_inv_ff in (0.0, math.log(2.0) / 252.0):
                c = _sm_chunk(R, ln_inv_ff, K)
                assert c * K * K <= 1 << 19, (K, R, ln_inv_ff, c)
                assert c >= 8


def test_rls_refined_sm_grouped_largek_long_history():
    """K=40 with R > 512 — the grouped_largek benchmark shape class, whose
    discounted refined-SM program would run at chunk=512 without the cap. With
    the element cap the chunk drops to 256 (multi-chunk lanes); verify the
    full path against the sequential Kalman oracle."""
    from polars_ols_tpu.ops.moving import (
        _sm_chunk,
        _use_lane_chol,
        solve_recursive_lanes,
    )

    G, R, K = 3, 600, 40
    half_life = 252.0
    assert not _use_lane_chol(K, G)  # must exercise refined-SM
    import math

    assert _sm_chunk(R, math.log(2.0) / half_life, K) == 256
    rng = np.random.default_rng(11)
    X = rng.normal(size=(G, R, K))
    beta_true = rng.normal(size=(G, K))
    y = np.einsum("grk,gk->gr", X, beta_true) + rng.normal(size=(G, R)) * 0.1
    v = rng.random((G, R)) > 0.07
    X = X * v[..., None]
    y = y * v
    ff = np.exp(np.log(0.5) / half_life)
    out = np.asarray(
        solve_recursive_lanes(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(v),
            half_life=half_life, initial_state_covariance=10.0,
            initial_state_mean=None,
        )
    )
    for g in range(G):
        expected = _kalman_oracle(X[g], y[g], v[g], ff, 10.0)
        np.testing.assert_allclose(out[g], expected, rtol=2e-7, atol=2e-8)


def test_rolling_blocked_lanes_parity(monkeypatch):
    """Grouped rolling whose whole-batch lane state exceeds the memory
    budget runs refined-SM over sequential group blocks; output must match
    the classic kernels (mirror of the RLS test below)."""
    import polars_ols_tpu.ops.moving as moving
    from polars_ols_tpu.config import CONFIG

    rng = np.random.default_rng(13)
    n, G, K = 6_000, 48, 4
    X = rng.normal(size=(n, K))
    y = X @ rng.normal(size=K) + rng.normal(size=n) * 0.1
    d = {f"x{i}": X[:, i] for i in range(K)}
    d["y"] = y
    d["g"] = rng.integers(G, size=n).astype(float)
    df = pot.DataFrame(d)
    feats = [col(f"x{i}") for i in range(K)]

    def run():
        pot.clear_caches()
        return df.select(
            col("y").least_squares.rolling_ols(*feats, window_size=60)
            .over("g").alias("p")
        )["p"].to_numpy()

    base = run()  # classic kernels (CPU default)
    monkeypatch.setattr(moving, "LANE_CHOL_UNROLL_MAX_K", 2)
    monkeypatch.setattr(moving, "LANE_CHOL_MAX_K", 2)
    monkeypatch.setattr(moving, "_SM_STATE_BYTES", 9_000)
    monkeypatch.setattr(CONFIG, "_moving_lanes", True)
    R_pad = -(-int(np.bincount(d["g"].astype(int)).max()) // 256) * 256
    gb = moving.lanes_group_block(G, R_pad, K, None, rolling=True)
    assert gb not in (0, G)
    blocked = run()
    monkeypatch.setattr(CONFIG, "_moving_lanes", False)
    np.testing.assert_allclose(blocked, base, rtol=1e-6, atol=1e-8, equal_nan=True)


def test_rls_blocked_lanes_parity(monkeypatch):
    """Grouped RLS whose whole-batch lane state exceeds the memory budget
    runs the fast refined-SM kernels over sequential group blocks; output
    must match the classic kernels."""
    import polars_ols_tpu.ops.moving as moving
    from polars_ols_tpu.config import CONFIG

    rng = np.random.default_rng(5)
    n, G, K = 8_000, 64, 4
    X = rng.normal(size=(n, K))
    y = X @ rng.normal(size=K) + rng.normal(size=n) * 0.1
    d = {f"x{i}": X[:, i] for i in range(K)}
    d["y"] = y
    d["g"] = rng.integers(G, size=n).astype(float)
    df = pot.DataFrame(d)
    feats = [col(f"x{i}") for i in range(K)]

    def run():
        pot.clear_caches()
        return df.select(
            col("y").least_squares.rls(*feats, half_life=80.0).over("g").alias("p")
        )["p"].to_numpy()

    base = run()  # classic kernels (CPU default)
    # force the blocked-lanes route: disable the exact lane-chol tier and
    # shrink the SM state budget so the full batch fails but a 16-group
    # block fits
    monkeypatch.setattr(moving, "LANE_CHOL_UNROLL_MAX_K", 2)
    monkeypatch.setattr(moving, "LANE_CHOL_MAX_K", 2)
    monkeypatch.setattr(moving, "_SM_STATE_BYTES", 8_000)
    monkeypatch.setattr(CONFIG, "_moving_lanes", True)
    assert moving.lanes_group_block(G, 256, K, 80.0) not in (0, G)
    blocked = run()
    monkeypatch.setattr(CONFIG, "_moving_lanes", False)
    np.testing.assert_allclose(blocked, base, rtol=1e-6, atol=1e-8)
