"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The reference has no distributed path at all (SURVEY §2.3) — these tests
cover what the engine adds: sharded moment merges must equal the
single-device grouped solve exactly (associativity of XtX), and the
group-parallel solver path must match its unsharded counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import polars_ols_tpu as pot
from polars_ols_tpu.ops.cd import solve_elastic_net
from polars_ols_tpu.ops.recursive import solve_recursive_least_squares
from polars_ols_tpu.parallel import (
    fit_moments_sharded,
    make_mesh,
    solve_groups_sharded,
)


def _grouped_data(n=4_000, k=3, g=17, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    beta_g = rng.normal(size=(g, k))
    gids = rng.integers(g, size=n)
    y = np.einsum("nk,nk->n", X, beta_g[gids]) + rng.normal(size=n) * 0.1
    return X, y, gids


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_fit_moments_sharded_matches_lstsq(n_devices):
    if len(jax.devices()) < n_devices:
        pytest.skip("not enough devices")
    X, y, gids = _grouped_data()
    g = int(gids.max()) + 1
    mesh = make_mesh(n_devices)
    beta, preds = fit_moments_sharded(
        mesh,
        jnp.asarray(X),
        jnp.asarray(y),
        jnp.ones(len(y), dtype=bool),
        jnp.asarray(gids),
        num_groups=g,
    )
    beta = np.asarray(beta)
    for gi in range(g):
        m = gids == gi
        expected = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(beta[gi], expected, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(preds), np.einsum("nk,nk->n", X, beta[gids]), rtol=1e-10
    )


def test_fit_moments_sharded_skewed_groups():
    """One heavy group spanning every shard merges exactly (psum merge)."""
    rng = np.random.default_rng(1)
    n, k = 8_192, 4
    X = rng.normal(size=(n, k))
    gids = np.zeros(n, dtype=np.int64)
    gids[: n // 64] = np.arange(n // 64) % 7 + 1  # 7 tiny groups + 1 heavy
    y = X.sum(1) + rng.normal(size=n) * 0.1
    mesh = make_mesh(8)
    beta, _ = fit_moments_sharded(
        mesh, jnp.asarray(X), jnp.asarray(y), jnp.ones(n, dtype=bool),
        jnp.asarray(gids), num_groups=8,
    )
    beta = np.asarray(beta)
    for gi in range(8):
        m = gids == gi
        expected = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(beta[gi], expected, rtol=1e-8, atol=1e-8)


def test_fit_moments_sharded_2d_mesh():
    X, y, gids = _grouped_data(n=2_048, g=12)
    g = 12
    mesh = make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    beta, _ = fit_moments_sharded(
        mesh, jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y), dtype=bool),
        jnp.asarray(gids), num_groups=g, row_axes=("data", "model"),
    )
    beta = np.asarray(beta)
    for gi in range(g):
        m = gids == gi
        expected = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(beta[gi], expected, rtol=1e-8, atol=1e-8)


def test_solve_groups_sharded_cd_matches_single_device():
    rng = np.random.default_rng(2)
    G, R, K = 16, 256, 4
    Xp = jnp.asarray(rng.normal(size=(G, R, K)))
    yp = jnp.asarray(rng.normal(size=(G, R)))
    n_valid = jnp.full((G,), float(R))
    kwargs = dict(alpha=0.1, l1_ratio=0.5, max_iter=500, tol=1e-7, positive=False)
    single = solve_elastic_net(Xp, yp, n_valid, **kwargs)
    mesh = make_mesh(8)
    sharded = solve_groups_sharded(mesh, solve_elastic_net, [Xp, yp, n_valid], **kwargs)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), rtol=1e-12)


def test_solve_groups_sharded_rls_matches_single_device():
    rng = np.random.default_rng(3)
    G, R, K = 8, 128, 3
    Xp = jnp.asarray(rng.normal(size=(G, R, K)))
    yp = jnp.asarray(rng.normal(size=(G, R)))
    vp = jnp.asarray(rng.random((G, R)) > 0.1)
    kwargs = dict(
        half_life=20.0, initial_state_covariance=10.0, initial_state_mean=None, chunk=64
    )
    single = solve_recursive_least_squares(Xp, yp, vp, **kwargs)
    mesh = make_mesh(8)
    sharded = solve_groups_sharded(
        mesh, solve_recursive_least_squares, [Xp, yp, vp], **kwargs
    )
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), rtol=1e-10)


def test_expression_api_agrees_with_sharded_fit():
    """End-to-end: the single-device expression engine and the distributed
    moments path produce identical grouped coefficients."""
    X, y, gids = _grouped_data(n=1_000, k=2, g=5)
    df = pot.DataFrame(
        {"y": y, "x1": X[:, 0], "x2": X[:, 1], "group": gids.astype(float)}
    )
    out = df.select(
        pot.col("y").least_squares.ols("x1", "x2", mode="coefficients").over("group"),
        pot.col("group"),
    )
    coef = out["coefficients"]
    mesh = make_mesh(8)
    beta, _ = fit_moments_sharded(
        mesh, jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y), dtype=bool),
        jnp.asarray(gids), num_groups=5,
    )
    np.testing.assert_allclose(
        np.asarray(coef.values), np.asarray(beta)[gids], rtol=1e-7, atol=1e-9
    )


def test_auto_shard_expression_api():
    """CONFIG.auto_shard routes grouped fits through the mesh engine with
    identical results to the single-device path."""
    from polars_ols_tpu import CONFIG

    X, y, gids = _grouped_data(n=2_000, k=3, g=9)
    df = pot.DataFrame(
        {"y": y, "x1": X[:, 0], "x2": X[:, 1], "x3": X[:, 2],
         "g": gids.astype(float)}
    )
    expr = pot.col("y").least_squares.ols("x1", "x2", "x3").over("g")
    single = df.select(expr)["y"].to_numpy()
    try:
        CONFIG.auto_shard = True
        sharded = df.select(expr)["y"].to_numpy()
        coefs = df.select(
            pot.col("y").least_squares.ols("x1", "x2", "x3",
                                           mode="coefficients").over("g")
        )["coefficients"]
    finally:
        CONFIG.auto_shard = False
    np.testing.assert_allclose(sharded, single, rtol=1e-10, atol=1e-12)
    cm = np.asarray(coefs.values)
    for gi in range(9):
        m = gids == gi
        expected = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(cm[m][0], expected, rtol=1e-8, atol=1e-9)


def test_make_mesh_multiprocess_topology(monkeypatch):
    """On multi-host runs make_mesh must build the ("hosts", "chips") mesh
    with processes on the outer (cross-host) axis — verified by faking
    jax.process_count() on the 8-device CPU mesh (4 hosts x 2 chips)."""
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    mesh = make_mesh()
    assert tuple(mesh.axis_names) == ("hosts", "chips")
    assert mesh.devices.shape == (4, 2)
    # every device appears exactly once
    ids = sorted(d.id for d in mesh.devices.ravel())
    assert ids == sorted(d.id for d in jax.devices())
    # a sharded fit over the 2-D mesh still matches the oracle
    X, y, gids = _grouped_data(n=1_000, k=2, g=8, seed=4)
    w = jnp.ones(len(y), dtype=bool)
    beta, _ = fit_moments_sharded(
        mesh, jnp.asarray(X), jnp.asarray(y), w, jnp.asarray(gids),
        num_groups=8, row_axes=("hosts", "chips"),
    )
    for g in range(8):
        m = gids == g
        ref = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(np.asarray(beta)[g], ref, atol=1e-9)


def _expected_group_layout(X, y, w, gids, G, R):
    """Host oracle for the shuffled whole-group layout: each group's rows in
    global row order, padding slots invalid."""
    K = X.shape[1]
    Xg = np.zeros((G, R, K))
    yg = np.zeros((G, R))
    vg = np.zeros((G, R), dtype=bool)
    for g in range(G):
        rows = np.flatnonzero(gids == g)
        Xg[g, : len(rows)] = X[rows]
        yg[g, : len(rows)] = y[rows]
        vg[g, : len(rows)] = w[rows]
    return Xg, yg, vg


@pytest.mark.parametrize(
    "n_devices,axes,shape",
    [(1, None, None), (4, None, None), (8, None, None),
     (8, ("hosts", "chips"), (4, 2))],
)
def test_shuffle_rows_to_groups_matches_host_layout(n_devices, axes, shape):
    """The device-side all-to-all row shuffle must reproduce the host-built
    padded whole-group layout exactly: per-group rows in global row order
    (the scan solvers' time order), validity carried, padding invalid."""
    from polars_ols_tpu.parallel import shuffle_rows_to_groups

    if len(jax.devices()) < n_devices:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(7)
    N, K, G = 501, 3, 13
    X = rng.normal(size=(N, K))
    y = rng.normal(size=N)
    w = rng.random(N) > 0.1  # some invalid rows keep their slots
    gids = rng.integers(G, size=N)
    mesh = make_mesh(n_devices, axis_names=axes, shape=shape)
    Xg, yg, vg, g_out = shuffle_rows_to_groups(
        mesh,
        jnp.asarray(X),
        jnp.asarray(y),
        jnp.asarray(w),
        jnp.asarray(gids),
        num_groups=G,
    )
    assert g_out == G
    Xg, yg, vg = np.asarray(Xg), np.asarray(yg), np.asarray(vg)
    R = Xg.shape[1]
    Xe, ye, ve = _expected_group_layout(X, y, w, gids, G, R)
    np.testing.assert_array_equal(vg[:G], ve)
    np.testing.assert_array_equal(Xg[:G], Xe)
    np.testing.assert_array_equal(yg[:G], ye)
    # padding groups beyond G are fully invalid
    assert not vg[G:].any()


def test_shuffle_rows_feed_scan_solver():
    """End to end: data-parallel rows -> all-to-all shuffle -> group-sharded
    RLS scan equals the single-device solve on the host-built layout."""
    from polars_ols_tpu.ops.moving import solve_recursive_lanes
    from polars_ols_tpu.parallel import shuffle_rows_to_groups

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(11)
    N, K, G = 640, 2, 8
    X = rng.normal(size=(N, K))
    gids = rng.integers(G, size=N)
    beta_g = rng.normal(size=(G, K))
    y = np.einsum("nk,nk->n", X, beta_g[gids]) + 0.01 * rng.normal(size=N)
    w = np.ones(N, dtype=bool)
    mesh = make_mesh(8)
    Xg, yg, vg, _ = shuffle_rows_to_groups(
        mesh, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        jnp.asarray(gids), num_groups=G,
    )
    kw = dict(half_life=None, initial_state_covariance=10.0,
              initial_state_mean=None)
    sharded = np.asarray(jax.jit(
        lambda a, b, c: solve_recursive_lanes(a, b, c, **kw)
    )(Xg, yg, vg))[:G]
    R = Xg.shape[1]
    Xe, ye, ve = _expected_group_layout(X, y, w, gids, G, R)
    single = np.asarray(solve_recursive_lanes(
        jnp.asarray(Xe), jnp.asarray(ye), jnp.asarray(ve), **kw
    ))
    np.testing.assert_allclose(sharded, single, rtol=1e-12, atol=1e-12)


_SYNC_HLO = "  %ar = f64[8,5]{1,0} all-reduce(f64[8,5]{1,0} %p), replica_groups={}"
_PAIR_HLO = """  %s = (f64[8,5]{1,0}, f64[8,5]{1,0}) all-reduce-start(f64[8,5]{1,0} %p)
  %d = f64[8,5]{1,0} all-reduce-done((f64[8,5]{1,0}, f64[8,5]{1,0}) %s)"""
_WRAPPED_HLO = """%wrapped (p: f64[8,5]) -> f64[2,5] {
  %rs = f64[2,5]{1,0} reduce-scatter(f64[8,5]{1,0} %p), dimensions={0}
}
  %a = ((f64[8,5]{1,0}), f64[2,5]{1,0}) async-start(f64[8,5]{1,0} %x), calls=%wrapped
  %b = f64[2,5]{1,0} async-done(((f64[8,5]{1,0}), f64[2,5]{1,0}) %a)"""


@pytest.mark.parametrize(
    "hlo,expected",
    [(_SYNC_HLO, 8 * 5 * 8), (_PAIR_HLO, 8 * 5 * 8), (_WRAPPED_HLO, 2 * 5 * 8)],
    ids=["sync", "start-done-pair", "async-wrapped"],
)
def test_collective_bytes_counts_each_hlo_form_once(hlo, expected):
    from polars_ols_tpu.parallel.introspect import collective_bytes

    assert collective_bytes(hlo) == expected


def test_sharded_fit_program_reads_collective_bytes():
    """The compiled sharded moments program carries its psum_scatter /
    all_gather merges, and the byte count sees them."""
    from polars_ols_tpu.parallel.introspect import last_program_collective_bytes

    X, y, gids = _grouped_data(n=512, k=3, g=16, seed=9)
    fit_moments_sharded(
        make_mesh(), jnp.asarray(X), jnp.asarray(y),
        jnp.ones(len(y), dtype=bool), jnp.asarray(gids), num_groups=16,
    )
    assert last_program_collective_bytes("fit_moments") > 0


def test_group_sharded_solver_compiles_once_per_signature():
    """Repeated group-sharded queries reuse one jitted program instead of
    tracing the solver again on every call."""
    from polars_ols_tpu.ops.moving import solve_rolling_lanes
    from polars_ols_tpu.parallel.introspect import LAST_PROGRAMS

    rng = np.random.default_rng(11)
    arrays = (jnp.asarray(rng.normal(size=(16, 40, 3))),
              jnp.asarray(rng.normal(size=(16, 40))), jnp.ones((16, 40), bool))
    kw = dict(window=8, min_periods=3, alpha=0.0, positional=True)
    first = solve_groups_sharded(make_mesh(), solve_rolling_lanes, arrays, **kw)
    program = LAST_PROGRAMS["groups_sharded"][0]
    again = solve_groups_sharded(make_mesh(), solve_rolling_lanes, arrays, **kw)
    assert LAST_PROGRAMS["groups_sharded"][0] is program
    np.testing.assert_array_equal(np.asarray(first), np.asarray(again))
