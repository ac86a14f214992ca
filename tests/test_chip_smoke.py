"""CPU tests of the GPU smoke check (chip_smoke.py) and of what it relies
on: the main-path check and its oracles at a tiny size, the refusal of a
CPU backend, the compile-cache placement, and the backend defaults."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import oracles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_headline_check_passes_at_tiny_size(capsys):
    """The headline phase, both row-order modes, against its numpy oracle."""
    chip_smoke.headline(3_000, 3, 12, seed=1, card="cpu")
    out = capsys.readouterr().out
    assert "headline materialized" in out and "headline lazy" in out
    assert "headline vs lstsq" in out


@pytest.mark.parametrize("model", ["rls", "rolling"])
def test_grouped_moving_check_passes_at_tiny_size(model):
    chip_smoke.grouped_moving(2_000, 3, 8, seed=2, card="cpu",
                              models=(model,), n_sample=3)


def test_multi_card_check_passes_on_virtual_devices(monkeypatch):
    """The four-card phase, rehearsed on the virtual CPU mesh at a small
    scale, with the lane kernels on so that the rolling fit shards."""
    from polars_ols_tpu import CONFIG

    monkeypatch.setattr(CONFIG, "_moving_lanes", True)
    chip_smoke.multi_card(seed=3, card="cpu", scale=0.002)


def test_check_rejects_an_error_above_tolerance():
    want = np.linspace(1.0, 2.0, 10)
    chip_smoke.check("same", want * (1 + 1e-12), want, 1e-9, "t", echo=False)
    with pytest.raises(AssertionError):
        chip_smoke.check("off", want * (1 + 1e-6), want, 1e-9, "t", echo=False)
    with pytest.raises(AssertionError):
        chip_smoke.check("nan", np.where(want > 1.5, np.nan, want), want,
                         1e-9, "t", echo=False)


def test_moving_oracles_match_the_suite_oracles():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 4))
    y = X.sum(axis=1) + rng.normal(size=300) * 0.1
    rls = oracles.recursive_least_squares(X, y, np.ones(300, bool), half_life=252.0)
    np.testing.assert_allclose(chip_smoke.rls_oracle(X, y, 252.0),
                               np.einsum("nk,nk->n", X, rls), rtol=1e-12)
    roll = oracles.rolling_ols_valid_window(X, y, 40)
    np.testing.assert_allclose(chip_smoke.rolling_oracle(X, y, 40),
                               np.einsum("nk,nk->n", X, roll), rtol=1e-10)


def test_enet_kkt_is_zero_at_the_optimum_and_positive_elsewhere():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(400, 6))
    y = X @ np.asarray([1.0, -2.0, 0.0, 0.0, 0.5, 3.0]) + rng.normal(size=400)
    w = oracles.elastic_net_cd(X, y, alpha=0.1, l1_ratio=0.5, max_iter=10_000,
                               tol=1e-12)
    assert chip_smoke.enet_kkt(X, y, w, 0.1, 0.5) < 1e-8
    assert chip_smoke.enet_kkt(X, y, w * 1.1, 0.1, 0.5) > 1e-2


def test_device_check_refuses_the_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()


def test_main_exits_nonzero_without_ok_line_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "no card")
    monkeypatch.setattr(chip_smoke, "run_gpu_tests", lambda: None)
    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def _cache_dir(env_cache):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache
    out = subprocess.run(
        [sys.executable, "-c",
         "import polars_ols_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_cache", [None, "given"])
def test_compile_cache_placement(env_cache, tmp_path):
    if env_cache is None:
        assert _cache_dir(None) == os.path.join(REPO, ".jax_cache")
    else:
        assert _cache_dir(str(tmp_path)) == str(tmp_path)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_backend_defaults(backend, monkeypatch):
    from polars_ols_tpu import config

    for name in ("POLS_TPU_OZAKI", "POLS_TPU_PAIR_GATHER", "POLS_TPU_MOVING_LANES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = config.Config()
    got = {k: getattr(cfg, k) for k in ("use_ozaki", "pair_gather", "moving_lanes")}
    want = {"cpu": dict(use_ozaki=False, pair_gather=False, moving_lanes=False),
            "gpu": dict(use_ozaki=True, pair_gather=False, moving_lanes=True)}
    assert got == want[backend]
    assert config.BACKEND_DEFAULTS.get(backend, {k: False for k in got}) == got
