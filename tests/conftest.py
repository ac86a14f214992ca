"""Test configuration.

By default the tests run on a virtual 8-device CPU mesh: f64 is native on
the CPU, and the sharding paths run without several cards. When
``JAX_PLATFORMS`` names a GPU platform (``cuda``/``gpu``), the backend is
left to JAX, so that ``pytest -m gpu`` runs the card tests on the card.

The persistent compilation cache is off for the suite, so a test run
writes no cache into the checkout.
"""

import os

_ON_GPU = any(
    p.strip() in ("cuda", "gpu", "rocm")
    for p in os.environ.get("JAX_PLATFORMS", "").split(",")
)

if not _ON_GPU:
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
