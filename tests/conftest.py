"""Test harness config.

By default the suite runs on the CPU backend with a virtual 8-device mesh
(for sharding tests without several cards) and x64 enabled, so the
reference crate's f64 tolerances (e.g. |f - 0| < 1e-6 on the gamma=1e9
quadratic) are reproducible:

    python -m pytest tests/ -q

Tests marked ``gpu`` need a card and skip elsewhere; the ``gpu_devices``
fixture decides, never module import time.  Run them on a GPU machine with
the platform named explicitly (the default above would force the CPU):

    JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu -o addopts=""
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_devices():
    """The visible GPUs; skips the test when JAX found none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu on a "
                    "machine with a card")
    return devices
