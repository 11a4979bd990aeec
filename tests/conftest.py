"""Test configuration: the CPU backend with 8 virtual devices, so multi-device
sharding paths run without GPUs, and x64 for numerical oracles.

The CPU is always the default backend. Tests marked `gpu` take a card from
the `gpu_device` fixture and skip without one; to run them on a machine with
a GPU, add the CUDA backend after the CPU:

    JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/
"""

import os

import pytest

platforms = os.environ.get("JAX_PLATFORMS", "")
if not platforms.startswith("cpu"):
    platforms = "cpu"
os.environ["JAX_PLATFORMS"] = platforms
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", platforms)
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert jax.device_count() == 8, "expected 8 virtual CPU devices for sharding tests"

from monocular_slam_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a GPU (skips without one)")
    config.addinivalue_line("markers", "slow: long-running; excluded from tier-1")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none (decided per test, never
    at import time)."""
    try:
        return jax.devices("gpu")[0]
    except (RuntimeError, ValueError):
        pytest.skip("no GPU (on a GPU machine: JAX_PLATFORMS=cpu,cuda pytest -m gpu)")
