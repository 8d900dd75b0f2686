"""Test config: run on the CPU backend with 8 virtual devices, so the
suite runs anywhere and the sharded tests have a mesh.

Tests marked `gpu` need an NVIDIA GPU (the CUDA traversal kernel has no CPU
or interpret mode); they skip on the CPU. To run them on a card, name the
platform explicitly:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU. Decided when
    the test runs, never at import or collection."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the CUDA traversal kernel has no "
                    "CPU or interpret mode")
