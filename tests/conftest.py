"""Test environment setup.

Tests run on the CPU backend by default — Pallas kernels in interpret
mode, the documented test path (tpujpeg.backend) — with 8 virtual
devices so the distributed paths (SURVEY.md §4 "Distributed" row)
exercise real shard_map sharding. Tests that need the GPU take the `gpu`
fixture and carry the `gpu` marker; they skip on the CPU and run on the
card with `TPUJPEG_TEST_DEVICE=gpu python -m pytest -m gpu tests/`.
"""

import os

import pytest

if os.environ.get("TPUJPEG_TEST_DEVICE", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skips elsewhere"
    )


@pytest.fixture
def gpu():
    """Skips unless JAX's default backend is a GPU — decided when the
    test runs, never at import (xdist workers must collect one list)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled kernels have no CPU form")


@pytest.fixture(scope="session")
def rng():
    import numpy as np

    return np.random.default_rng(1234)
