"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices unless
JAX_PLATFORMS says otherwise, so it is hermetic and exercises the
multi-device sharding paths without accelerators.  Tests that need the
card carry the `gpu` marker and request the `gpu` fixture; they skip on
the CPU and run with the card reachable:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips elsewhere (see conftest)")


@pytest.fixture
def gpu():
    """The first JAX device, if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX has {dev.platform}: run with "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0x9A9)
