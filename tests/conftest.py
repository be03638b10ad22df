"""Test configuration: CPU backend with 8 virtual devices, fp64 enabled.

Mirrors the reference's test strategy (SURVEY.md §4) but with no hardware
requirement: the reference's tests all need a real GPU; ours run anywhere on
the JAX CPU backend (fp64 available there), and sharding tests use a virtual
8-device mesh.

Tests marked ``gpu`` need the card; they skip here. To run them on a
machine with one, name the platform and keep to one process (a JAX process
reserves most of the card's memory):

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -p no:xdist tests/
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first device, or a skip when it is not a GPU."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest -m gpu -p no:xdist tests/")
    return device
