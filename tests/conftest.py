"""Test configuration: run on the CPU with 8 virtual devices so the
sharding paths are exercised without a card, and enable x64 for oracle
accuracy. An explicit JAX_PLATFORMS wins, so the card-only tests (marker
`gpu`) run with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on a
machine with a GPU; here they skip.

Must run before jax is imported anywhere in the test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REFERENCE_DATA = os.environ.get("GTO_DATA_DIR", "/root/reference/data")


@pytest.fixture(scope="session")
def data_dir():
    if not os.path.isdir(REFERENCE_DATA):
        pytest.skip("robot asset directory not available")
    return REFERENCE_DATA


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, for tests marked `gpu`: kernels compiled for the card
    have no interpret mode, so these skip wherever JAX sees no GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX sees {devices[0].platform}")
    return devices[0]
