"""Test environment: run on a virtual 8-device CPU mesh.

Must run before any module imports jax — pytest imports conftest first.
Multi-device sharding is validated on host devices
(xla_force_host_platform_device_count); the GPU path is exercised by
chip_smoke.py on the card. Tests that need a card carry the ``gpu``
marker; the ``gpu_device`` fixture decides at run time whether a card is
there and skips otherwise. On the card they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_kernels.py
"""

import os

import pytest

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips without one (see gpu_device)")


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip: decided when the test runs."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest -m gpu tests/test_gpu_kernels.py` on the card")
    return devs[0]
