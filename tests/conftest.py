"""Test configuration: the CPU backend with 8 virtual devices (for the
sharding tests) and float64, set before JAX initializes.

Tests that need a GPU carry the ``gpu`` marker and skip on the CPU; on
the card run them with ``NDSM_TEST_PLATFORM=cuda python -m pytest -m gpu
tests/`` (``python chip_smoke.py`` covers the same path at full size)."""

import os
import sys

_plat = os.environ.get("NDSM_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _plat
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", _plat)
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """JAX's device 0 when it is a GPU; otherwise skip.  Decided when the
    test runs, never at import, so every worker collects the same tests."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; device 0 is {d.platform}")
    return d
