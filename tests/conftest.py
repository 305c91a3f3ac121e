"""Test session config.

Tier 0/2 strategy from SURVEY.md §5: run the suite on the CPU backend with
8 virtual devices (``--xla_force_host_platform_device_count=8``) so the
sharding tests are deterministic and cluster-free, and enable x64 so the
scipy/numpy oracle comparisons are exact-GP-math tight.

Tests marked ``gpu`` need a card: they take the ``gpu_device`` fixture,
which skips them when JAX finds none.  Run them on a GPU host with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's device 0 is {dev.platform!r}")
    return dev
