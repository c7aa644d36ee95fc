"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU, with the raster kernel in Pallas interpret mode;
multi-device sharding tests use xla_force_host_platform_device_count.
Tests marked ``gpu`` need the card and skip here (the ``gpu`` fixture
decides at run time).
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# Persistent compilation cache (content-addressed: an edited kernel
# lowers to different HLO and misses, an unchanged one hits).
from contrast_renderer.utils.runtime import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card: pytest -m gpu)")
    return devices[0]
