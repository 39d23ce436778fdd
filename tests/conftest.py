"""Test configuration: CPU JAX with a fake 8-device mesh, unless a host
process (chip_smoke.py) already started JAX on its accelerator.

--xla_force_host_platform_device_count=8 gives shard_map a real 8-device
mesh on the host (SURVEY.md §4.5). Both settings must land before JAX
starts a backend. chip_smoke.py runs the GPU-marked tests inside its own
process, whose JAX already holds the card; there nothing is overridden.
Whether a card is present is decided per test, in the ``gpu`` fixture.
"""

import os
import sys


def _jax_started() -> bool:
    if "jax" not in sys.modules:
        return False
    from jax._src import xla_bridge
    return xla_bridge.backends_are_initialized()


if not _jax_started():
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("JAX_ENABLE_CHECKS", "true")
    import jax

    jax.config.update("jax_platforms", "cpu")
    # The suite is compile-bound (one fused frame program per
    # RenderConfig): keep compiled programs across runs.
    from tpurt.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (tests/test_gpu.py; run on the
    card by chip_smoke.py, phase 6)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev
