"""Test configuration: force an 8-device CPU mesh before JAX initializes.

Multi-chip sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count), per the distributed test strategy
(SURVEY §4: "mesh-invariance" replaces the reference's SIMD-vs-generic
equality tests).

Card-only tests carry the ``gpu`` marker (pytest.ini) and take the
``gpu_backend`` fixture, which skips them unless the process's JAX
backend is a GPU.  ``python chip_smoke.py`` runs them on the card in its
own process (phase F); there a backend is already started, and this file
leaves it alone.
"""

import os

import jax
import pytest
from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    # env vars may already have been snapshotted by jax.config at import,
    # so set the config too; XLA_FLAGS is read at first backend init
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_platform_name", "cpu")
# 64-bit dtypes must survive jnp.asarray for the device-array API tests
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_backend():
    """The first GPU device; skips the test anywhere else."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on "
                    "the card (phase F runs the gpu-marked tests)")
    return jax.devices()[0]
