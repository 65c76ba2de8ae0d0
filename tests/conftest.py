"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The JAX computations here are platform-independent integer programs, so
the suite runs on the CPU with 8 virtual devices, which also exercises
the multi-device sharding paths.  Tests that need the card carry the
``gpu`` marker and skip here; ``python chip_smoke.py`` runs them on one.
"""

import os

# The host-device-count flag must be set before the first backend
# initialization.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import random

import numpy as np
import pytest

import jax

if os.environ.get("MIDNIGHT_TEST_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

# NO persistent compilation cache for the CPU suite: XLA:CPU executable
# serialization has segfaulted intermittently mid-suite
# (put_executable_and_time/executable.serialize and
# backend_compile_and_load); correctness > reruns.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def rng():
    return random.Random(0xB15)


@pytest.fixture
def nprng():
    return np.random.default_rng(0xB15)


@pytest.fixture
def gpu():
    """The GPU a ``gpu``-marked test runs on; skips when there is none
    (decided here, at run time — never while a module is imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; default device is {dev.platform}")
    return dev
