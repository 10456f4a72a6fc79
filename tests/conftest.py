"""Test harness: run JAX on a virtual 8-device CPU mesh.

Multi-chip sharding is validated on host CPU devices
(xla_force_host_platform_device_count); the accelerator path is driven by
chip_smoke.py on a GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
