"""Test config: force an 8-device CPU mesh so sharding tests run anywhere,
and interpret the Pallas kernel.

The reference has no test suite (SURVEY.md §4); its correctness gate is
oracle-parity on every run. Here pytest is the gate, and multi-chip paths are
exercised on virtual CPU devices per the standard JAX recipe.
"""
import os

# Must be set before jax import.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The fold kernel is a Triton-route Pallas kernel: here on the CPU it runs
# under the Pallas interpreter (config.pallas_interpret).
os.environ["TAHOE_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) >= 8, "CPU device forcing failed"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tahoe_tpu.forest import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def small_forest():
    return synthetic.generate_forest(17, 4, 9, leaf_prob=0.2, seed=3)


@pytest.fixture(scope="session")
def small_data():
    return synthetic.generate_data(64, 9, missing_prob=0.1, seed=4)
