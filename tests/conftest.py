"""Test harness config.

Tests run on the CPU backend with 8 virtual devices (so multi-device
sharding tests exercise a real 8-way Mesh), and with x64 enabled so the
book's 5-decimal expectations hold at the reference's f64 precision
(SURVEY.md §4). f32 behavior is covered by explicit-dtype golden tests.

RTC_TEST_PLATFORM=gpu leaves the platform to JAX instead: chip_smoke.py sets
it to run the tests marked `gpu` on the card (tests/test_gpu.py). Whether a
card is present is decided inside a fixture there, never at import.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

if os.environ.get("RTC_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent XLA compilation cache: the suite compiles ~100 distinct CPU
# programs (one per scene/dtype/tile combination — static shapes differ per
# scene), and those compiles dominate suite wall time. Cache keys include
# platform and flags, so CPU and GPU entries share the directory safely.
from rtc_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import numpy as np
import pytest


EPSILON = 1e-5


def assert_almost_eq(actual, expected, eps: float = EPSILON):
    """The reference's assert_almost_eq! macro (src/test_utils.rs:1-6)."""
    np.testing.assert_allclose(
        np.asarray(actual, dtype=np.float64),
        np.asarray(expected, dtype=np.float64),
        atol=eps,
        rtol=0,
    )


@pytest.fixture
def almost():
    return assert_almost_eq
