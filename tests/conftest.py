"""Test configuration: run on CPU with 8 virtual devices so the sharding /
multi-device paths are exercised without a GPU.

Tests marked ``gpu`` need a card: they skip here, and run on a GPU host
with ``LDPC_TESTS_ON_GPU=1 python -m pytest tests -m gpu`` (that variable
leaves the platform to JAX instead of forcing the CPU)."""

import os

# jax is already imported by a pytest plugin by the time conftest runs, so
# plain env vars are too late for platform selection — but the backend is not
# initialized yet, so jax.config still takes effect. XLA_FLAGS is read at
# backend init, so the env var works for the virtual device count.
_ON_GPU = os.environ.get("LDPC_TESTS_ON_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

import ldpc_tpu


@pytest.fixture(scope="session")
def test_code():
    """The (7,4) universal fixture (reference ldpc_decoder.py:274-284)."""
    return ldpc_tpu.create_test_ldpc_code()


@pytest.fixture(scope="session")
def test_graph(test_code):
    return ldpc_tpu.build_graph(test_code)


@pytest.fixture(scope="session")
def mid_code():
    """A mid-size irregular code for statistical tests."""
    return ldpc_tpu.create_peg_code(n=128, m=64, dv=3, seed=1,
                                    max_iterations=20)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none (decided when
    the test runs, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with LDPC_TESTS_ON_GPU=1 "
                    "on a GPU host)")
    return dev
