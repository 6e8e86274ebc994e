"""Test harness config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on XLA's host platform with 8 virtual
devices, so the suite runs anywhere; real-card checks are the tests marked
``gpu`` (and chip_smoke.py / bench.py).

``LMVN_TEST_DEVICE=gpu`` keeps JAX's default platform instead, for the one
invocation that runs the ``gpu``-marked tests on a card:

    LMVN_TEST_DEVICE=gpu python -m pytest tests/ -m gpu

Whether a card is present is decided inside the ``gpu_device`` fixture,
never while a module is imported, so every xdist worker collects the same
tests.
"""

import os

import jax

if os.environ.get("LMVN_TEST_DEVICE") != "gpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1308)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's default device is {dev.platform})")
    return dev
