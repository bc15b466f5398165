"""Test configuration.

By default the suite runs on the CPU backend with 8 virtual devices, so
sharding is tested on a virtual mesh and no test needs a card.  Tests
marked `gpu` need an NVIDIA card: run them on one with

    NTT_TESTS_ON_GPU=1 python -m pytest -m gpu tests/

which leaves JAX on its default (GPU) platform.  Without a card they skip
with a reason; whether a card is present is decided inside the `gpu`
fixture, never while modules are imported.
"""

import os

ON_GPU = os.environ.get("NTT_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture
def gpu():
    """The first device, when it is an NVIDIA GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with NTT_TESTS_ON_GPU=1 on a "
                    "machine with a card)")
    return dev
