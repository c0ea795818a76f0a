"""Test configuration: the suite's one platform decision.

The suite runs on XLA's CPU backend with 8 virtual devices, so the
multi-device layer is tested in one process.  ``JAX_PLATFORMS`` naming
another platform (``JAX_PLATFORMS=cuda``) lets the suite run on a GPU
instead; tests marked ``gpu`` (the CUDA kernel and cuSPARSE checks, also
phases of ``chip_smoke.py``) skip unless the default device is a GPU.
Run them in one process — a JAX process reserves most of the card's
memory — e.g. ``JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist
tests/``.
"""

import os

import jax
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

from jax_spmv.utils.testing import RandomGenerator  # noqa: E402

# Property-test iteration counts: the reference's 100 for format/kernel
# properties (test_csr.cpp:10-14); device-kernel properties run 25, since
# each new shape bucket compiles a program.
PROP_ITERS = 100
DEVICE_PROP_ITERS = 25


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip tests marked ``gpu`` unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (runs on the card, see conftest)")


@pytest.fixture
def rng():
    return RandomGenerator(42)


@pytest.fixture(scope="session")
def n_devices():
    return len(jax.devices())
