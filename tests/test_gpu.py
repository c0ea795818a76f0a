"""Checks that need a CUDA GPU; each is also a phase of ``chip_smoke.py``.

They skip on the CPU (see ``conftest.py``).  On the card, in one process:
``JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/``.
"""

import numpy as np
import pytest

from jax_spmv import KernelType, SpMVConfig, spmv_csr
from jax_spmv.kernels import csr_vector
from jax_spmv.spmv import CSR_PATHS, csr_path
from jax_spmv.utils.testing import spmv_matches

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("avg", [1.5, 5.0, 14.0, 40.0])
def test_cuda_kernel_matches_oracle(rng, avg):
    """The hand-written kernel at each lane width, hub rows included."""
    A = rng.power_law_csr(3000, 5000, avg_nnz=avg, alpha=1.4)
    x = rng.vector(A.num_cols)
    fn, args = CSR_PATHS["csr_vector"](A, SpMVConfig())
    plan = args[0]
    assert plan.threads_per_row == csr_vector.threads_per_row(
        A.nnz / A.num_rows)
    y = np.asarray(fn(*args, x))
    assert spmv_matches(y, A, x, rel_tol=1e-5)


def test_cuda_kernel_is_compiled_in(rng):
    """The FFI target is registered and called; there is no interpret
    mode to fall back to."""
    A = rng.power_law_csr(500, 400, avg_nnz=8.0)
    x = rng.vector(400)
    fn, args = CSR_PATHS["csr_vector"](A, SpMVConfig())
    assert csr_vector.is_registered()
    hlo = fn.lower(*args, x).compile().as_text()
    assert f'custom_call_target="{csr_vector.TARGET}"' in hlo


def test_csr_kernel_types_run_the_cuda_kernel(rng):
    A = rng.power_law_csr(800, 600, avg_nnz=10.0)
    x = rng.vector(600)
    for kt in (KernelType.VECTOR_CSR, KernelType.MERGE_PATH):
        assert csr_path(kt) == "csr_vector"
        r = spmv_csr(A, x, SpMVConfig(kernel_type=kt))
        assert r.error_code == 0 and r.kernel == "csr_vector"
        assert spmv_matches(r.y_host(), A, x, rel_tol=1e-5)
