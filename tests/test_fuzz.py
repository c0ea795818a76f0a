"""Differential fuzz of the dispatch paths: adversarial structures through
the public dispatch, the flat CSR path, the ELL kernel and the CUDA
kernel's NumPy model, each against the oracle."""

import numpy as np
import pytest

from jax_spmv import KernelType, SpMVConfig, spmv_csr, spmv_ell
from jax_spmv.csr import CSRMatrix
from jax_spmv.ell import ELLMatrix
from jax_spmv.kernels import csr_vector
from jax_spmv.spmv import CSR_PATHS
from jax_spmv.utils.testing import spmv_matches

KINDS = ["uniform_block", "hub_row", "hub_column", "diagonal_band",
         "row_chunk"]


def _matrix(rng, kind, rows, cols):
    m = np.zeros((rows, cols), np.float32)
    if kind == "uniform_block":
        rr, cc = min(rows, 200), min(cols, 200)
        m[:rr, :cc] = (rng.random((rr, cc)) < 0.1) * rng.uniform(-5, 5)
    elif kind == "hub_row":
        m[rng.integers(0, rows), :] = rng.uniform(-1, 1, cols)
    elif kind == "hub_column":
        m[:, rng.integers(0, cols)] = rng.uniform(-1, 1, rows)
    elif kind == "diagonal_band":
        for i in range(rows):
            j = int(i * cols / max(rows, 1))
            for dj in (-1, 0, 1):
                if 0 <= j + dj < cols:
                    m[i, j + dj] = 1.0 + i * 0.001
    else:              # one row holding a contiguous chunk
        c0 = int(rng.integers(0, max(cols - 100, 1)))
        m[rng.integers(0, rows), c0:c0 + min(100, cols - c0)] = 2.0
    return CSRMatrix.from_dense(m)


@pytest.mark.parametrize("kind", KINDS)
def test_dispatch_fuzz(rng, kind):
    """Random shapes (half of them past a 1024-element padding bucket)
    and random kernel types; every CSR path agrees with the oracle."""
    r = rng.rng
    for trial in range(6):
        if trial % 2 == 0:
            rows, cols = int(r.integers(1025, 2500)), int(r.integers(1025, 2000))
        else:
            rows, cols = int(r.integers(1, 600)), int(r.integers(1, 900))
        A = _matrix(r, kind, rows, cols)
        x = r.uniform(-3, 3, cols).astype(np.float32)
        kt = KernelType(int(r.integers(0, 4)))
        res = spmv_csr(A, x, SpMVConfig(kernel_type=kt))
        assert res.error_code == 0
        assert spmv_matches(res.y_host(), A, x, rel_tol=1e-5), \
            (trial, kind, rows, cols, kt)
        fn, args = CSR_PATHS["flat"](A, SpMVConfig())
        assert spmv_matches(np.asarray(fn(*args, x)), A, x,
                            rel_tol=1e-5), (trial, kind, "flat")


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_model_fuzz(rng, kind):
    """The CUDA kernel's sums (NumPy model) with the width and long-row
    threshold the wrapper picks, and with random ones."""
    r = rng.rng
    for trial in range(4):
        rows, cols = int(r.integers(1, 1500)), int(r.integers(1, 1500))
        A = _matrix(r, kind, rows, cols)
        x = r.uniform(-3, 3, cols).astype(np.float32)
        if trial % 2 == 0:
            tpr = csr_vector.threads_per_row(A.nnz / max(A.num_rows, 1))
            thr = csr_vector.long_row_threshold(tpr)
        else:
            tpr = int(2 ** r.integers(0, 6))
            thr = int(r.integers(0, 300))
        block = int(32 * r.integers(1, 33))
        y = csr_vector.spmv_csr_vector_reference(A, x, tpr, thr, block)
        assert spmv_matches(y, A, x, rel_tol=1e-5), \
            (trial, kind, tpr, thr, block)


def test_ell_fuzz(rng):
    """ELL built from every fuzz structure, through spmv_ell."""
    r = rng.rng
    for trial in range(10):
        rows, cols = int(r.integers(1, 1200)), int(r.integers(1, 800))
        A = _matrix(r, KINDS[trial % len(KINDS)], rows, cols)
        x = r.uniform(-3, 3, cols).astype(np.float32)
        res = spmv_ell(ELLMatrix.from_csr(A), x)
        assert res.error_code == 0
        assert spmv_matches(res.y_host(), A, x, rel_tol=1e-5), trial
