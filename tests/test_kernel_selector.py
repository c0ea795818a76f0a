"""Selector tests (C6) — mirrors ``tests/test_kernel_selector.cpp``."""

import numpy as np

from jax_spmv import KernelType, csr_from_dense, spmv_auto_config
from jax_spmv.selector import (
    AVG_NNZ_SCALAR_THRESHOLD,
    SKEWNESS_VECTOR_THRESHOLD,
)

from conftest import PROP_ITERS


class TestProperty11Validity:
    """Property 11: the selector always returns a valid config
    (test_kernel_selector.cpp:17-50)."""

    def test_always_valid(self, rng):
        for _ in range(PROP_ITERS):
            rows = rng.uniform_int(1, 60)
            cols = rng.uniform_int(1, 60)
            csr = csr_from_dense(rng.dense_matrix(rows, cols,
                                                  rng.uniform(0.0, 0.6)))
            cfg = spmv_auto_config(csr)
            assert cfg.kernel_type in (KernelType.SCALAR_CSR,
                                       KernelType.VECTOR_CSR,
                                       KernelType.MERGE_PATH)
            assert cfg.block_size > 0


def _csr_with_row_lengths(lengths, cols):
    """Build a CSR with exact per-row nnz counts."""
    rows = len(lengths)
    dense = np.zeros((rows, cols), np.float32)
    for i, length in enumerate(lengths):
        dense[i, :length] = 1.0
    return csr_from_dense(dense)


class TestHeuristicBranches:
    """One unit test per branch (test_kernel_selector.cpp:53-118)."""

    def test_sparse_rows_pick_scalar(self):
        # short rows (avg < 4): one thread per row -> scalar CSR
        csr = _csr_with_row_lengths([3] * 64, 64)
        assert csr.compute_stats().avg_nnz_per_row < AVG_NNZ_SCALAR_THRESHOLD
        assert spmv_auto_config(csr).kernel_type == KernelType.SCALAR_CSR

    def test_uniform_rows_pick_vector(self):
        csr = _csr_with_row_lengths([8] * 64, 64)
        stats = csr.compute_stats()
        assert stats.avg_nnz_per_row >= AVG_NNZ_SCALAR_THRESHOLD
        assert stats.skewness < SKEWNESS_VECTOR_THRESHOLD
        assert spmv_auto_config(csr).kernel_type == KernelType.VECTOR_CSR

    def test_skewed_rows_pick_merge_path(self):
        lengths = [1] * 63 + [512]
        csr = _csr_with_row_lengths(lengths, 512)
        stats = csr.compute_stats()
        assert stats.skewness >= SKEWNESS_VECTOR_THRESHOLD
        assert stats.avg_nnz_per_row >= AVG_NNZ_SCALAR_THRESHOLD
        assert spmv_auto_config(csr).kernel_type == KernelType.MERGE_PATH

    def test_reference_thresholds(self):
        """The reference's GPU constants (spmv_cpu.cpp:41-46)."""
        assert AVG_NNZ_SCALAR_THRESHOLD == 4.0
        assert SKEWNESS_VECTOR_THRESHOLD == 10.0

    def test_avg_boundary_is_exclusive(self):
        """avg == 4 is not 'sparse': the scalar branch needs avg < 4."""
        csr = _csr_with_row_lengths([4] * 32, 64)
        assert spmv_auto_config(csr).kernel_type == KernelType.VECTOR_CSR

    def test_skew_boundary_is_exclusive(self):
        """skew == 10 goes to merge-path: the vector branch needs < 10."""
        csr = _csr_with_row_lengths([4] * 31 + [50], 64)
        assert csr.compute_stats().skewness == 10.0
        assert spmv_auto_config(csr).kernel_type == KernelType.MERGE_PATH
