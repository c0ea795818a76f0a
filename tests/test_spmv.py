"""SpMV kernel tests (C5, C7-C12) — mirrors ``tests/test_spmv.cu``.

Property 8 is run across ALL kernel variants (the reference only exercised
SCALAR_CSR explicitly, test_spmv.cu:63-65 — SURVEY §4 flags this gap)."""

import numpy as np
import pytest

from jax_spmv import (
    KernelType,
    SpMVConfig,
    SpMVError,
    csr_from_dense,
    ell_from_dense,
    spmv_cpu_csr,
    spmv_cpu_ell,
    spmv_csr,
    spmv_ell,
    spmv_validate_dimensions,
)
from jax_spmv.utils.testing import spmv_matches, spmv_rel_equal

from conftest import DEVICE_PROP_ITERS

ALL_CSR_KERNELS = [KernelType.SCALAR_CSR, KernelType.VECTOR_CSR,
                   KernelType.MERGE_PATH]


class TestCPUReference:
    def test_known_example(self):
        """The README 3x3 example (README.md:67-102)."""
        dense = np.array([[1, 0, 2], [0, 3, 0], [4, 0, 5]], np.float32)
        csr = csr_from_dense(dense)
        x = np.array([1.0, 2.0, 3.0], np.float32)
        y = spmv_cpu_csr(csr, x)
        np.testing.assert_allclose(y, [7.0, 6.0, 19.0])

    def test_cpu_ell_matches_csr(self, rng):
        for _ in range(20):
            dense = rng.dense_matrix(rng.uniform_int(1, 30),
                                     rng.uniform_int(1, 30), 0.3)
            csr = csr_from_dense(dense)
            ell = ell_from_dense(dense)
            x = rng.vector(csr.num_cols)
            assert spmv_rel_equal(spmv_cpu_ell(ell, x), spmv_cpu_csr(csr, x))


class TestProperty8DeviceVsCPU:
    """Property 8: device SpMV matches CPU reference at 1e-6 rel
    (test_spmv.cu:40-78), for every kernel variant."""

    @pytest.mark.parametrize("kernel_type", ALL_CSR_KERNELS)
    def test_csr_kernels(self, rng, kernel_type):
        for it in range(DEVICE_PROP_ITERS):
            if it % 5 == 4:
                # cross the 1024-element padding buckets of rows, cols
                # and nnz that small dims never touch
                rows = rng.uniform_int(2049, 5000)
                cols = rng.uniform_int(1025, 3000)
                csr = rng.power_law_csr(rows, cols, avg_nnz=4.0)
            else:
                rows = rng.uniform_int(1, 80)
                cols = rng.uniform_int(1, 80)
                dense = rng.dense_matrix(rows, cols,
                                         rng.uniform(0.05, 0.5))
                csr = csr_from_dense(dense)
            x = rng.vector(cols)
            cfg = SpMVConfig(kernel_type=kernel_type)
            res = spmv_csr(csr, x, cfg)
            assert res.error_code == 0
            assert spmv_matches(res.y_host(), csr, x), \
                f"{kernel_type.name} mismatch rows={rows} cols={cols}"

    def test_large_skewed(self, rng):
        """Merge-path on a power-law matrix (requirements.md:68 regime)."""
        csr = rng.power_law_csr(300, 300, avg_nnz=6.0)
        x = rng.vector(300)
        for kt in ALL_CSR_KERNELS:
            res = spmv_csr(csr, x, SpMVConfig(kernel_type=kt))
            assert res.error_code == 0
            assert spmv_matches(res.y_host(), csr, x, rel_tol=1e-5), kt.name


class TestProperty9ELL:
    """Property 9: ELL device kernel vs CPU (test_spmv.cu:82-118)."""

    def test_ell_device(self, rng):
        for _ in range(DEVICE_PROP_ITERS):
            rows = rng.uniform_int(1, 60)
            cols = rng.uniform_int(1, 60)
            dense = rng.dense_matrix(rows, cols, rng.uniform(0.05, 0.4))
            ell = ell_from_dense(dense)
            x = rng.vector(cols)
            expected = spmv_cpu_ell(ell, x)
            res = spmv_ell(ell, x)
            assert res.error_code == 0
            # XLA's slot-axis reduction may sum in another order than the
            # oracle's slot loop — compare with the reordered-summation
            # backward-error bound (see spmv_matches docstring)
            assert spmv_matches(res.y_host(), ell.to_csr(), x, rel_tol=1e-5)
            assert spmv_rel_equal(res.y_host(), expected, rel_tol=1e-3)


class TestProperty10DimensionValidation:
    """Property 10: dimension mismatches rejected before device work
    (test_spmv.cu:122-145, spmv_kernels.cu:219-232)."""

    def test_validate_dimensions(self):
        assert spmv_validate_dimensions(5, 5)
        assert not spmv_validate_dimensions(5, 4)

    def test_mismatched_x(self, rng):
        csr = csr_from_dense(rng.dense_matrix(10, 10, 0.3))
        res = spmv_csr(csr, rng.vector(7))
        assert res.error_code == int(SpMVError.INVALID_DIMENSION)
        assert res.y is None

    def test_null_arguments(self):
        res = spmv_csr(None, np.ones(3, np.float32))
        assert res.error_code == int(SpMVError.INVALID_ARGUMENT)
        csr = csr_from_dense(np.eye(3, dtype=np.float32))
        res = spmv_csr(csr, None)
        assert res.error_code == int(SpMVError.INVALID_ARGUMENT)

    def test_explicit_vec_size(self, rng):
        csr = csr_from_dense(rng.dense_matrix(8, 8, 0.3))
        res = spmv_csr(csr, rng.vector(8), vec_size=9)
        assert res.error_code == int(SpMVError.INVALID_DIMENSION)


class TestEdgeCases:
    def test_empty_matrix(self):
        # test_spmv.cu:148-159
        csr = csr_from_dense(np.zeros((0, 0), np.float32))
        res = spmv_csr(csr, np.zeros(0, np.float32))
        assert res.error_code == 0
        assert res.y_host().shape == (0,)

    def test_single_element(self):
        # test_spmv.cu:161-186
        csr = csr_from_dense(np.array([[3.0]], np.float32))
        for kt in ALL_CSR_KERNELS:
            res = spmv_csr(csr, np.array([2.0], np.float32),
                           SpMVConfig(kernel_type=kt))
            assert res.error_code == 0
            np.testing.assert_allclose(res.y_host(), [6.0])

    def test_zero_rows_inside(self, rng):
        # test_spmv.cu:188-218: rows with no nnz produce y = 0
        dense = rng.dense_matrix(10, 10, 0.4)
        dense[3, :] = 0.0
        dense[7, :] = 0.0
        csr = csr_from_dense(dense)
        x = rng.vector(10)
        for kt in ALL_CSR_KERNELS:
            res = spmv_csr(csr, x, SpMVConfig(kernel_type=kt))
            y = res.y_host()
            assert y[3] == 0.0 and y[7] == 0.0

    def test_all_zero_matrix(self, rng):
        csr = csr_from_dense(np.zeros((5, 5), np.float32))
        for kt in ALL_CSR_KERNELS:
            res = spmv_csr(csr, rng.vector(5), SpMVConfig(kernel_type=kt))
            np.testing.assert_array_equal(res.y_host(), np.zeros(5))

    def test_measure_fills_metrics(self, rng):
        csr = csr_from_dense(rng.dense_matrix(32, 32, 0.2))
        res = spmv_csr(csr, rng.vector(32), measure=True, measure_iters=2)
        assert res.elapsed_ms > 0.0
        assert res.gflops >= 0.0
        assert res.bandwidth is not None
        assert res.bandwidth.achieved_gb_s > 0.0
        # a device without a published peak (the CPU) gets no efficiency
        from jax_spmv import get_peak_bandwidth

        peak = get_peak_bandwidth()
        assert res.bandwidth.theoretical_gb_s == peak
        assert (res.bandwidth.efficiency is None) == (peak is None)


def _shape(rng, kind):
    """Small matrices of the structure classes the dispatch must serve."""
    from jax_spmv.csr import CSRMatrix

    if kind == "power_law":
        return rng.power_law_csr(700, 500, avg_nnz=9.0, alpha=1.6)
    if kind == "banded":
        n = 600
        dense = np.zeros((n, n), np.float32)
        for off in (-3, -1, 0, 2, 5):
            idx = np.arange(max(0, -off), min(n, n - off))
            dense[idx, idx + off] = rng.uniform(0.5, 2.0)
        return csr_from_dense(dense)
    if kind == "iid":
        return rng.csr(300, 400, density=0.03)
    if kind == "empty_rows":
        dense = rng.dense_matrix(200, 150, 0.1)
        dense[::3] = 0.0
        dense[-1] = 0.0
        return csr_from_dense(dense)
    if kind == "single_column":
        return csr_from_dense(rng.dense_matrix(257, 1, 0.7))
    if kind == "unaligned":     # every dimension just past a 1024 bucket
        return rng.power_law_csr(1025, 1027, avg_nnz=2.5, alpha=1.6)
    if kind == "hub_row":       # one row far longer than the rest
        A = rng.power_law_csr(400, 3000, avg_nnz=3.0, alpha=2.5)
        lens = np.diff(A.row_ptrs)
        lens[7] = 3000
        ptr = np.zeros(401, np.int64)
        np.cumsum(lens, out=ptr[1:])
        cols = np.concatenate([np.sort(rng.rng.choice(3000, int(k), False))
                               for k in lens]).astype(np.int32)
        return CSRMatrix(400, 3000, rng.rng.uniform(-1, 1, int(ptr[-1])),
                         cols, ptr)
    raise ValueError(kind)


SHAPES = ["power_law", "banded", "iid", "empty_rows", "single_column",
          "unaligned", "hub_row"]
CONFIGS = ["scalar_csr", "vector_csr", "merge_path", "ell_kernel", "auto"]


@pytest.mark.parametrize("kind", SHAPES)
@pytest.mark.parametrize("label", CONFIGS)
def test_dispatch_matches_oracle(rng, kind, label):
    """Every kernel type and the auto config against the NumPy oracle."""
    from jax_spmv import spmv_auto_config

    A = _shape(rng, kind)
    x = rng.vector(A.num_cols)
    cfg = spmv_auto_config(A) if label == "auto" else \
        SpMVConfig(kernel_type=KernelType[label.upper()])
    res = spmv_csr(A, x, cfg)
    assert res.error_code == 0
    assert res.kernel
    assert res.y_host().shape == (A.num_rows,)
    assert spmv_matches(res.y_host(), A, x, rel_tol=1e-5), (kind, label)
