"""CSR format tests (C3) — mirrors ``tests/test_csr.cpp`` Properties 1-3."""

import io

import numpy as np

from jax_spmv import CSRMatrix, csr_compute_stats, csr_from_dense
from jax_spmv.utils.testing import float_arrays_equal

from conftest import PROP_ITERS


class TestCSRProperties:
    def test_property1_dense_roundtrip(self, rng):
        """Property 1: dense → CSR → dense is exact (test_csr.cpp:18-43)."""
        for _ in range(PROP_ITERS):
            rows = rng.uniform_int(1, 50)
            cols = rng.uniform_int(1, 50)
            density = rng.uniform(0.0, 0.5)
            dense = rng.dense_matrix(rows, cols, density)
            csr = csr_from_dense(dense)
            back = csr.to_dense()
            np.testing.assert_array_equal(back, dense)

    def test_property2_element_lookup(self, rng):
        """Property 2: get_element matches the dense entry
        (test_csr.cpp:47-76)."""
        for _ in range(PROP_ITERS):
            rows = rng.uniform_int(1, 30)
            cols = rng.uniform_int(1, 30)
            dense = rng.dense_matrix(rows, cols, 0.3)
            csr = csr_from_dense(dense)
            for _ in range(10):
                r = rng.uniform_int(0, rows - 1)
                c = rng.uniform_int(0, cols - 1)
                assert csr.get_element(r, c) == dense[r, c]
            # out-of-range → 0 (csr_matrix.cpp:117-120)
            assert csr.get_element(-1, 0) == 0.0
            assert csr.get_element(rows, 0) == 0.0

    def test_property3_serialization_roundtrip(self, rng, tmp_path):
        """Property 3: serialize → deserialize is identity
        (test_csr.cpp:80-127)."""
        for i in range(PROP_ITERS):
            rows = rng.uniform_int(1, 40)
            cols = rng.uniform_int(1, 40)
            dense = rng.dense_matrix(rows, cols, rng.uniform(0.05, 0.5))
            csr = csr_from_dense(dense)
            path = tmp_path / f"m{i}.bin"
            csr.serialize(path)
            back = CSRMatrix.deserialize(path)
            assert back.num_rows == csr.num_rows
            assert back.num_cols == csr.num_cols
            assert back.nnz == csr.nnz
            np.testing.assert_array_equal(back.values, csr.values)
            np.testing.assert_array_equal(back.col_indices, csr.col_indices)
            np.testing.assert_array_equal(back.row_ptrs, csr.row_ptrs)


class TestCSRBinaryLayout:
    def test_reference_byte_layout(self):
        """The serialized bytes follow the reference layout exactly
        (csr_matrix.cpp:202-230): i32{rows,cols,nnz} + f32 values +
        i32 col_indices + i32 row_ptrs, little-endian."""
        dense = np.array([[1.0, 0.0], [0.0, 2.0]], np.float32)
        csr = csr_from_dense(dense)
        buf = io.BytesIO()
        csr.serialize(buf)
        raw = buf.getvalue()
        header = np.frombuffer(raw[:12], "<i4")
        np.testing.assert_array_equal(header, [2, 2, 2])
        vals = np.frombuffer(raw[12:20], "<f4")
        np.testing.assert_array_equal(vals, [1.0, 2.0])
        cols = np.frombuffer(raw[20:28], "<i4")
        np.testing.assert_array_equal(cols, [0, 1])
        ptrs = np.frombuffer(raw[28:40], "<i4")
        np.testing.assert_array_equal(ptrs, [0, 1, 2])
        assert len(raw) == 40


class TestCSREdgeCases:
    def test_empty_matrix(self):
        # test_csr.cpp:130-137
        csr = CSRMatrix.create(0, 0, 0)
        assert csr.nnz == 0
        assert csr.to_dense().shape == (0, 0)

    def test_all_zero_matrix(self):
        # test_csr.cpp:139-151
        csr = csr_from_dense(np.zeros((5, 5), np.float32))
        assert csr.nnz == 0
        np.testing.assert_array_equal(csr.row_ptrs, np.zeros(6, np.int32))

    def test_exact_zero_detection(self):
        """Zero detection is exact float comparison (csr_matrix.cpp:58)."""
        dense = np.array([[1e-30, 0.0], [-0.0, 2.0]], np.float32)
        csr = csr_from_dense(dense)
        # -0.0 == 0.0 exactly → dropped; 1e-30 != 0.0 → kept
        assert csr.nnz == 2

    def test_sorted_columns(self, rng):
        """Columns within a row come out ascending (csr_matrix.cpp:80-93)."""
        dense = rng.dense_matrix(20, 20, 0.4)
        csr = csr_from_dense(dense)
        for i in range(20):
            lo, hi = csr.row_ptrs[i], csr.row_ptrs[i + 1]
            seg = csr.col_indices[lo:hi]
            assert np.all(np.diff(seg) > 0)


class TestCSRStats:
    def test_stats_formula(self):
        """skewness = max/(min+1) (csr_matrix.cpp:297)."""
        dense = np.zeros((4, 8), np.float32)
        dense[0, :6] = 1.0   # row len 6
        dense[1, :2] = 1.0   # row len 2
        dense[2, :1] = 1.0   # row len 1
        # row 3 empty      -> min 0
        csr = csr_from_dense(dense)
        stats = csr_compute_stats(csr)
        assert stats.max_nnz_per_row == 6
        assert stats.min_nnz_per_row == 0
        assert stats.avg_nnz_per_row == 9 / 4
        assert stats.skewness == 6.0

    def test_empty_stats(self):
        stats = csr_compute_stats(CSRMatrix.create(0, 0, 0))
        assert stats.avg_nnz_per_row == 0.0
        assert stats.min_nnz_per_row == 0

    def test_device_roundtrip(self, rng):
        """to_device → from_device preserves arrays
        (GPU round-trip analog, test_csr.cpp:168-200)."""
        dense = rng.dense_matrix(30, 30, 0.2)
        csr = csr_from_dense(dense)
        dev = csr.to_device()
        assert dev.nnz == csr.nnz
        csr2 = CSRMatrix.create(csr.num_rows, csr.num_cols, csr.nnz)
        csr2.from_device(dev)
        np.testing.assert_array_equal(csr2.values, csr.values)
        np.testing.assert_array_equal(csr2.col_indices, csr.col_indices)
        np.testing.assert_array_equal(csr2.row_ptrs, csr.row_ptrs)
        # padding invariants
        assert np.asarray(dev.values).shape[0] >= csr.nnz
        pad = np.asarray(dev.values)[csr.nnz:]
        assert float_arrays_equal(pad, np.zeros_like(pad))
