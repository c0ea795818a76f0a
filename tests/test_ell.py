"""ELL format tests (C4) — mirrors ``tests/test_ell.cpp`` Properties 4-7."""

import io

import numpy as np

from jax_spmv import ELLMatrix, csr_from_dense, ell_from_csr, ell_from_dense, ell_index

from conftest import PROP_ITERS


class TestELLProperties:
    def test_property4_dense_roundtrip(self, rng):
        """Property 4: dense → ELL → dense is exact (test_ell.cpp:19-44)."""
        for _ in range(PROP_ITERS):
            rows = rng.uniform_int(1, 40)
            cols = rng.uniform_int(1, 40)
            dense = rng.dense_matrix(rows, cols, rng.uniform(0.0, 0.5))
            ell = ell_from_dense(dense)
            np.testing.assert_array_equal(ell.to_dense(), dense)

    def test_property5_padding(self, rng):
        """Property 5: pad slots have col = -1, value = 0
        (test_ell.cpp:48-80, ell_matrix.cpp:23-27)."""
        for _ in range(PROP_ITERS // 2):
            rows = rng.uniform_int(1, 30)
            cols = rng.uniform_int(1, 30)
            dense = rng.dense_matrix(rows, cols, 0.2)
            ell = ell_from_dense(dense)
            pad_mask = ell.col_indices < 0
            np.testing.assert_array_equal(ell.col_indices[pad_mask], -1)
            np.testing.assert_array_equal(ell.values[pad_mask], 0.0)
            # max_nnz_per_row is the densest row's count
            row_nnz = (dense != 0).sum(axis=1)
            assert ell.max_nnz_per_row == int(row_nnz.max(initial=0))

    def test_property6_column_major_layout(self, rng):
        """Property 6: values[k*num_rows + row] layout
        (test_ell.cpp:84-108, ell_matrix.h:64-66)."""
        dense = rng.dense_matrix(10, 10, 0.5)
        ell = ell_from_dense(dense)
        for r in range(10):
            row_vals = dense[r][dense[r] != 0]
            for k in range(len(row_vals)):
                idx = ell_index(r, k, ell.num_rows)
                assert idx == k * ell.num_rows + r
                assert ell.values[idx] == row_vals[k]

    def test_property7_serialization_roundtrip(self, rng, tmp_path):
        """Property 7 (test_ell.cpp:112-150)."""
        for i in range(PROP_ITERS // 2):
            rows = rng.uniform_int(1, 30)
            cols = rng.uniform_int(1, 30)
            dense = rng.dense_matrix(rows, cols, rng.uniform(0.05, 0.5))
            ell = ell_from_dense(dense)
            path = tmp_path / f"e{i}.bin"
            ell.serialize(path)
            back = ELLMatrix.deserialize(path)
            assert back.num_rows == ell.num_rows
            assert back.num_cols == ell.num_cols
            assert back.max_nnz_per_row == ell.max_nnz_per_row
            np.testing.assert_array_equal(back.values, ell.values)
            np.testing.assert_array_equal(back.col_indices, ell.col_indices)

    def test_csr_to_ell(self, rng):
        """CSR → ELL equivalence (test_ell.cpp:153-172)."""
        for _ in range(PROP_ITERS // 2):
            rows = rng.uniform_int(1, 30)
            cols = rng.uniform_int(1, 30)
            dense = rng.dense_matrix(rows, cols, 0.3)
            csr = csr_from_dense(dense)
            ell = ell_from_csr(csr)
            np.testing.assert_array_equal(ell.to_dense(), dense)


class TestELLBinaryLayout:
    def test_reference_byte_layout(self):
        """Reference serialized layout (ell_matrix.cpp:254-280)."""
        dense = np.array([[1.0, 2.0], [3.0, 0.0]], np.float32)
        ell = ell_from_dense(dense)
        assert ell.max_nnz_per_row == 2
        buf = io.BytesIO()
        ell.serialize(buf)
        raw = buf.getvalue()
        header = np.frombuffer(raw[:12], "<i4")
        np.testing.assert_array_equal(header, [2, 2, 2])
        vals = np.frombuffer(raw[12:28], "<f4")
        # column-major: slot0 rows {1,3}, slot1 rows {2, pad}
        np.testing.assert_array_equal(vals, [1.0, 3.0, 2.0, 0.0])
        cols = np.frombuffer(raw[28:44], "<i4")
        np.testing.assert_array_equal(cols, [0, 0, 1, -1])


class TestELLEdgeCases:
    def test_empty(self):
        ell = ELLMatrix.create(0, 0, 0)
        assert ell.to_dense().shape == (0, 0)

    def test_get_element(self, rng):
        dense = rng.dense_matrix(12, 12, 0.4)
        ell = ell_from_dense(dense)
        for r in range(12):
            for c in range(12):
                assert ell.get_element(r, c) == dense[r, c]

    def test_device_form(self, rng):
        dense = rng.dense_matrix(20, 15, 0.3)
        ell = ell_from_dense(dense)
        dev = ell.to_device()
        v = np.asarray(dev.values)
        c = np.asarray(dev.col_indices)
        assert v.shape[0] == max(ell.max_nnz_per_row, 1)
        assert v.shape[1] >= ell.num_rows
        # device padding keeps the col=-1/val=0 convention
        assert np.all(c[:, ell.num_rows:] == -1)
        np.testing.assert_array_equal(
            v[:, : ell.num_rows].reshape(-1),
            ell.values.reshape(ell.max_nnz_per_row, ell.num_rows).reshape(-1))
