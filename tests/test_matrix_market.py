"""Matrix Market loader (``jax_spmv.io``)."""

import numpy as np
import pytest

from jax_spmv.errors import FileIOError, InvalidFormatError
from jax_spmv.io import load_matrix_market, save_matrix_market


def _write(path, text):
    path.write_text(text)
    return str(path)


def test_roundtrip(rng, tmp_path):
    A = rng.csr(23, 17, density=0.2)
    path = str(tmp_path / "a.mtx")
    save_matrix_market(A, path)
    B = load_matrix_market(path)
    assert (B.num_rows, B.num_cols, B.nnz) == (23, 17, A.nnz)
    np.testing.assert_array_equal(B.row_ptrs, A.row_ptrs)
    np.testing.assert_array_equal(B.col_indices, A.col_indices)
    np.testing.assert_allclose(B.values, A.values, rtol=1e-7)


def test_symmetric_expands_and_duplicates_sum(tmp_path):
    path = _write(tmp_path / "s.mtx", "%%MatrixMarket matrix coordinate real "
                  "symmetric\n% c\n3 3 4\n1 1 2.0\n3 1 5.0\n2 2 1.0\n2 2 1.5\n")
    A = load_matrix_market(path)
    np.testing.assert_allclose(A.to_dense(), [[2, 0, 5], [0, 2.5, 0],
                                              [5, 0, 0]])


def test_pattern_field_reads_ones(tmp_path):
    path = _write(tmp_path / "p.mtx", "%%MatrixMarket matrix coordinate "
                  "pattern general\n2 4 3\n1 4\n2 1\n1 2\n")
    A = load_matrix_market(path)
    np.testing.assert_array_equal(A.to_dense(), [[0, 1, 0, 1], [1, 0, 0, 0]])
    np.testing.assert_array_equal(A.col_indices, [1, 3, 0])  # sorted rows


def test_empty_matrix(tmp_path):
    path = _write(tmp_path / "e.mtx", "%%MatrixMarket matrix coordinate "
                  "real general\n4 5 0\n")
    A = load_matrix_market(path)
    assert (A.num_rows, A.num_cols, A.nnz) == (4, 5, 0)
    np.testing.assert_array_equal(A.row_ptrs, np.zeros(5))


@pytest.mark.parametrize("text", [
    "not a matrix\n1 1 1\n1 1 1.0\n",
    "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n",
])
def test_bad_files_rejected(tmp_path, text):
    with pytest.raises(InvalidFormatError):
        load_matrix_market(_write(tmp_path / "bad.mtx", text))


def test_missing_file(tmp_path):
    with pytest.raises(FileIOError):
        load_matrix_market(str(tmp_path / "none.mtx"))
