"""Matrix Market I/O — the framework's data loader.

The reference ships only its private binary format (``csr_matrix.cpp:
202-279``); real sparse workloads arrive as SuiteSparse ``.mtx`` files
(the benchmark configs in BASELINE.json name "SuiteSparse-style matrices").
The coordinate entries are parsed with NumPy, symmetric files are expanded,
and duplicates are summed.
"""

from __future__ import annotations

import numpy as np

from ..csr import CSRMatrix
from ..errors import FileIOError, InvalidFormatError


def mtx_read(path: str):
    """Matrix Market → (num_rows, num_cols, coo_rows, coo_cols, coo_vals),
    zero-based, symmetric files expanded."""
    try:
        f = open(path, "r")
    except OSError as e:
        raise FileIOError(str(e)) from e
    with f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise InvalidFormatError("not a MatrixMarket file")
        if "coordinate" not in header or "complex" in header:
            raise InvalidFormatError("unsupported MatrixMarket variant")
        pattern = "pattern" in header
        symmetric = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nr, nc, n = (int(v) for v in line.split()[:3])
        data = np.loadtxt(f, ndmin=2, max_rows=n) if n else \
            np.zeros((0, 3))
    if len(data) != n:
        raise InvalidFormatError("truncated MatrixMarket payload")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = np.ones(n, np.float32) if pattern else data[:, 2].astype(
        np.float32)
    if symmetric:
        off = rows != cols
        rows, cols = np.concatenate([rows, cols[off]]), \
            np.concatenate([cols, rows[off]])
        vals = np.concatenate([vals, vals[off]])
    return nr, nc, rows.astype(np.int32), cols.astype(np.int32), vals


def load_matrix_market(path: str) -> CSRMatrix:
    """Read a MatrixMarket coordinate file into a CSRMatrix.

    Supports real/integer/pattern fields and general/symmetric symmetry.
    Duplicate coordinates are summed (MatrixMarket semantics).  Columns
    within each row come out sorted ascending (matching ``from_dense``,
    ``csr_matrix.cpp:80-93``).
    """
    num_rows, num_cols, rows, cols, vals = mtx_read(path)
    row_ptrs = np.zeros(num_rows + 1, np.int32)
    if len(rows):
        # sort by (row, col) and merge duplicates
        key = rows.astype(np.int64) * num_cols + cols.astype(np.int64)
        order = np.argsort(key, kind="stable")
        key = key[order]
        vals = vals[order]
        uniq, start = np.unique(key, return_index=True)
        vals = np.add.reduceat(vals.astype(np.float64), start) \
            .astype(np.float32)
        rows = (uniq // num_cols).astype(np.int64)
        cols = (uniq % num_cols).astype(np.int32)
        np.cumsum(np.bincount(rows, minlength=num_rows), out=row_ptrs[1:])
    return CSRMatrix(num_rows, num_cols, vals, cols, row_ptrs)


def save_matrix_market(mat: CSRMatrix, path: str,
                       comment: str = "generated by jax_spmv") -> None:
    """Write a CSRMatrix as a general real coordinate MatrixMarket file."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"% {comment}\n")
        f.write(f"{mat.num_rows} {mat.num_cols} {mat.nnz}\n")
        rows = np.repeat(np.arange(mat.num_rows), np.diff(mat.row_ptrs))
        for r, c, v in zip(rows, mat.col_indices, mat.values):
            f.write(f"{r + 1} {c + 1} {v:.9g}\n")
