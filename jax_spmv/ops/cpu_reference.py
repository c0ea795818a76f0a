"""Host (CPU) reference SpMV — the correctness oracle (C5).

Re-implements the reference golden kernels ``spmv_cpu_csr`` / ``spmv_cpu_ell``
(``src/spmv_cpu.cpp:6-32``) in NumPy.  Every device kernel's property test
compares against these at the reference tolerances (``tests/test_spmv.cu:19-35``).

Both sum each row in float32 with NumPy only, independent of the device
code under test.  (``np.add.reduce`` over a row's float32 slice sums
pairwise in blocks, not strictly left to right; comparisons with device
results therefore use the backward-error bound of
:func:`jax_spmv.utils.testing.spmv_matches`.)
"""

from __future__ import annotations

import numpy as np

from ..csr import CSRMatrix
from ..ell import ELLMatrix


def spmv_cpu_csr(A: CSRMatrix, x: np.ndarray, y: np.ndarray | None = None) -> np.ndarray:
    """y = A @ x for CSR (reference ``spmv_cpu.cpp:6-16``), one float32
    sum per row."""
    x = np.asarray(x, dtype=np.float32)
    if y is None:
        y = np.zeros(A.num_rows, np.float32)
    gathered = A.values * x[A.col_indices] if A.nnz else \
        np.zeros(0, np.float32)
    for i in range(A.num_rows):
        lo, hi = A.row_ptrs[i], A.row_ptrs[i + 1]
        y[i] = np.add.reduce(gathered[lo:hi], dtype=np.float32) if hi > lo else 0.0
    return y


def spmv_cpu_ell(A: ELLMatrix, x: np.ndarray, y: np.ndarray | None = None) -> np.ndarray:
    """y = A @ x for ELL (reference ``spmv_cpu.cpp:18-32``): k-major
    accumulation, pad slots (col < 0) skipped."""
    x = np.asarray(x, dtype=np.float32)
    if y is None:
        y = np.zeros(A.num_rows, np.float32)
    else:
        y[:] = 0.0
    if A.num_rows == 0 or A.max_nnz_per_row == 0:
        return y
    vals = A.values.reshape(A.max_nnz_per_row, A.num_rows)
    cols = A.col_indices.reshape(A.max_nnz_per_row, A.num_rows)
    for k in range(A.max_nnz_per_row):  # same k-inner order as the reference
        valid = cols[k] >= 0
        y[valid] += vals[k][valid] * x[cols[k][valid]]
    return y
