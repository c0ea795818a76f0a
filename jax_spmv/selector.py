"""Kernel auto-selector (C6).

Re-design of ``spmv_auto_config`` (``src/spmv_cpu.cpp:34-50``) with the
reference's own GPU thresholds (``spmv_cpu.cpp:41-46``, SURVEY.md §3.5):
rows shorter than 4 on average → scalar CSR, skewness below 10 → vector
CSR, otherwise merge-path.  ``skewness = max / (min + 1)`` row length
(``csr_matrix.cpp:297``).  The thresholds have not been re-derived on the
H100 yet; the kernel types they pick map to implementations in
:mod:`jax_spmv.spmv`.  The reference's texture rule has no counterpart:
x is read through the L2 and the read-only cache on every path.
"""

from __future__ import annotations

from .csr import CSRMatrix
from .spmv import KernelType, SpMVConfig

AVG_NNZ_SCALAR_THRESHOLD = 4.0
SKEWNESS_VECTOR_THRESHOLD = 10.0


def spmv_auto_config(A: CSRMatrix) -> SpMVConfig:
    """Pick a kernel configuration from row statistics
    (reference ``spmv_auto_config``, ``spmv_cpu.cpp:34-50``)."""
    config = SpMVConfig()
    stats = A.compute_stats()
    if stats.avg_nnz_per_row < AVG_NNZ_SCALAR_THRESHOLD:
        config.kernel_type = KernelType.SCALAR_CSR
    elif stats.skewness < SKEWNESS_VECTOR_THRESHOLD:
        config.kernel_type = KernelType.VECTOR_CSR
    else:
        config.kernel_type = KernelType.MERGE_PATH
    return config
