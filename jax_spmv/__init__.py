"""jax_spmv — sparse matrix–vector multiplication in JAX for NVIDIA GPUs.

A JAX re-design with the full capability surface of the reference CUDA
library (``LessUp/gpu-spmv``): CSR and ELL sparse formats, four SpMV kernel
types with an auto-selector, a bandwidth/GFLOPS metrics model, a
warmup/timed benchmark harness with JSON export, fully on-device PageRank,
and — new to this library — multi-device row-partitioned SpMV over a
``jax.sharding.Mesh``.
"""

from .errors import (
    DeviceException,
    FileIOError,
    InvalidArgumentError,
    InvalidDimensionError,
    InvalidFormatError,
    SpMVError,
    SpMVException,
    spmv_error_string,
)
from .buffer import DeviceBuffer
from .csr import (
    CSRMatrix,
    CSRStats,
    DeviceCSR,
    csr_compute_stats,
    csr_create,
    csr_deserialize,
    csr_from_dense,
    csr_get_element,
    csr_serialize,
    csr_to_dense,
    csr_to_device,
)
from .ell import (
    DeviceELL,
    ELLMatrix,
    ell_create,
    ell_deserialize,
    ell_from_csr,
    ell_from_dense,
    ell_get_element,
    ell_index,
    ell_serialize,
    ell_to_dense,
    ell_to_device,
)
from .ops import spmv_cpu_csr, spmv_cpu_ell
from .spmv import (
    KernelType,
    SpMVConfig,
    SpMVResult,
    spmv_csr,
    spmv_ell,
    spmv_validate_dimensions,
)
from .selector import spmv_auto_config
from .bandwidth import (
    BandwidthMetrics,
    compute_bandwidth_csr,
    compute_bandwidth_ell,
    get_peak_bandwidth,
)
from .benchmark import (
    BenchmarkConfig,
    BenchmarkResult,
    ComparisonResult,
    benchmark_csr,
    benchmark_ell,
    benchmark_from_json,
    benchmark_to_json,
    compare_device_cpu_csr,
    comparison_to_json,
)
from . import profiling
from .io import load_matrix_market
from .pagerank import (
    PageRankConfig,
    PageRankResult,
    pagerank,
    pagerank_load_state,
    pagerank_save_state,
    pagerank_top_k,
)

__version__ = "0.4.0"

__all__ = [
    "SpMVError", "SpMVException", "DeviceException", "FileIOError",
    "InvalidArgumentError", "InvalidDimensionError", "InvalidFormatError",
    "spmv_error_string",
    "DeviceBuffer",
    "CSRMatrix", "CSRStats", "DeviceCSR",
    "csr_create", "csr_from_dense", "csr_to_dense", "csr_get_element",
    "csr_to_device", "csr_serialize", "csr_deserialize", "csr_compute_stats",
    "ELLMatrix", "DeviceELL", "ell_index",
    "ell_create", "ell_from_dense", "ell_from_csr", "ell_to_dense",
    "ell_get_element", "ell_to_device", "ell_serialize", "ell_deserialize",
    "spmv_cpu_csr", "spmv_cpu_ell",
    "KernelType", "SpMVConfig", "SpMVResult",
    "spmv_csr", "spmv_ell", "spmv_validate_dimensions",
    "spmv_auto_config",
    "BandwidthMetrics", "compute_bandwidth_csr", "compute_bandwidth_ell",
    "get_peak_bandwidth",
    "BenchmarkConfig", "BenchmarkResult", "ComparisonResult",
    "benchmark_csr", "benchmark_ell", "compare_device_cpu_csr",
    "benchmark_to_json", "benchmark_from_json", "comparison_to_json",
    "PageRankConfig", "PageRankResult", "pagerank", "pagerank_top_k",
    "pagerank_save_state", "pagerank_load_state", "profiling",
    "load_matrix_market",
]
