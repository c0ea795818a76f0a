"""SpMV dispatch, configuration and result types (C12).

Re-design of the reference host entry points ``spmv_csr`` / ``spmv_ell``
(``src/spmv_kernels.cu:215-420``): validates arguments before any device
work (``spmv_kernels.cu:219-232``), dispatches on ``kernel_type``
(``:264-294``), and returns a result carrying the output vector plus
throughput metrics (``spmv.h:27-36``).  Errors come back as
``SpMVResult.error_code``, never as exceptions (the reference's no-throw
contract); a failure on the device is ``SpMVError.EXECUTION``.

Kernel types map to implementations (``SpMVResult.kernel`` names the one
that ran):

=============  ==================================  ==========
KernelType     GPU                                 CPU
=============  ==================================  ==========
SCALAR_CSR     ``flat``: gather + sorted           ``flat``
               ``segment_sum`` (kernels/scalar.py)
VECTOR_CSR     ``csr_vector``: hand-written CUDA    ``flat``
               kernel (kernels/csr_vector.cu)
MERGE_PATH     ``csr_vector``                       ``flat``
ELL_KERNEL     ``ell``: slot-major ELL              ``ell``
               (kernels/ell_kernel.py)
=============  ==================================  ==========

On an H100 the CUDA kernel was the fastest CSR candidate at the power-law,
web-graph and stencil shapes, ahead of cuSPARSE (through
``jax.experimental.sparse.BCSR``) and of ``flat`` (docs/PERF.md), so both
CSR kernel types share it; its long-row blocks take the skew that
merge-path exists for.  The CUDA kernel does not exist on the CPU, where
every CSR type runs ``flat``.  ``ELL_KERNEL`` passed to :func:`spmv_csr`
runs ``flat``.  ``block_size`` is the CUDA kernel's threads per block.

Timing: ``measure=True`` re-executes the jitted kernel in a chained loop
(:mod:`jax_spmv.timing`) to fill the time, GFLOP/s and bandwidth fields;
otherwise they stay zero.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

import jax
import jax.numpy as jnp

from .bandwidth import BandwidthMetrics, compute_bandwidth_csr, compute_bandwidth_ell
from .csr import CSRMatrix, DeviceCSR, _bucket
from .ell import DeviceELL, ELLMatrix
from .errors import SpMVError, SpMVException
from .kernels import csr_vector
from .kernels.csr_vector import VectorCSR, spmv_csr_vector
from .kernels.ell_kernel import spmv_ell_device
from .kernels.scalar import pad_x, spmv_csr_scalar
from .platform import on_gpu


class KernelType(enum.IntEnum):
    """Reference ``SpMVConfig::KernelType`` (``spmv.h:12-17``)."""

    SCALAR_CSR = 0
    VECTOR_CSR = 1
    MERGE_PATH = 2
    ELL_KERNEL = 3


@dataclasses.dataclass
class SpMVConfig:
    """Reference ``SpMVConfig`` (``spmv.h:11-24``)."""

    kernel_type: KernelType = KernelType.SCALAR_CSR
    block_size: int = 256          # CUDA threads per block (csr_vector)


@dataclasses.dataclass
class SpMVResult:
    """Reference ``SpMVResult`` (``spmv.h:27-36``) plus the name of the
    implementation that ran."""

    y: jax.Array | None = None
    elapsed_ms: float = 0.0
    gflops: float = 0.0
    bandwidth_gb_s: float = 0.0
    error_code: int = 0
    bandwidth: BandwidthMetrics | None = None
    kernel: str = ""

    def y_host(self) -> np.ndarray:
        return np.asarray(self.y) if self.y is not None else None


def spmv_validate_dimensions(num_cols: int, vec_size: int) -> bool:
    """Reference inline validator (``spmv.h:52-54``)."""
    return num_cols == vec_size


def _cols_pad(num_cols: int) -> int:
    return _bucket(max(num_cols, 1))


@jax.jit
def _flat_entry(dev: DeviceCSR, x: jax.Array) -> jax.Array:
    y = spmv_csr_scalar(dev, pad_x(x, _cols_pad(dev.num_cols)))
    return y[: dev.num_rows]


@jax.jit
def _vector_entry(plan: VectorCSR, x: jax.Array) -> jax.Array:
    return spmv_csr_vector(plan, jnp.asarray(x, jnp.float32))


@jax.jit
def _ell_entry(dev: DeviceELL, x: jax.Array) -> jax.Array:
    y = spmv_ell_device(dev, pad_x(x, _cols_pad(dev.num_cols)))
    return y[: dev.num_rows]


def _build_vector(A: CSRMatrix, config: SpMVConfig):
    key = ("csr_vector", config.block_size)
    if key not in A._plan_cache:
        csr_vector.register()
        A._plan_cache[key] = VectorCSR.build(A, config.block_size)
    return _vector_entry, (A._plan_cache[key],)


# path name -> (A, config) -> (jitted fn, args before x)
CSR_PATHS = {
    "flat": lambda A, config: (_flat_entry, (A.to_device(),)),
    "csr_vector": _build_vector,
}

_GPU_ROUTES = {KernelType.SCALAR_CSR: "flat",
               KernelType.VECTOR_CSR: "csr_vector",
               KernelType.MERGE_PATH: "csr_vector",
               KernelType.ELL_KERNEL: "flat"}
_CPU_ROUTES = {kt: "flat" for kt in KernelType}


def csr_path(kernel_type: KernelType, gpu: bool | None = None) -> str:
    """Name of the implementation ``kernel_type`` runs on this platform
    (``gpu=None`` asks :func:`jax_spmv.platform.on_gpu`)."""
    routes = _GPU_ROUTES if (on_gpu() if gpu is None else gpu) \
        else _CPU_ROUTES
    return routes[KernelType(kernel_type)]


def _resolve_csr_kernel(A: CSRMatrix, kernel_type: KernelType,
                        config: SpMVConfig | None = None):
    """``(path name, jitted fn, args before x)`` for ``kernel_type``."""
    name = csr_path(kernel_type)
    fn, args = CSR_PATHS[name](A, config or SpMVConfig())
    return name, fn, args


def _parse_x(A, x, vec_size, result: SpMVResult):
    """Reference argument checks (``spmv_kernels.cu:219-232``); returns the
    float32 x or None with ``result.error_code`` set."""
    if A is None or x is None:
        result.error_code = int(SpMVError.INVALID_ARGUMENT)
        return None
    x = jnp.asarray(x, jnp.float32)
    n = int(x.shape[0]) if x.ndim == 1 else -1
    if vec_size is None or vec_size < 0:
        vec_size = n
    if x.ndim != 1 or not spmv_validate_dimensions(A.num_cols, vec_size) \
            or vec_size != n:
        result.error_code = int(SpMVError.INVALID_DIMENSION)
        return None
    return x


def _run(result: SpMVResult, resolve, x) -> tuple | None:
    """Resolve and execute; typed and device failures become codes.  The
    call waits for the device so that its failures are reported here."""
    try:
        result.kernel, fn, args = resolve()
        result.y = jax.block_until_ready(fn(*args, x))
    except SpMVException as e:
        result.error_code = int(e.code)
        return None
    except jax.errors.JaxRuntimeError:
        result.error_code = int(SpMVError.EXECUTION)
        result.y = None
        return None
    return fn, args


def _measure(fn, args, x, iters: int, samples: int) -> float:
    from .timing import time_jitted

    return time_jitted(fn, *args, x, iters=iters, samples=samples,
                       estimator="median")


def spmv_csr(A: CSRMatrix | None, x, config: SpMVConfig | None = None,
             vec_size: int | None = None, measure: bool = False,
             measure_iters: int = 200,
             measure_samples: int = 3) -> SpMVResult:
    """``y = A @ x`` on device (reference ``spmv_csr``,
    ``spmv_kernels.cu:215-326``).

    ``measure=True`` re-executes the jitted kernel ``measure_iters`` times
    in a chained loop to fill the timing/GFLOPS/bandwidth fields
    (``measure_samples`` differenced slope pairs, median).
    """
    result = SpMVResult()
    x = _parse_x(A, x, vec_size, result)
    if x is None:
        return result
    config = config or SpMVConfig()  # nullptr → defaults, :234-237
    if A.num_rows == 0:
        result.y = jnp.zeros((0,), jnp.float32)
        return result
    ran = _run(result, lambda: _resolve_csr_kernel(
        A, KernelType(config.kernel_type), config), x)
    if ran is None or not measure:
        return result
    secs = _measure(*ran, x, measure_iters, measure_samples)
    result.elapsed_ms = secs * 1e3
    result.gflops = 2.0 * A.nnz / secs / 1e9 if secs > 0 else 0.0
    result.bandwidth = compute_bandwidth_csr(
        A.num_rows, A.num_cols, A.nnz, result.elapsed_ms)
    result.bandwidth_gb_s = result.bandwidth.achieved_gb_s
    return result


def _resolve_ell_kernel(A: ELLMatrix):
    """``(path name, jitted fn, args before x)`` for ELL: the slot-major
    kernel.  Shared by :func:`spmv_ell` and the benchmark harness."""
    return "ell", _ell_entry, (A.to_device(),)


def spmv_ell(A: ELLMatrix | None, x, config: SpMVConfig | None = None,
             vec_size: int | None = None, measure: bool = False,
             measure_iters: int = 200,
             measure_samples: int = 3) -> SpMVResult:
    """``y = A @ x`` for ELL (reference ``spmv_ell``,
    ``spmv_kernels.cu:328-420``).  ``config`` is accepted for reference
    parity; ELL has one kernel."""
    result = SpMVResult()
    x = _parse_x(A, x, vec_size, result)
    if x is None:
        return result
    if A.num_rows == 0:
        result.y = jnp.zeros((0,), jnp.float32)
        return result
    ran = _run(result, lambda: _resolve_ell_kernel(A), x)
    if ran is None or not measure:
        return result
    secs = _measure(*ran, x, measure_iters, measure_samples)
    result.elapsed_ms = secs * 1e3
    # actual-nnz GFLOPS like the reference host recount (:399-405)
    result.gflops = 2.0 * A.nnz / secs / 1e9 if secs > 0 else 0.0
    result.bandwidth = compute_bandwidth_ell(
        A.num_rows, A.num_cols, A.max_nnz_per_row, result.elapsed_ms)
    result.bandwidth_gb_s = result.bandwidth.achieved_gb_s
    return result
