"""Error handling foundation.

JAX re-design of the reference error layer (C1):
``include/spmv/common.h:13-23`` (``SpMVError`` enum), ``common.h:26-39``
(``spmv_error_string``), ``common.h:42-50`` (``CudaException``).

The reference is a C-style library that returns negative error codes and
provides a CUDA exception type for the RAII layer.  Idiomatic Python keeps
both contracts: the :class:`SpMVError` IntEnum carries the exact reference
code values (so serialized results / JSON stay comparable), and a typed
exception hierarchy replaces ``CudaException`` for the paths where the
reference throws.  XLA runtime failures are wrapped in
:class:`DeviceException` (the analog of ``CudaException``).
"""

from __future__ import annotations

import enum


class SpMVError(enum.IntEnum):
    """Error codes with the same numeric values as the reference enum.

    Reference: ``include/spmv/common.h:13-23``.  ``CUDA_MALLOC`` /
    ``CUDA_MEMCPY`` / ``KERNEL_LAUNCH`` are kept (same values) but here
    they mean device-allocation / host↔device-transfer / compiled-program
    failures respectively.
    """

    SUCCESS = 0
    INVALID_DIMENSION = -1
    DEVICE_ALLOC = -2       # reference: CUDA_MALLOC
    DEVICE_TRANSFER = -3    # reference: CUDA_MEMCPY
    EXECUTION = -4          # reference: KERNEL_LAUNCH
    INVALID_FORMAT = -5
    FILE_IO = -6
    OUT_OF_MEMORY = -7
    INVALID_ARGUMENT = -8


_ERROR_STRINGS = {
    SpMVError.SUCCESS: "Success",
    SpMVError.INVALID_DIMENSION: "Invalid matrix/vector dimension",
    SpMVError.DEVICE_ALLOC: "Device memory allocation failed",
    SpMVError.DEVICE_TRANSFER: "Device memory copy failed",
    SpMVError.EXECUTION: "Device program execution failed",
    SpMVError.INVALID_FORMAT: "Invalid sparse matrix format",
    SpMVError.FILE_IO: "File I/O error",
    SpMVError.OUT_OF_MEMORY: "Out of memory",
    SpMVError.INVALID_ARGUMENT: "Invalid argument",
}


def spmv_error_string(err: SpMVError | int) -> str:
    """String for an error code (reference ``common.h:26-39``)."""
    try:
        return _ERROR_STRINGS[SpMVError(err)]
    except ValueError:
        return "Unknown error"


class SpMVException(Exception):
    """Base exception; carries a :class:`SpMVError` code."""

    code: SpMVError = SpMVError.INVALID_ARGUMENT

    def __init__(self, message: str | None = None):
        super().__init__(message or spmv_error_string(self.code))


class InvalidDimensionError(SpMVException):
    code = SpMVError.INVALID_DIMENSION


class InvalidFormatError(SpMVException):
    code = SpMVError.INVALID_FORMAT


class InvalidArgumentError(SpMVException):
    code = SpMVError.INVALID_ARGUMENT


class FileIOError(SpMVException):
    code = SpMVError.FILE_IO


class DeviceException(SpMVException):
    """XLA runtime failure (analog of ``CudaException``, ``common.h:42-50``)."""

    code = SpMVError.EXECUTION

    def __init__(self, original: BaseException | str):
        self.original = original
        super().__init__(f"Device error: {original}")


class DeviceAllocError(SpMVException):
    """Device memory allocation failed (reference ``CUDA_MALLOC``; here
    an XLA RESOURCE_EXHAUSTED during upload/allocation)."""

    code = SpMVError.DEVICE_ALLOC


class DeviceTransferError(SpMVException):
    """Host↔device transfer failed (reference ``CUDA_MEMCPY``)."""

    code = SpMVError.DEVICE_TRANSFER


class OutOfMemoryError(SpMVException):
    """Host allocation failed (reference ``OUT_OF_MEMORY``)."""

    code = SpMVError.OUT_OF_MEMORY


def guarded_device_put(a, device=None):
    """``jax.device_put`` with reference-style error discrimination
    (``common.h:53-67`` checks every cudaMalloc/cudaMemcpy and maps the
    failure to a typed code; XLA surfaces both as ``JaxRuntimeError``).

    RESOURCE_EXHAUSTED / out-of-memory → :class:`DeviceAllocError`; any
    other device runtime failure during the transfer →
    :class:`DeviceTransferError`; host ``MemoryError`` →
    :class:`OutOfMemoryError`.  Non-runtime errors (bad dtype, tracer
    leaks, …) propagate unchanged — they are caller bugs, not device
    failures.
    """
    import jax

    try:
        if device is not None:
            return jax.device_put(a, device)
        return jax.device_put(a)
    except MemoryError as e:
        raise OutOfMemoryError(str(e)) from e
    except jax.errors.JaxRuntimeError as e:
        msg = str(e)
        if "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower():
            raise DeviceAllocError(msg) from e
        raise DeviceTransferError(msg) from e
