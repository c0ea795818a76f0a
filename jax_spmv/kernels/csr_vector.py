"""Hand-written vector CSR kernel for Hopper, called through ``jax.ffi``.

Route: CUDA C++ (``csr_vector.cu``) compiled by ``nvcc`` for ``sm_90a``
and registered as an XLA FFI target.  It has no interpret mode, so the CPU
tests reach the Python around it (group width, long-row split, shapes) and
:func:`spmv_csr_vector_reference`, a NumPy model of the kernel's sums.

Build: ``python -m jax_spmv.kernels.csr_vector`` compiles the library into
``build/`` at the root of the checkout (listed in ``.gitignore``);
:func:`register`, called by the dispatch before the kernel's first use,
does the same when the library is missing or older than its source.
``nvcc`` is found on ``PATH`` or under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np

import jax
import jax.numpy as jnp

from ..csr import CSRMatrix, DeviceCSR

TARGET = "jax_spmv_csr_vector"
DEFAULT_BLOCK_SIZE = 256

_SRC = pathlib.Path(__file__).with_name("csr_vector.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
LIBRARY = BUILD_DIR / "libjax_spmv_cuda.so"

_lib = None                   # keeps the loaded library alive


MAX_THREADS_PER_ROW = 8      # 8 lanes x 4 B: one 32-byte sector a load


def threads_per_row(mean_nnz: float) -> int:
    """Lanes per row: the largest power of two not above 0.6 x the mean
    row length, between 1 and 8.  On the H100 this picked the fastest
    width of 2..32 at the power-law headline (mean 39 -> 8), the 1M web
    graph (14.5 -> 8) and the 5-point stencil (5 -> 2); wider groups
    idle their lanes on short rows (benchmarks/candidates.py sweeps it)."""
    tpr = 1
    while tpr < MAX_THREADS_PER_ROW and 2 * tpr <= 0.6 * mean_nnz:
        tpr *= 2
    return tpr


def long_row_threshold(tpr: int) -> int:
    """Rows longer than this (32 strides of their lane group) are summed
    by a whole block each."""
    return 32 * tpr


def long_rows(row_ptrs: np.ndarray, threshold: int) -> np.ndarray:
    """Indices of the rows longer than ``threshold``."""
    return np.flatnonzero(np.diff(row_ptrs) > threshold).astype(np.int32)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(pathlib.Path(home) / "bin" / "nvcc")


def build(force: bool = False) -> pathlib.Path:
    """Compile ``csr_vector.cu`` into :data:`LIBRARY` unless it is current."""
    if not force and LIBRARY.exists() \
            and LIBRARY.stat().st_mtime >= _SRC.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = LIBRARY.with_name(LIBRARY.name + ".partial")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(partial), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(partial, LIBRARY)
    return LIBRARY


def register() -> None:
    """Load the library and register its handler for CUDA (idempotent)."""
    global _lib
    if _lib is not None:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.CsrVector),
                                platform="CUDA")
    _lib = lib


def is_registered() -> bool:
    return _lib is not None


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class VectorCSR:
    """A device CSR plus the kernel's launch shape: the lane-group width,
    the long-row threshold and the device list of long rows.  Calling the
    kernel needs :func:`register` first."""

    dev: DeviceCSR
    long_rows: jax.Array      # i32 (n_long,)
    threads_per_row: int
    long_row: int
    block_size: int

    @staticmethod
    def build(A: CSRMatrix, block_size: int = DEFAULT_BLOCK_SIZE
              ) -> "VectorCSR":
        if block_size <= 0 or block_size % 32 or block_size > 1024:
            raise ValueError("block_size must be a multiple of 32, <= 1024")
        tpr = threads_per_row(A.nnz / max(A.num_rows, 1))
        threshold = long_row_threshold(tpr)
        return VectorCSR(dev=A.to_device(),
                         long_rows=jnp.asarray(long_rows(A.row_ptrs,
                                                         threshold)),
                         threads_per_row=tpr, long_row=threshold,
                         block_size=block_size)

    def tree_flatten(self):
        return (self.dev, self.long_rows), \
            (self.threads_per_row, self.long_row, self.block_size)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)


@jax.jit
def spmv_csr_vector(plan: VectorCSR, x: jax.Array) -> jax.Array:
    """``y = A @ x``; returns ``(num_rows,)``.  ``x`` has ``num_cols``
    entries or more (padding is never read)."""
    dev = plan.dev
    call = jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct((dev.num_rows,), jnp.float32))
    return call(dev.row_ptrs, dev.col_indices, dev.values, x,
                plan.long_rows,
                threads_per_row=np.int32(plan.threads_per_row),
                long_row=np.int32(plan.long_row),
                block_size=np.int32(plan.block_size))


def _tree_sum(partials: np.ndarray) -> np.ndarray:
    """Lane 0 after ``__shfl_down_sync`` halving over the last axis."""
    p = partials.copy()
    off = p.shape[-1] // 2
    while off:
        p[..., :off] += p[..., off:2 * off]
        off //= 2
    return p[..., 0]


def spmv_csr_vector_reference(A: CSRMatrix, x: np.ndarray, tpr: int,
                              long_row: int,
                              block_size: int = DEFAULT_BLOCK_SIZE
                              ) -> np.ndarray:
    """NumPy model of the kernel: float32 strided lane sums, the shuffle
    tree, and the long-row block reduction (each warp, then the warp sums
    padded to 32)."""
    x = np.asarray(x, np.float32)
    lens = np.diff(A.row_ptrs).astype(np.int64)
    row = np.repeat(np.arange(A.num_rows), lens)
    pos = np.arange(A.nnz) - np.repeat(A.row_ptrs[:-1].astype(np.int64),
                                       lens)
    prod = A.values * x[A.col_indices]
    is_long = lens[row] > long_row
    y = np.zeros(A.num_rows, np.float32)

    short = np.zeros((A.num_rows, tpr), np.float32)
    np.add.at(short, (row[~is_long], pos[~is_long] % tpr), prod[~is_long])
    y[lens <= long_row] = _tree_sum(short)[lens <= long_row]

    longs = np.flatnonzero(lens > long_row)
    slot = np.searchsorted(longs, row[is_long])
    blk = np.zeros((len(longs), 32, 32), np.float32)
    lane = pos[is_long] % block_size
    np.add.at(blk, (slot, lane // 32, lane % 32), prod[is_long])
    y[longs] = _tree_sum(_tree_sum(blk))
    return y


if __name__ == "__main__":
    sys.stdout.write(f"{build(force=True)}\n")
