"""CSR (Compressed Sparse Row) storage (C3).

JAX re-design of the reference CSR layer
(``include/spmv/csr_matrix.h``, ``src/csr_matrix.cpp``):

* :class:`CSRMatrix` — host container (NumPy arrays) with the reference's
  full surface: ``from_dense`` (``csr_matrix.cpp:50-95``), ``to_dense``
  (``:97-114``), ``get_element`` (``:116-135``), binary
  ``serialize``/``deserialize`` byte-compatible with the reference layout
  (``:202-279``), and ``compute_stats`` (``:281-300``).
* :class:`DeviceCSR` — the device form (replaces ``csr_to_gpu``/``from_gpu``/
  ``free_gpu``, ``csr_matrix.cpp:138-200``).  Instead of raw device pointers
  it is a jit-friendly pytree with **static padded shapes** (XLA compiles one
  program per shape bucket) and a precomputed per-nnz ``row_ids`` array —
  the merge-path row decode that the CUDA kernels do
  per-thread (``spmv_kernels.cu:97-98``) is done once at transfer time,
  vectorized.

Semantics preserved exactly from the reference:
  * zero detection in ``from_dense`` is exact float inequality
    (``csr_matrix.cpp:58``);
  * column indices within a row are sorted ascending (row-major scan,
    ``csr_matrix.cpp:80-93``), and ``get_element`` exploits the ordering
    (``csr_matrix.cpp:129-131``);
  * ``skewness = max_nnz_per_row / (min_nnz_per_row + 1)``
    (``csr_matrix.cpp:297``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import BinaryIO

import numpy as np

import jax
import jax.numpy as jnp

from .errors import (
    FileIOError,
    InvalidArgumentError,
    InvalidDimensionError,
    SpMVError,
)

# Minimum device padding quantum (elements).
PAD_QUANTUM = 1024


def _bucket(n: int, quantum: int = PAD_QUANTUM) -> int:
    """Round ``n`` up to a power-of-two multiple of ``quantum``.

    Static shapes are mandatory under ``jit``; bucketing caps the number of
    compiled program variants at O(log nnz) while wasting < 2x memory.
    """
    if n <= quantum:
        return quantum
    k = (n + quantum - 1) // quantum
    return quantum * (1 << (k - 1).bit_length())


@dataclasses.dataclass
class CSRStats:
    """Row-length statistics (reference ``csr_matrix.h:64-71``)."""

    avg_nnz_per_row: float
    max_nnz_per_row: int
    min_nnz_per_row: int
    skewness: float  # max / (min + 1), csr_matrix.cpp:297


@dataclasses.dataclass
class CSRMatrix:
    """Host-side CSR matrix.

    ``values[nnz]`` f32, ``col_indices[nnz]`` i32, ``row_ptrs[rows+1]`` i32 —
    the same three arrays as the reference struct (``csr_matrix.h:11-28``).
    Host/device unification is replaced by an explicit, cached
    :meth:`to_device` (JAX arrays are immutable, so no ownership flags).
    """

    num_rows: int
    num_cols: int
    values: np.ndarray
    col_indices: np.ndarray
    row_ptrs: np.ndarray
    _device_cache: "DeviceCSR | None" = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _plan_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def nnz(self) -> int:
        return int(len(self.values))

    def __post_init__(self):
        self.values = np.ascontiguousarray(self.values, dtype=np.float32)
        self.col_indices = np.ascontiguousarray(self.col_indices, dtype=np.int32)
        self.row_ptrs = np.ascontiguousarray(self.row_ptrs, dtype=np.int32)
        if self.num_rows < 0 or self.num_cols < 0:
            raise InvalidDimensionError("negative matrix dimension")
        if len(self.row_ptrs) != self.num_rows + 1:
            raise InvalidDimensionError("row_ptrs must have num_rows + 1 entries")
        if len(self.col_indices) != len(self.values):
            raise InvalidDimensionError("values / col_indices length mismatch")

    # ---- constructors ----
    @staticmethod
    def create(num_rows: int, num_cols: int, nnz: int) -> "CSRMatrix":
        """Allocate an empty CSR shell (reference ``csr_create``,
        ``csr_matrix.cpp:10-32``)."""
        if num_rows < 0 or num_cols < 0 or nnz < 0:
            raise InvalidDimensionError("csr_create: negative dimension")
        return CSRMatrix(
            num_rows=num_rows,
            num_cols=num_cols,
            values=np.zeros(nnz, np.float32),
            col_indices=np.zeros(nnz, np.int32),
            row_ptrs=np.zeros(num_rows + 1, np.int32),
        )

    @staticmethod
    def from_dense(dense: np.ndarray, num_rows: int | None = None,
                   num_cols: int | None = None) -> "CSRMatrix":
        """Dense (row-major) → CSR (reference ``csr_from_dense``,
        ``csr_matrix.cpp:50-95``).  Vectorized two-pass; zero test is exact
        ``!= 0.0`` like the reference (``csr_matrix.cpp:58``)."""
        dense = np.asarray(dense, dtype=np.float32)
        if num_rows is not None:
            dense = dense.reshape(num_rows, num_cols)
        if dense.ndim != 2:
            raise InvalidDimensionError("from_dense expects a 2D array")
        rows, cols = dense.shape
        mask = dense != np.float32(0.0)
        row_nnz = mask.sum(axis=1, dtype=np.int64)
        row_ptrs = np.zeros(rows + 1, np.int32)
        np.cumsum(row_nnz, out=row_ptrs[1:])
        rr, cc = np.nonzero(mask)  # row-major order → cols sorted within row
        return CSRMatrix(
            num_rows=rows,
            num_cols=cols,
            values=dense[rr, cc].astype(np.float32),
            col_indices=cc.astype(np.int32),
            row_ptrs=row_ptrs,
        )

    @staticmethod
    def from_arrays(num_rows: int, num_cols: int, values, col_indices,
                    row_ptrs) -> "CSRMatrix":
        return CSRMatrix(num_rows, num_cols, np.asarray(values),
                         np.asarray(col_indices), np.asarray(row_ptrs))

    # ---- conversions / queries ----
    def to_dense(self) -> np.ndarray:
        """CSR → dense (reference ``csr_to_dense``, ``csr_matrix.cpp:97-114``)."""
        dense = np.zeros((self.num_rows, self.num_cols), np.float32)
        if self.nnz:
            rows = np.repeat(
                np.arange(self.num_rows, dtype=np.int64), np.diff(self.row_ptrs)
            )
            dense[rows, self.col_indices] = self.values
        return dense

    def get_element(self, row: int, col: int) -> float:
        """Element lookup via binary search over the sorted column slice
        (reference linear-with-early-exit, ``csr_matrix.cpp:116-135``)."""
        if not (0 <= row < self.num_rows and 0 <= col < self.num_cols):
            return 0.0
        lo, hi = int(self.row_ptrs[row]), int(self.row_ptrs[row + 1])
        j = lo + int(np.searchsorted(self.col_indices[lo:hi], col))
        if j < hi and self.col_indices[j] == col:
            return float(self.values[j])
        return 0.0

    def compute_stats(self) -> CSRStats:
        """Reference ``csr_compute_stats`` (``csr_matrix.cpp:281-300``)."""
        if self.num_rows == 0:
            return CSRStats(0.0, 0, 0, 0.0)
        row_nnz = np.diff(self.row_ptrs)
        mx = int(row_nnz.max()) if len(row_nnz) else 0
        mn = int(row_nnz.min()) if len(row_nnz) else 0
        return CSRStats(
            avg_nnz_per_row=self.nnz / self.num_rows,
            max_nnz_per_row=mx,
            min_nnz_per_row=mn,
            skewness=float(mx) / float(mn + 1),
        )

    # ---- binary serialization (byte-compatible with the reference) ----
    def serialize(self, path: str | os.PathLike | BinaryIO) -> None:
        """Write the reference binary layout (``csr_matrix.cpp:202-230``):
        int32 header {rows, cols, nnz}, then values f32[nnz],
        col_indices i32[nnz], row_ptrs i32[rows+1], little-endian."""
        own = not hasattr(path, "write")
        f = open(path, "wb") if own else path
        try:
            f.write(np.array([self.num_rows, self.num_cols, self.nnz],
                             dtype="<i4").tobytes())
            if self.nnz:
                f.write(self.values.astype("<f4").tobytes())
                f.write(self.col_indices.astype("<i4").tobytes())
            f.write(self.row_ptrs.astype("<i4").tobytes())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    @staticmethod
    def deserialize(path: str | os.PathLike | BinaryIO) -> "CSRMatrix":
        """Read the reference binary layout (``csr_matrix.cpp:232-279``)."""
        own = not hasattr(path, "read")
        f = open(path, "rb") if own else path
        try:
            header = np.frombuffer(f.read(12), dtype="<i4")
            if len(header) != 3:
                raise FileIOError("truncated CSR header")
            rows, cols, nnz = (int(v) for v in header)
            if rows < 0 or cols < 0 or nnz < 0:
                raise FileIOError("corrupt CSR header")
            values = np.frombuffer(f.read(4 * nnz), dtype="<f4")
            col_indices = np.frombuffer(f.read(4 * nnz), dtype="<i4")
            row_ptrs = np.frombuffer(f.read(4 * (rows + 1)), dtype="<i4")
            if len(values) != nnz or len(col_indices) != nnz \
                    or len(row_ptrs) != rows + 1:
                raise FileIOError("truncated CSR payload")
            return CSRMatrix(rows, cols, values.copy(), col_indices.copy(),
                             row_ptrs.copy())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    # ---- device transfer ----
    def to_device(self, device=None) -> "DeviceCSR":
        """Upload to the device (replaces ``csr_to_gpu``, ``csr_matrix.cpp:138-165``).

        The result is cached; re-upload is idempotent like the reference's
        free-then-upload (``csr_matrix.cpp:144``).
        """
        if self._device_cache is None or device is not None:
            self._device_cache = DeviceCSR.from_host(self, device=device)
        return self._device_cache

    def from_device(self, dev: "DeviceCSR") -> None:
        """Download device arrays back into this host matrix (replaces
        ``csr_from_gpu``, ``csr_matrix.cpp:167-182``)."""
        nnz = dev.nnz
        self.values = np.asarray(dev.values)[:nnz].copy()
        self.col_indices = np.asarray(dev.col_indices)[:nnz].copy()
        self.row_ptrs = np.asarray(dev.row_ptrs)[: self.num_rows + 1].copy()

    def free_device(self) -> None:
        """Drop device memory eagerly (replaces ``csr_free_gpu``,
        ``csr_matrix.cpp:184-200``)."""
        if self._device_cache is not None:
            self._device_cache.delete()
            self._device_cache = None
        self._plan_cache.clear()


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """Static-shaped device form of a CSR matrix.

    ``values``/``col_indices``/``row_ids`` are padded to ``nnz_pad``
    (power-of-two bucket of 1024); ``row_ptrs`` is padded to
    ``rows_pad + 1`` with the terminal value repeated.  Padding nnz carry
    ``value = 0`` and point at column 0 / the last padded row, so every
    kernel can process the full padded extent unconditionally — masking by
    construction, and one compiled program per size bucket.
    """

    values: jax.Array        # f32 (nnz_pad,)
    col_indices: jax.Array   # i32 (nnz_pad,)
    row_ptrs: jax.Array      # i32 (rows_pad + 1,)
    row_ids: jax.Array       # i32 (nnz_pad,)  row of each nnz slot
    num_rows: int = dataclasses.field(metadata=dict(static=True))
    num_cols: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz_pad(self) -> int:
        return int(self.values.shape[0])

    @property
    def rows_pad(self) -> int:
        return int(self.row_ptrs.shape[0]) - 1

    @staticmethod
    def from_host(mat: CSRMatrix, device=None) -> "DeviceCSR":
        nnz_pad = _bucket(mat.nnz)
        rows_pad = _bucket(mat.num_rows)
        values = np.zeros(nnz_pad, np.float32)
        values[: mat.nnz] = mat.values
        cols = np.zeros(nnz_pad, np.int32)
        cols[: mat.nnz] = mat.col_indices
        rptr = np.full(rows_pad + 1, mat.nnz, np.int32)
        rptr[: mat.num_rows + 1] = mat.row_ptrs
        # expand row_ptrs → per-nnz row ids (vectorized merge-path row decode)
        row_ids = np.full(nnz_pad, rows_pad - 1, np.int32)
        if mat.nnz:
            row_ids[: mat.nnz] = np.repeat(
                np.arange(mat.num_rows, dtype=np.int32), np.diff(mat.row_ptrs)
            )
        from .errors import guarded_device_put

        put = lambda a: guarded_device_put(a, device)  # noqa: E731
        return DeviceCSR(
            values=put(jnp.asarray(values)),
            col_indices=put(jnp.asarray(cols)),
            row_ptrs=put(jnp.asarray(rptr)),
            row_ids=put(jnp.asarray(row_ids)),
            num_rows=mat.num_rows,
            num_cols=mat.num_cols,
            nnz=mat.nnz,
        )

    def delete(self) -> None:
        for arr in (self.values, self.col_indices, self.row_ptrs, self.row_ids):
            try:
                arr.delete()
            except Exception:
                pass

    # pytree protocol: arrays are leaves, dims are static aux data
    def tree_flatten(self):
        leaves = (self.values, self.col_indices, self.row_ptrs, self.row_ids)
        aux = (self.num_rows, self.num_cols, self.nnz)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)


# ---- module-level C-style API parity (reference header names) ----

def csr_create(num_rows: int, num_cols: int, nnz: int) -> CSRMatrix:
    return CSRMatrix.create(num_rows, num_cols, nnz)


def csr_from_dense(dense, num_rows=None, num_cols=None) -> CSRMatrix:
    return CSRMatrix.from_dense(dense, num_rows, num_cols)


def csr_to_dense(mat: CSRMatrix) -> np.ndarray:
    return mat.to_dense()


def csr_get_element(mat: CSRMatrix, row: int, col: int) -> float:
    return mat.get_element(row, col)


def csr_to_device(mat: CSRMatrix, device=None) -> DeviceCSR:
    return mat.to_device(device)


def csr_serialize(mat: CSRMatrix, path) -> SpMVError:
    if mat is None or path is None:
        raise InvalidArgumentError("csr_serialize: null argument")
    mat.serialize(path)
    return SpMVError.SUCCESS


def csr_deserialize(path) -> CSRMatrix:
    return CSRMatrix.deserialize(path)


def csr_compute_stats(mat: CSRMatrix) -> CSRStats:
    return mat.compute_stats()
