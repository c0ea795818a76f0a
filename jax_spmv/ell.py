"""ELL (ELLPACK) storage (C4).

JAX re-design of the reference ELL layer (``include/spmv/ell_matrix.h``,
``src/ell_matrix.cpp``).  The reference stores column-major
(``values[k * num_rows + row]``, ``ell_matrix.h:64-66``) for GPU memory
coalescing, and the device form keeps it: slot-major 2D arrays of shape
``(max_nnz_per_row, num_rows)`` put consecutive rows side by side, so
consecutive threads read consecutive rows of one slot.  The host
container keeps the reference's exact 1D column-major layout (and its
serialized byte format), while :class:`DeviceELL` reshapes it to a padded
``(slots, rows_pad)`` 2D array.

Padding convention preserved: ``col = -1`` and ``value = 0`` for unused
slots (``ell_matrix.cpp:23-27``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import BinaryIO

import numpy as np

import jax
import jax.numpy as jnp

from .csr import CSRMatrix, _bucket
from .errors import (
    FileIOError,
    InvalidArgumentError,
    InvalidDimensionError,
    SpMVError,
)


def ell_index(row: int, k: int, num_rows: int) -> int:
    """Column-major flat index (reference ``ell_matrix.h:64-66``)."""
    return k * num_rows + row


@dataclasses.dataclass
class ELLMatrix:
    """Host-side ELLPACK matrix with the reference's column-major 1D layout.

    ``values``/``col_indices`` have ``num_rows * max_nnz_per_row`` entries,
    addressed by :func:`ell_index`; padding is ``col=-1, val=0``
    (``ell_matrix.h:12-28``).
    """

    num_rows: int
    num_cols: int
    max_nnz_per_row: int
    values: np.ndarray
    col_indices: np.ndarray
    _device_cache: "DeviceELL | None" = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _plan_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def __post_init__(self):
        self.values = np.ascontiguousarray(self.values, dtype=np.float32)
        self.col_indices = np.ascontiguousarray(self.col_indices, dtype=np.int32)
        size = self.num_rows * self.max_nnz_per_row
        if len(self.values) != size or len(self.col_indices) != size:
            raise InvalidDimensionError("ELL array size != rows * max_nnz_per_row")

    # ---- constructors ----
    @staticmethod
    def create(num_rows: int, num_cols: int, max_nnz_per_row: int) -> "ELLMatrix":
        """Allocate with pad initialization (reference ``ell_create``,
        ``ell_matrix.cpp:8-36``)."""
        if num_rows < 0 or num_cols < 0 or max_nnz_per_row < 0:
            raise InvalidDimensionError("ell_create: negative dimension")
        size = num_rows * max_nnz_per_row
        return ELLMatrix(
            num_rows=num_rows,
            num_cols=num_cols,
            max_nnz_per_row=max_nnz_per_row,
            values=np.zeros(size, np.float32),
            col_indices=np.full(size, -1, np.int32),
        )

    @staticmethod
    def from_dense(dense: np.ndarray, num_rows: int | None = None,
                   num_cols: int | None = None) -> "ELLMatrix":
        """Dense → ELL (reference ``ell_from_dense``, ``ell_matrix.cpp:53-109``).
        Exact-zero detection; ``max_nnz_per_row`` from the densest row."""
        dense = np.asarray(dense, dtype=np.float32)
        if num_rows is not None:
            dense = dense.reshape(num_rows, num_cols)
        if dense.ndim != 2:
            raise InvalidDimensionError("from_dense expects a 2D array")
        return ELLMatrix.from_csr(CSRMatrix.from_dense(dense))

    @staticmethod
    def from_csr(csr: CSRMatrix) -> "ELLMatrix":
        """CSR → ELL (reference ``ell_from_csr``, ``ell_matrix.cpp:111-159``)."""
        rows, cols = csr.num_rows, csr.num_cols
        row_nnz = np.diff(csr.row_ptrs)
        max_nnz = int(row_nnz.max(initial=0))
        ell = ELLMatrix.create(rows, cols, max_nnz)
        if csr.nnz:
            # slot of each nnz within its row, vectorized
            starts = np.repeat(csr.row_ptrs[:-1], row_nnz)
            slot = np.arange(csr.nnz, dtype=np.int64) - starts
            rr = np.repeat(np.arange(rows, dtype=np.int64), row_nnz)
            flat = slot * rows + rr  # column-major (ell_matrix.h:64-66)
            ell.values[flat] = csr.values
            ell.col_indices[flat] = csr.col_indices
        return ell

    def to_csr(self) -> CSRMatrix:
        """ELL → CSR (inverse of :meth:`from_csr`, vectorized).  Used to
        hand ELL matrices to the CSR paths and oracle; column order
        within a row follows slot order (ELL stores no ordering guarantee,
        ``ell_matrix.h:12-28``)."""
        k, r = self.max_nnz_per_row, self.num_rows
        if k == 0 or r == 0:
            return CSRMatrix(r, self.num_cols, np.zeros(0, np.float32),
                             np.zeros(0, np.int32),
                             np.zeros(r + 1, np.int32))
        cols2 = self.col_indices.reshape(k, r).T   # (rows, slots)
        vals2 = self.values.reshape(k, r).T
        valid = cols2 >= 0
        counts = valid.sum(axis=1)
        row_ptrs = np.zeros(r + 1, np.int32)
        np.cumsum(counts, out=row_ptrs[1:])
        return CSRMatrix(r, self.num_cols, vals2[valid],
                         cols2[valid], row_ptrs)

    # ---- conversions / queries ----
    def to_dense(self) -> np.ndarray:
        """ELL → dense (reference ``ell_to_dense``, ``ell_matrix.cpp:162-182``)."""
        dense = np.zeros((self.num_rows, self.num_cols), np.float32)
        if self.max_nnz_per_row == 0 or self.num_rows == 0:
            return dense
        vals = self.values.reshape(self.max_nnz_per_row, self.num_rows)
        cols = self.col_indices.reshape(self.max_nnz_per_row, self.num_rows)
        for k in range(self.max_nnz_per_row):
            valid = cols[k] >= 0
            dense[np.nonzero(valid)[0], cols[k][valid]] = vals[k][valid]
        return dense

    def get_element(self, row: int, col: int) -> float:
        """Reference ``ell_get_element`` (``ell_matrix.cpp:184-200``)."""
        if not (0 <= row < self.num_rows and 0 <= col < self.num_cols):
            return 0.0
        for k in range(self.max_nnz_per_row):
            idx = ell_index(row, k, self.num_rows)
            if self.col_indices[idx] == col:
                return float(self.values[idx])
        return 0.0

    @property
    def nnz(self) -> int:
        """Actual stored non-zeros (pad slots have col = -1); the reference
        recounts this on the host for metrics (``spmv_kernels.cu:399-405``)."""
        return int((self.col_indices >= 0).sum())

    # ---- binary serialization (byte-compatible with the reference) ----
    def serialize(self, path: str | os.PathLike | BinaryIO) -> None:
        """Reference binary layout (``ell_matrix.cpp:254-280``): int32 header
        {rows, cols, max_nnz}, then values f32[rows*max_nnz] and
        col_indices i32[rows*max_nnz] in column-major order."""
        own = not hasattr(path, "write")
        f = open(path, "wb") if own else path
        try:
            f.write(np.array([self.num_rows, self.num_cols,
                              self.max_nnz_per_row], dtype="<i4").tobytes())
            if self.values.size:
                f.write(self.values.astype("<f4").tobytes())
                f.write(self.col_indices.astype("<i4").tobytes())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    @staticmethod
    def deserialize(path: str | os.PathLike | BinaryIO) -> "ELLMatrix":
        """Reference ``ell_deserialize`` (``ell_matrix.cpp:282-324``)."""
        own = not hasattr(path, "read")
        f = open(path, "rb") if own else path
        try:
            header = np.frombuffer(f.read(12), dtype="<i4")
            if len(header) != 3:
                raise FileIOError("truncated ELL header")
            rows, cols, max_nnz = (int(v) for v in header)
            if rows < 0 or cols < 0 or max_nnz < 0:
                raise FileIOError("corrupt ELL header")
            size = rows * max_nnz
            values = np.frombuffer(f.read(4 * size), dtype="<f4")
            col_indices = np.frombuffer(f.read(4 * size), dtype="<i4")
            if len(values) != size or len(col_indices) != size:
                raise FileIOError("truncated ELL payload")
            return ELLMatrix(rows, cols, max_nnz, values.copy(),
                             col_indices.copy())
        except OSError as e:
            raise FileIOError(str(e)) from e
        finally:
            if own:
                f.close()

    # ---- device transfer ----
    def to_device(self, device=None) -> "DeviceELL":
        if self._device_cache is None or device is not None:
            self._device_cache = DeviceELL.from_host(self, device=device)
        return self._device_cache

    def from_device(self, dev: "DeviceELL | None" = None) -> None:
        """Download device arrays back into host storage (reference
        ``ell_from_gpu``, ``ell_matrix.cpp:219-252``): the padded slot-major
        device form is cropped and flattened back to the column-major 1D
        host layout.  ``dev=None`` uses this matrix's cached device form."""
        dev = dev if dev is not None else self._device_cache
        if dev is None:
            raise InvalidArgumentError("from_device: no device matrix")
        if dev.num_rows != self.num_rows or dev.num_cols != self.num_cols \
                or dev.max_nnz_per_row != self.max_nnz_per_row:
            raise InvalidDimensionError("from_device: dimension mismatch")
        k, r = self.max_nnz_per_row, self.num_rows
        self.values = np.asarray(dev.values)[:k, :r].reshape(-1).copy()
        self.col_indices = \
            np.asarray(dev.col_indices)[:k, :r].reshape(-1).copy()

    def free_device(self) -> None:
        if self._device_cache is not None:
            self._device_cache.delete()
            self._device_cache = None


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DeviceELL:
    """Device form: slot-major 2D ``(slots, rows_pad)`` arrays.

    ``rows_pad`` is a power-of-two multiple of 1024 (one compiled program
    per size bucket); padded entries keep the reference convention (col=-1, val=0)
    so kernels mask by ``col >= 0`` exactly like ``spmv_ell_kernel``
    (``spmv_kernels.cu:191-213``).
    """

    values: jax.Array        # f32 (slots, rows_pad)
    col_indices: jax.Array   # i32 (slots, rows_pad)
    num_rows: int
    num_cols: int
    max_nnz_per_row: int

    @property
    def rows_pad(self) -> int:
        return int(self.values.shape[1]) if self.values.ndim == 2 else 0

    @staticmethod
    def from_host(mat: ELLMatrix, device=None) -> "DeviceELL":
        rows_pad = _bucket(mat.num_rows)
        slots = max(mat.max_nnz_per_row, 1)
        vals = np.zeros((slots, rows_pad), np.float32)
        cols = np.full((slots, rows_pad), -1, np.int32)
        if mat.num_rows and mat.max_nnz_per_row:
            vals[: mat.max_nnz_per_row, : mat.num_rows] = \
                mat.values.reshape(mat.max_nnz_per_row, mat.num_rows)
            cols[: mat.max_nnz_per_row, : mat.num_rows] = \
                mat.col_indices.reshape(mat.max_nnz_per_row, mat.num_rows)
        from .errors import guarded_device_put

        put = lambda a: guarded_device_put(a, device)  # noqa: E731
        return DeviceELL(
            values=put(jnp.asarray(vals)),
            col_indices=put(jnp.asarray(cols)),
            num_rows=mat.num_rows,
            num_cols=mat.num_cols,
            max_nnz_per_row=mat.max_nnz_per_row,
        )

    def delete(self) -> None:
        for arr in (self.values, self.col_indices):
            try:
                arr.delete()
            except Exception:
                pass

    def tree_flatten(self):
        return (self.values, self.col_indices), \
            (self.num_rows, self.num_cols, self.max_nnz_per_row)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)


# ---- module-level C-style API parity ----

def ell_create(num_rows: int, num_cols: int, max_nnz_per_row: int) -> ELLMatrix:
    return ELLMatrix.create(num_rows, num_cols, max_nnz_per_row)


def ell_from_dense(dense, num_rows=None, num_cols=None) -> ELLMatrix:
    return ELLMatrix.from_dense(dense, num_rows, num_cols)


def ell_from_csr(csr: CSRMatrix) -> ELLMatrix:
    return ELLMatrix.from_csr(csr)


def ell_to_dense(mat: ELLMatrix) -> np.ndarray:
    return mat.to_dense()


def ell_get_element(mat: ELLMatrix, row: int, col: int) -> float:
    return mat.get_element(row, col)


def ell_to_device(mat: ELLMatrix, device=None) -> DeviceELL:
    return mat.to_device(device)


def ell_from_device(mat: ELLMatrix, dev: DeviceELL | None = None) -> None:
    """Reference ``ell_from_gpu`` (``ell_matrix.cpp:219-252``)."""
    mat.from_device(dev)


def ell_serialize(mat: ELLMatrix, path) -> SpMVError:
    if mat is None or path is None:
        raise InvalidArgumentError("ell_serialize: null argument")
    mat.serialize(path)
    return SpMVError.SUCCESS


def ell_deserialize(path) -> ELLMatrix:
    return ELLMatrix.deserialize(path)
