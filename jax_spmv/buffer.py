"""Device buffer management (C2).

JAX re-design of the reference ``CudaBuffer<T>`` RAII template
(``include/spmv/cuda_buffer.h:13-101``): a move-only device allocation with
``get/size/empty/copyFromHost/copyToHost/resize/release``.

In JAX the runtime owns allocation, but an explicit buffer object is still
the right tool for the benchmark harness and PageRank state: it pins a
committed ``jax.Array`` on a chosen device, supports in-place-style update
via donation, and releases device memory eagerly (``jax.Array.delete``)
instead of waiting for GC — the semantics the reference gets from RAII.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .errors import InvalidArgumentError, SpMVError, DeviceException


class DeviceBuffer:
    """An eagerly-managed device array of fixed dtype.

    Mirrors ``CudaBuffer<T>`` (``cuda_buffer.h:13-101``): constructing with a
    size allocates zeroed device memory; ``copy_from_host`` / ``copy_to_host``
    move data; ``resize`` reallocates (contents dropped, as in the reference
    ``cuda_buffer.h:77-87``); ``release`` frees device memory immediately.
    Python has no move semantics; instead the buffer is non-copyable
    (no ``__copy__``) and ``take()`` transfers ownership explicitly.
    """

    def __init__(self, size: int = 0, dtype=jnp.float32, device=None):
        if size < 0:
            raise InvalidArgumentError("DeviceBuffer size must be >= 0")
        self._dtype = jnp.dtype(dtype)
        self._device = device if device is not None else jax.devices()[0]
        self._array: jax.Array | None = None
        if size > 0:
            try:
                self._array = jax.device_put(
                    jnp.zeros((size,), dtype=self._dtype), self._device
                )
            except Exception as e:  # allocation failure → typed error (C1 contract)
                raise DeviceException(e) from e

    # -- observers (cuda_buffer.h:56-58) --
    @property
    def size(self) -> int:
        return 0 if self._array is None else int(self._array.shape[0])

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def dtype(self):
        return self._dtype

    def get(self) -> jax.Array:
        """The underlying device array (analog of the raw pointer getter)."""
        if self._array is None:
            raise InvalidArgumentError("DeviceBuffer is empty/released")
        return self._array

    # -- transfer (cuda_buffer.h:61-74) --
    def copy_from_host(self, host: np.ndarray, count: int | None = None) -> None:
        host = np.asarray(host, dtype=self._dtype)
        n = len(host) if count is None else count
        if n > len(host) or n > self.size:
            # reference throws on copy-size overflow (cuda_buffer.h:62-63)
            raise InvalidArgumentError("copy_from_host: count exceeds buffer size")
        if n == 0:
            return
        if n == self.size:
            new = jax.device_put(jnp.asarray(host[:n]), self._device)
        else:
            new = self._array.at[:n].set(jnp.asarray(host[:n]))
        self._array = jax.block_until_ready(new)

    def copy_to_host(self, out: np.ndarray | None = None, count: int | None = None) -> np.ndarray:
        n = self.size if count is None else count
        if n > self.size:
            raise InvalidArgumentError("copy_to_host: count exceeds buffer size")
        host = np.asarray(jax.device_get(self.get()))[:n]
        if out is not None:
            if len(out) < n:
                raise InvalidArgumentError("copy_to_host: output too small")
            out[:n] = host
            return out
        return host.copy()

    # -- lifetime (cuda_buffer.h:77-96) --
    def resize(self, new_size: int) -> None:
        """Reallocate to ``new_size``; previous contents are dropped
        (matching the reference's realloc-without-copy, ``cuda_buffer.h:77-87``)."""
        if new_size < 0:
            raise InvalidArgumentError("resize: negative size")
        self.release()
        if new_size > 0:
            self._array = jax.device_put(
                jnp.zeros((new_size,), dtype=self._dtype), self._device
            )

    def release(self) -> None:
        """Free device memory now (RAII analog, ``cuda_buffer.h:90-96``)."""
        if self._array is not None:
            try:
                self._array.delete()
            except Exception:
                pass
            self._array = None

    def take(self) -> jax.Array:
        """Move-out: return the array and leave the buffer empty
        (the Python spelling of the reference's move constructor,
        ``cuda_buffer.h:38-53``)."""
        arr = self.get()
        self._array = None
        return arr

    def put(self, arr: jax.Array) -> None:
        """Adopt an existing device array (used for swap-style updates)."""
        if arr.dtype != self._dtype:
            raise InvalidArgumentError("put: dtype mismatch")
        self._array = arr

    def swap(self, other: "DeviceBuffer") -> None:
        """O(1) pointer swap (PageRank double-buffering, ``pagerank.cu:130``)."""
        self._array, other._array = other._array, self._array

    def __len__(self) -> int:
        return self.size

    def __del__(self):
        self.release()

    def __repr__(self) -> str:
        return f"DeviceBuffer(size={self.size}, dtype={self._dtype}, device={self._device})"


# error-code helper kept for API parity with the C layer
def buffer_status(buf: DeviceBuffer) -> SpMVError:
    return SpMVError.SUCCESS if not buf.empty else SpMVError.INVALID_ARGUMENT
