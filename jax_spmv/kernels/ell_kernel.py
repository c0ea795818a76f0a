"""Slot-major ELL SpMV in plain XLA (the ``ELL_KERNEL`` path, C10 analog).

The reference ELL kernel is one thread per row looping over column-major
slots with a pad test (``spmv_kernels.cu:191-213``).  ``DeviceELL`` stores
``(slots, rows_pad)`` arrays, so slot ``k`` is one contiguous row vector per
operand: XLA fuses the masked gather-multiply and the slot-axis sum into a
loop in which consecutive threads read consecutive rows, the same coalesced
walk as the reference.  The padding mask is ``col >= 0`` exactly as there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ell import DeviceELL


@jax.jit
def spmv_ell_device(dev: DeviceELL, x: jax.Array) -> jax.Array:
    """``y = A @ x`` for device ELL; returns ``(rows_pad,)``."""
    x = jnp.asarray(x, jnp.float32)
    cols = dev.col_indices                       # (slots, rows_pad)
    valid = cols >= 0
    safe = jnp.where(valid, cols, 0)
    gathered = jnp.take(x, safe, mode="clip")    # (slots, rows_pad)
    prod = jnp.where(valid, dev.values * gathered, 0.0)
    return jnp.sum(prod, axis=0)
