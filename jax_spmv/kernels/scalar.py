"""Flat CSR SpMV in plain XLA (the ``SCALAR_CSR`` path).

    y = segment_sum(values * x[col_indices], row_ids)

A gather over the padded nnz extent, an elementwise multiply and a sorted
scatter-add keyed by the per-nnz row ids that :class:`~jax_spmv.csr.DeviceCSR`
precomputes at upload.  The work is split over nonzeros, not rows, so row
skew does not matter to it: it is the reference's merge-path idea with the
row decode done once on the host.  It reads 12 B/nnz (value, column and
row id) plus the gathered x.  On a GPU XLA lowers the scatter-add to
atomics, so each row's sum is taken in no fixed order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..csr import DeviceCSR


def pad_x(x: jax.Array, cols_pad: int) -> jax.Array:
    """Zero-pad the operand vector to the device padding bucket."""
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    if n == cols_pad:
        return x
    return jnp.pad(x, (0, cols_pad - n))


@jax.jit
def spmv_csr_scalar(dev: DeviceCSR, x: jax.Array) -> jax.Array:
    """``y = A @ x`` over the padded extent; returns ``(rows_pad,)``.

    Padding nnz have ``value == 0`` and point at the last padded row, so no
    masking is needed (cf. ``DeviceCSR`` docstring).  ``x`` must already be
    padded to ``cols_pad`` (see :func:`pad_x`); padded gather reads hit
    ``x[0]`` with a zero multiplier.
    """
    rows_pad = dev.row_ptrs.shape[0] - 1
    gathered = jnp.take(x, dev.col_indices, mode="clip")
    prod = dev.values * gathered
    return jax.ops.segment_sum(
        prod, dev.row_ids, num_segments=rows_pad, indices_are_sorted=True
    )
