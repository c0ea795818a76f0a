"""Bandwidth metrics model (C13).

Re-design of the reference bandwidth layer (``include/spmv/bandwidth.h``,
``src/bandwidth.cpp``): theoretical peak per device, achieved bandwidth from
an explicit byte model, efficiency clamped to 1.0 (``bandwidth.cpp:52``).

Byte-accounting conventions preserved exactly so numbers stay comparable
with the reference (``BASELINE.md``):
  * CSR: read ``nnz*(4+4) + (rows+1)*4 + cols*4``, write ``rows*4``
    (``bandwidth.cpp:34-42``)
  * ELL: read ``rows*max_nnz*(4+4) + cols*4``, write ``rows*4``
    (``bandwidth.cpp:66-75``)

The reference derives peak from ``cudaGetDeviceProperties`` (memory clock x
bus width x 2, ``bandwidth.cpp:7-20``); JAX exposes no memory clock, so the
peak comes from NVIDIA's data sheets, keyed by the exact ``device_kind``
the card reports.  A device missing from the table has no peak: its
theoretical bandwidth and efficiency stay ``None``.
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass
class BandwidthMetrics:
    """Reference ``BandwidthMetrics`` (``bandwidth.h:10-18``).  The peak and
    the efficiency are ``None`` on a device without a published peak."""

    theoretical_gb_s: float | None
    achieved_gb_s: float
    efficiency: float | None  # achieved / theoretical, clamped to [0, 1]


# Published HBM bandwidth (GB/s, NVIDIA data sheets), by device_kind.
PEAK_GB_S = {
    "NVIDIA H100 80GB HBM3": 3350.0,   # H100 SXM5
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}

_MEASURED_PEAK_CACHE: dict[str, float] = {}


def get_peak_bandwidth(device=None) -> float | None:
    """Published peak memory bandwidth in GB/s of ``device`` (default: JAX's
    first device), or ``None`` when its ``device_kind`` is not in
    :data:`PEAK_GB_S` (analog of ``get_gpu_peak_bandwidth``,
    ``bandwidth.cpp:7-20``)."""
    if device is None:
        device = jax.devices()[0]
    return PEAK_GB_S.get(getattr(device, "device_kind", ""))


def measured_stream_bandwidth(device=None) -> float:
    """Measured read rate (GB/s) of a fused 256 MB read-reduce — the
    attainable bandwidth a read-dominated SpMV can be held against.
    Cached per device kind."""
    import jax.numpy as jnp
    from .timing import time_jitted

    if device is None:
        device = jax.devices()[0]
    key = getattr(device, "device_kind", "cpu")
    if key in _MEASURED_PEAK_CACHE:
        return _MEASURED_PEAK_CACHE[key]
    n = 1 << 26  # 256 MB
    x = jax.device_put(jnp.arange(n, dtype=jnp.float32), device)
    secs = time_jitted(lambda v: jnp.sum(v * 1.0000001), x)
    gbs = n * 4 / secs / 1e9
    _MEASURED_PEAK_CACHE[key] = gbs
    return gbs


def _csr_bytes(num_rows: int, num_cols: int, nnz: int) -> int:
    """CSR byte model (``bandwidth.cpp:34-42``)."""
    read = nnz * (4 + 4) + (num_rows + 1) * 4 + num_cols * 4
    write = num_rows * 4
    return read + write


def _ell_bytes(num_rows: int, num_cols: int, max_nnz_per_row: int) -> int:
    """ELL byte model (``bandwidth.cpp:66-75``)."""
    read = num_rows * max_nnz_per_row * (4 + 4) + num_cols * 4
    write = num_rows * 4
    return read + write


def _metrics(nbytes: int, elapsed_ms: float, device) -> BandwidthMetrics:
    peak = get_peak_bandwidth(device)
    if elapsed_ms <= 0.0:
        return BandwidthMetrics(peak, 0.0, None if peak is None else 0.0)
    achieved = nbytes / (elapsed_ms * 1e-3) / 1e9
    eff = None if peak is None else min(achieved / peak, 1.0)
    return BandwidthMetrics(peak, achieved, eff)


def compute_bandwidth_csr(num_rows: int, num_cols: int, nnz: int,
                          elapsed_ms: float, device=None) -> BandwidthMetrics:
    """Reference ``compute_bandwidth_csr`` (``bandwidth.cpp:22-56``)."""
    return _metrics(_csr_bytes(num_rows, num_cols, nnz), elapsed_ms, device)


def compute_bandwidth_ell(num_rows: int, num_cols: int, max_nnz_per_row: int,
                          elapsed_ms: float, device=None) -> BandwidthMetrics:
    """Reference ``compute_bandwidth_ell`` (``bandwidth.cpp:58-88``)."""
    return _metrics(_ell_bytes(num_rows, num_cols, max_nnz_per_row),
                    elapsed_ms, device)
