"""Bandwidth model tests (C13) — mirrors ``tests/test_bandwidth.cu``."""

import types

from jax_spmv import (
    compute_bandwidth_csr,
    compute_bandwidth_ell,
    get_peak_bandwidth,
)
from jax_spmv.bandwidth import PEAK_GB_S

from conftest import PROP_ITERS

H100 = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")


class TestProperty12MetricValidity:
    """Property 12: metrics are finite, non-negative, efficiency in [0,1]
    (test_bandwidth.cu:19-57)."""

    def test_csr_metrics(self, rng):
        for _ in range(PROP_ITERS):
            rows = rng.uniform_int(1, 10000)
            cols = rng.uniform_int(1, 10000)
            nnz = rng.uniform_int(0, rows * 4)
            ms = rng.uniform(0.001, 100.0)
            m = compute_bandwidth_csr(rows, cols, nnz, ms, device=H100)
            assert m.theoretical_gb_s > 0
            assert m.achieved_gb_s >= 0
            assert 0.0 <= m.efficiency <= 1.0

    def test_ell_metrics(self, rng):
        for _ in range(PROP_ITERS):
            rows = rng.uniform_int(1, 10000)
            cols = rng.uniform_int(1, 10000)
            max_nnz = rng.uniform_int(0, 64)
            ms = rng.uniform(0.001, 100.0)
            m = compute_bandwidth_ell(rows, cols, max_nnz, ms, device=H100)
            assert m.achieved_gb_s >= 0
            assert 0.0 <= m.efficiency <= 1.0


class TestPeak:
    def test_peak_sane(self):
        """Peak below 10 TB/s (test_bandwidth.cu:60-64) for every card in
        the table; the H100 SXM reads its data-sheet 3.35 TB/s."""
        assert get_peak_bandwidth(H100) == 3350.0
        for kind in PEAK_GB_S:
            peak = get_peak_bandwidth(types.SimpleNamespace(device_kind=kind))
            assert 0 < peak < 10000

    def test_unknown_device_has_no_peak(self):
        """A device missing from the table gets no peak: theoretical and
        efficiency stay unset, never assumed (the CPU is such a device)."""
        cpu = types.SimpleNamespace(device_kind="cpu")
        assert get_peak_bandwidth(cpu) is None
        odd = types.SimpleNamespace(device_kind="NVIDIA H100")
        assert get_peak_bandwidth(odd) is None
        m = compute_bandwidth_csr(100, 100, 500, 1.0, device=odd)
        assert m.theoretical_gb_s is None and m.efficiency is None
        assert m.achieved_gb_s > 0


class TestZeroTimeGuard:
    def test_zero_time(self):
        """Zero elapsed time → zero achieved, no division blow-up
        (test_bandwidth.cu:100-113)."""
        m = compute_bandwidth_csr(100, 100, 500, 0.0, device=H100)
        assert m.achieved_gb_s == 0.0
        assert m.efficiency == 0.0

    def test_byte_model(self):
        """Exact reference byte accounting (bandwidth.cpp:34-42)."""
        rows, cols, nnz, ms = 100, 200, 500, 1.0
        m = compute_bandwidth_csr(rows, cols, nnz, ms)
        expected_bytes = nnz * 8 + (rows + 1) * 4 + cols * 4 + rows * 4
        assert abs(m.achieved_gb_s - expected_bytes / 1e-3 / 1e9) < 1e-9


def test_efficiency_clamped_to_one():
    """An implausibly short time clamps efficiency at 1 (bandwidth.cpp:52)."""
    m = compute_bandwidth_csr(10_000, 10_000, 1_000_000, 1e-6, device=H100)
    assert m.achieved_gb_s > m.theoretical_gb_s
    assert m.efficiency == 1.0
