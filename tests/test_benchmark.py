"""Benchmark harness tests (C14) — mirrors ``tests/test_benchmark.cu``."""

import json

import pytest

from jax_spmv import (
    BenchmarkConfig,
    KernelType,
    SpMVConfig,
    BenchmarkResult,
    benchmark_csr,
    benchmark_ell,
    benchmark_from_json,
    benchmark_to_json,
    compare_device_cpu_csr,
    comparison_to_json,
    csr_from_dense,
    ell_from_dense,
)

# reduced iterations: the reference uses 50 (test_benchmark.cu:12); each of
# our "runs" is itself a chained loop, so a handful suffices for the
# invariants under test
FAST = BenchmarkConfig(num_warmup_runs=1, num_runs=4, iters_per_run=2)


class TestProperty13Completeness:
    """Property 13: results complete and ordered min<=avg<=max
    (test_benchmark.cu:17-61)."""

    @pytest.mark.parametrize("kernel_type", list(KernelType))
    def test_csr_benchmark_each_kernel(self, rng, kernel_type):
        """The harness times and verifies every kernel type's path."""
        csr = csr_from_dense(rng.dense_matrix(30, 20, 0.3))
        r = benchmark_csr(csr, rng.vector(20),
                          SpMVConfig(kernel_type=kernel_type), FAST)
        assert r.correct
        assert 0 < r.min_time_ms <= r.avg_time_ms <= r.max_time_ms
        assert r.plan_build_ms >= 0

    def test_csr_benchmark(self, rng):
        for _ in range(3):
            rows = rng.uniform_int(8, 40)
            cols = rng.uniform_int(8, 40)
            csr = csr_from_dense(rng.dense_matrix(rows, cols, 0.3))
            x = rng.vector(cols)
            r = benchmark_csr(csr, x, bench_config=FAST)
            assert r.num_runs == FAST.num_runs
            assert r.min_time_ms > 0
            assert r.min_time_ms <= r.avg_time_ms <= r.max_time_ms
            assert r.stddev_time_ms >= 0
            assert r.gflops >= 0 and r.bandwidth_gb_s >= 0

    def test_ell_benchmark(self, rng):
        ell = ell_from_dense(rng.dense_matrix(20, 20, 0.3))
        r = benchmark_ell(ell, rng.vector(20), bench_config=FAST)
        assert r.min_time_ms <= r.avg_time_ms <= r.max_time_ms
        assert r.num_runs == FAST.num_runs

    def test_comparison(self, rng):
        csr = csr_from_dense(rng.dense_matrix(24, 24, 0.3))
        comp = compare_device_cpu_csr(csr, rng.vector(24), bench_config=FAST)
        assert comp.device_result.avg_time_ms > 0
        assert comp.cpu_result.avg_time_ms > 0
        assert comp.speedup > 0


class TestProperty14JSON:
    """Property 14: JSON round-trip (test_benchmark.cu:65-103) and field
    presence (test_benchmark.cu:151-170)."""

    def test_roundtrip(self, rng):
        for _ in range(10):
            r = BenchmarkResult(
                name="t",
                execution_time_ms=rng.uniform(0, 100),
                gflops=rng.uniform(0, 1000),
                bandwidth_gb_s=rng.uniform(0, 1000),
                avg_time_ms=rng.uniform(0, 100),
                min_time_ms=rng.uniform(0, 100),
                max_time_ms=rng.uniform(0, 100),
                stddev_time_ms=rng.uniform(0, 10),
                num_runs=rng.uniform_int(1, 100),
            )
            back = benchmark_from_json(benchmark_to_json(r))
            assert back.num_runs == r.num_runs
            for f in ("execution_time_ms", "gflops", "bandwidth_gb_s",
                      "avg_time_ms", "min_time_ms", "max_time_ms",
                      "stddev_time_ms"):
                assert abs(getattr(back, f) - getattr(r, f)) < 1e-5

    def test_field_presence(self):
        text = benchmark_to_json(BenchmarkResult(name="x", num_runs=3))
        data = json.loads(text)
        for key in ("name", "execution_time_ms", "gflops", "bandwidth_gb_s",
                    "avg_time_ms", "min_time_ms", "max_time_ms",
                    "stddev_time_ms", "num_runs"):
            assert key in data

    def test_comparison_json(self, rng):
        csr = csr_from_dense(rng.dense_matrix(16, 16, 0.3))
        comp = compare_device_cpu_csr(csr, rng.vector(16), bench_config=FAST)
        data = json.loads(comparison_to_json(comp))
        # the reference's keys (benchmark.cu:204-213)
        assert "gpu" in data and "cpu" in data and "speedup" in data
