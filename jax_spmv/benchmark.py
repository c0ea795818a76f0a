"""Benchmark harness (C14).

Re-design of the reference harness (``include/spmv/benchmark.h``,
``src/benchmark.cu``): warmup runs then timed runs, avg/min/max/sample-stddev
statistics (n−1 divisor, ``benchmark.cu:10-19``), device-vs-CPU comparison
with speedup = cpu_avg/device_avg (``benchmark.cu:180-182``), and JSON
export/import with the reference's exact field names
(``benchmark.cu:187-237``).

Timing protocol: each timed "run" is the slope between two chained in-jit
loops of ``iters_per_run`` and ``3 * iters_per_run`` kernel executions
(:mod:`jax_spmv.timing`).  The CPU leg is timed with a monotonic host
clock — fixing the reference's quirk of wrapping a host function in
cudaEvents (``benchmark.cu:152-166``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np

from .bandwidth import compute_bandwidth_csr, compute_bandwidth_ell
from .csr import CSRMatrix
from .ell import ELLMatrix
from .ops import spmv_cpu_csr, spmv_cpu_ell
from .spmv import SpMVConfig, _resolve_csr_kernel, _resolve_ell_kernel, \
    KernelType
from .timing import time_runs


@dataclasses.dataclass
class BenchmarkConfig:
    """Reference ``BenchmarkConfig`` (``benchmark.h:34-40``) plus the
    chained-loop depth."""

    num_warmup_runs: int = 5
    num_runs: int = 20
    compare_cpu: bool = True
    iters_per_run: int | None = None   # None → auto-calibrated


@dataclasses.dataclass
class BenchmarkResult:
    """Reference ``BenchmarkResult`` (``benchmark.h:13-31``)."""

    name: str = ""
    execution_time_ms: float = 0.0   # last run
    gflops: float = 0.0
    bandwidth_gb_s: float = 0.0
    avg_time_ms: float = 0.0
    min_time_ms: float = 0.0
    max_time_ms: float = 0.0
    stddev_time_ms: float = 0.0
    num_runs: int = 0
    # additions beyond the reference struct (benchmark.h:13-31):
    # the timed kernel's output is checked against the CPU oracle so perf
    # claims are self-verifying, and the one-time plan/transfer cost the
    # reference never measures is reported alongside the per-call time.
    correct: bool = True
    plan_build_ms: float = 0.0


@dataclasses.dataclass
class ComparisonResult:
    """Reference ``ComparisonResult`` (``benchmark.h:24-31``)."""

    device_result: BenchmarkResult = dataclasses.field(
        default_factory=BenchmarkResult)
    cpu_result: BenchmarkResult = dataclasses.field(
        default_factory=BenchmarkResult)
    speedup: float = 0.0


def compute_stddev(times_ms: list[float], avg: float) -> float:
    """Sample standard deviation, n−1 divisor (``benchmark.cu:10-19``)."""
    if len(times_ms) < 2:
        return 0.0
    var = sum((t - avg) ** 2 for t in times_ms) / (len(times_ms) - 1)
    return math.sqrt(var)


def _stats(name: str, times_ms: list[float], nnz_flops: int,
           bandwidth_fn) -> BenchmarkResult:
    r = BenchmarkResult(name=name, num_runs=len(times_ms))
    if not times_ms:
        return r
    r.execution_time_ms = times_ms[-1]
    r.avg_time_ms = sum(times_ms) / len(times_ms)
    r.min_time_ms = min(times_ms)
    r.max_time_ms = max(times_ms)
    r.stddev_time_ms = compute_stddev(times_ms, r.avg_time_ms)
    if r.avg_time_ms > 0:
        r.gflops = 2.0 * nnz_flops / (r.avg_time_ms * 1e-3) / 1e9
        r.bandwidth_gb_s = bandwidth_fn(r.avg_time_ms).achieved_gb_s
    return r


def benchmark_csr(A: CSRMatrix, x, config: SpMVConfig | None = None,
                  bench_config: BenchmarkConfig | None = None,
                  name: str = "csr_spmv") -> BenchmarkResult:
    """Warmup + timed protocol over the CSR device kernel
    (reference ``benchmark_csr``, ``benchmark.cu:21-75``)."""
    import jax.numpy as jnp

    bc = bench_config or BenchmarkConfig()
    cfg = config or SpMVConfig()
    kernel_type = KernelType(cfg.kernel_type)
    t_plan = time.perf_counter()
    _, fn, args = _resolve_csr_kernel(A, kernel_type, cfg)
    plan_ms = (time.perf_counter() - t_plan) * 1e3
    xd = jnp.asarray(np.asarray(x, np.float32))
    # self-checking perf: verify the timed kernel's output against the CPU
    # oracle once before timing (the reference's compare path computes
    # both; its pure-benchmark path never verifies — gap closed here)
    x_host = np.asarray(x, np.float32)
    y_ref = np.zeros(A.num_rows, np.float32)
    spmv_cpu_csr(A, x_host, y_ref)
    y_dev = np.asarray(fn(*args, xd))
    correct = bool(np.allclose(y_dev, y_ref, rtol=1e-4, atol=1e-5))
    times = time_runs(fn, *args, xd,
                      num_runs=bc.num_runs,
                      iters_per_run=bc.iters_per_run,
                      warmup_runs=1 if bc.num_warmup_runs else 0)
    r = _stats(name, [t * 1e3 for t in times], A.nnz,
               lambda ms: compute_bandwidth_csr(A.num_rows, A.num_cols,
                                                A.nnz, ms))
    r.correct = correct
    r.plan_build_ms = plan_ms
    return r


def benchmark_ell(A: ELLMatrix, x, config: SpMVConfig | None = None,
                  bench_config: BenchmarkConfig | None = None,
                  name: str = "ell_spmv") -> BenchmarkResult:
    """Reference ``benchmark_ell`` (``benchmark.cu:77-126``)."""
    import jax.numpy as jnp

    bc = bench_config or BenchmarkConfig()
    # resolve exactly like spmv_ell so the harness times what the
    # dispatch serves
    t_plan = time.perf_counter()
    _, fn, args = _resolve_ell_kernel(A)
    plan_ms = (time.perf_counter() - t_plan) * 1e3
    xd = jnp.asarray(np.asarray(x, np.float32))
    x_host = np.asarray(x, np.float32)
    y_ref = np.zeros(A.num_rows, np.float32)
    spmv_cpu_ell(A, x_host, y_ref)
    y_dev = np.asarray(fn(*args, xd))
    correct = bool(np.allclose(y_dev, y_ref, rtol=1e-4, atol=1e-5))
    times = time_runs(fn, *args, xd,
                      num_runs=bc.num_runs,
                      iters_per_run=bc.iters_per_run,
                      warmup_runs=1 if bc.num_warmup_runs else 0)
    r = _stats(name, [t * 1e3 for t in times], A.nnz,
               lambda ms: compute_bandwidth_ell(A.num_rows, A.num_cols,
                                                A.max_nnz_per_row, ms))
    r.correct = correct
    r.plan_build_ms = plan_ms
    return r


def compare_device_cpu_csr(A: CSRMatrix, x, config: SpMVConfig | None = None,
                           bench_config: BenchmarkConfig | None = None
                           ) -> ComparisonResult:
    """Device-vs-CPU comparison (reference ``compare_gpu_cpu_csr``,
    ``benchmark.cu:128-185``); CPU leg timed with a monotonic host clock."""
    bc = bench_config or BenchmarkConfig()
    comp = ComparisonResult()
    comp.device_result = benchmark_csr(A, x, config, bc, name="device_csr")

    x_host = np.asarray(x, np.float32)
    y_host = np.zeros(A.num_rows, np.float32)
    cpu_times = []
    spmv_cpu_csr(A, x_host, y_host)  # warmup
    for _ in range(bc.num_runs):
        t0 = time.perf_counter()
        spmv_cpu_csr(A, x_host, y_host)
        cpu_times.append((time.perf_counter() - t0) * 1e3)
    comp.cpu_result = _stats("cpu_csr", cpu_times, A.nnz,
                             lambda ms: compute_bandwidth_csr(
                                 A.num_rows, A.num_cols, A.nnz, ms))
    if comp.device_result.avg_time_ms > 0:
        comp.speedup = comp.cpu_result.avg_time_ms / comp.device_result.avg_time_ms
    return comp


# ---- JSON (reference field names, benchmark.cu:187-237) ----

def benchmark_to_json(result: BenchmarkResult) -> str:
    """Reference ``benchmark_to_json`` (``benchmark.cu:187-202``): same keys,
    fixed 6-decimal floats."""
    f = lambda v: f"{v:.6f}"
    return (
        "{\n"
        f'  "name": "{result.name}",\n'
        f'  "execution_time_ms": {f(result.execution_time_ms)},\n'
        f'  "gflops": {f(result.gflops)},\n'
        f'  "bandwidth_gb_s": {f(result.bandwidth_gb_s)},\n'
        f'  "avg_time_ms": {f(result.avg_time_ms)},\n'
        f'  "min_time_ms": {f(result.min_time_ms)},\n'
        f'  "max_time_ms": {f(result.max_time_ms)},\n'
        f'  "stddev_time_ms": {f(result.stddev_time_ms)},\n'
        f'  "num_runs": {result.num_runs},\n'
        f'  "correct": {"true" if result.correct else "false"},\n'
        f'  "plan_build_ms": {f(result.plan_build_ms)}\n'
        "}"
    )


def comparison_to_json(result: ComparisonResult) -> str:
    """Reference ``comparison_to_json`` (``benchmark.cu:204-213``), with
    the reference's ``"gpu"`` key for the device result."""
    return (
        "{\n"
        f'  "gpu": {benchmark_to_json(result.device_result)},\n'
        f'  "cpu": {benchmark_to_json(result.cpu_result)},\n'
        f'  "speedup": {result.speedup:.6f}\n'
        "}"
    )


def benchmark_from_json(text: str) -> BenchmarkResult:
    """Parse a result back (reference ``benchmark_from_json``,
    ``benchmark.cu:215-237``, replaced by a real JSON parser)."""
    data = json.loads(text)
    r = BenchmarkResult()
    r.name = data.get("name", "")
    r.execution_time_ms = float(data.get("execution_time_ms", 0.0))
    r.gflops = float(data.get("gflops", 0.0))
    r.bandwidth_gb_s = float(data.get("bandwidth_gb_s", 0.0))
    r.avg_time_ms = float(data.get("avg_time_ms", 0.0))
    r.min_time_ms = float(data.get("min_time_ms", 0.0))
    r.max_time_ms = float(data.get("max_time_ms", 0.0))
    r.stddev_time_ms = float(data.get("stddev_time_ms", 0.0))
    r.num_runs = int(data.get("num_runs", 0))
    r.correct = bool(data.get("correct", True))
    r.plan_build_ms = float(data.get("plan_build_ms", 0.0))
    return r
