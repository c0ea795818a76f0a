"""Benchmark CLI (C16) — the re-build of ``benchmarks/main.cu``.

Reproduces the reference demo: device info banner (``main.cu:151-156``), a
3-kernel sweep on a random 1000x1000 density-0.05 matrix, seed 42
(``main.cu:16-80``), a device-vs-CPU comparison (``main.cu:73-77``), and a
100-node PageRank with top-10 extraction (``main.cu:82-144``) — plus an
idiomatic argparse layer the reference lacks (SURVEY §5 'Config/flag
system').  Installed as the ``jax-spmv-benchmark`` console script; also
runnable as ``python benchmarks/main.py`` from a checkout.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import jax

from . import (
    BenchmarkConfig,
    KernelType,
    PageRankConfig,
    SpMVConfig,
    benchmark_csr,
    benchmark_to_json,
    compare_device_cpu_csr,
    comparison_to_json,
    csr_from_dense,
    get_peak_bandwidth,
    pagerank,
    pagerank_top_k,
    spmv_auto_config,
)
from .platform import enable_compile_cache
from .utils.testing import RandomGenerator


def print_device_info():
    dev = jax.devices()[0]
    print("=" * 60)
    print("Device Information")
    print("=" * 60)
    print(f"  Device:        {dev.device_kind}")
    print(f"  Platform:      {dev.platform}")
    peak = get_peak_bandwidth(dev)
    print("  Peak HBM BW:   "
          + (f"{peak:.0f} GB/s" if peak else "not published"))
    print()


def benchmark_spmv(rows: int, cols: int, density: float, runs: int,
                   emit_json: bool, matrix: str | None = None):
    """The reference 3-kernel sweep (main.cu:16-80).  ``matrix`` loads a
    Matrix Market ``.mtx`` file (SuiteSparse interchange) instead of the
    generated matrix."""
    rng = RandomGenerator(42)
    if matrix:
        from .io.matrix_market import load_matrix_market

        csr = load_matrix_market(matrix)
        rows, cols = csr.num_rows, csr.num_cols
        density = csr.nnz / max(rows * cols, 1)
        src = matrix
    else:
        dense = rng.dense_matrix(rows, cols, density)
        csr = csr_from_dense(dense)
        src = "generated"
    x = rng.vector(cols)
    bc = BenchmarkConfig(num_runs=runs)

    print(f"SpMV sweep: {rows}x{cols} ({src}), density {density:.4g}, "
          f"nnz {csr.nnz}")
    print("-" * 60)
    results = {}
    for kt in (KernelType.SCALAR_CSR, KernelType.VECTOR_CSR,
               KernelType.MERGE_PATH):
        r = benchmark_csr(csr, x, SpMVConfig(kernel_type=kt), bc,
                          name=kt.name.lower())
        results[kt.name] = r
        print(f"  {kt.name:12s}: avg {r.avg_time_ms:9.4f} ms  "
              f"{r.gflops:8.2f} GFLOP/s  {r.bandwidth_gb_s:8.2f} GB/s  "
              f"correct={r.correct}")
    auto = spmv_auto_config(csr)
    print(f"  auto-selector picks: {KernelType(auto.kernel_type).name}")

    comp = compare_device_cpu_csr(csr, x,
                                  SpMVConfig(kernel_type=auto.kernel_type),
                                  bc)
    print(f"  device vs CPU speedup: {comp.speedup:.2f}x")
    if emit_json:
        print(comparison_to_json(comp))
        for name, r in results.items():
            print(benchmark_to_json(r))
    print()


def benchmark_pagerank(n: int, emit_json: bool):
    """PageRank demo (main.cu:82-144)."""
    rng = RandomGenerator(42)
    adj = (rng.rng.random((n, n)) < 0.05).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    col_sums = adj.sum(axis=0)          # column normalization, main.cu:102-112
    nz = col_sums > 0
    adj[:, nz] /= col_sums[nz]
    csr = csr_from_dense(adj)

    cfg = PageRankConfig()
    res = pagerank(csr, cfg)
    print(f"PageRank: {n} nodes, {csr.nnz} edges")
    print(f"  iterations: {res.iterations}, converged: {res.converged}, "
          f"residual: {res.final_residual:.2e}")
    top = pagerank_top_k(res, n, 10)
    print("  top-10 nodes:")
    for t in top:
        print(f"    node {t.node_id:6d}: {t.rank:.6f}")
    if emit_json:
        print(json.dumps({
            "iterations": res.iterations,
            "converged": res.converged,
            "final_residual": res.final_residual,
            "top_k": [{"node_id": t.node_id, "rank": t.rank} for t in top],
        }, indent=2))
    print()


def main(argv=None):
    p = argparse.ArgumentParser(description="jax_spmv benchmark demo")
    p.add_argument("--rows", type=int, default=1000)
    p.add_argument("--cols", type=int, default=1000)
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--pagerank-nodes", type=int, default=100)
    p.add_argument("--json", action="store_true", help="emit JSON results")
    p.add_argument("--skip-pagerank", action="store_true")
    p.add_argument("--matrix", type=str, default=None, metavar="FILE.mtx",
                   help="benchmark a Matrix Market file instead of a "
                        "generated matrix")
    args = p.parse_args(argv)

    enable_compile_cache()
    print_device_info()
    benchmark_spmv(args.rows, args.cols, args.density, args.runs, args.json,
                   matrix=args.matrix)
    if not args.skip_pagerank:
        benchmark_pagerank(args.pagerank_nodes, args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
