"""Time the public dispatch on a GPU for the repository's four matrices.

* headline: 262,144 x 4,096 power-law CSR (~10.5M nnz) via ``spmv_csr``
  under ``spmv_auto_config``;
* stencil: the 512 x 512 5-point Laplacian via ``spmv_ell``;
* web graph: the 1M-node graph via ``spmv_csr`` (auto);
* PageRank: 30 iterations on the 262,144-node web graph's column-normalised
  transition matrix, host wall clock per iteration.

Every SpMV result is checked against the NumPy oracle first.  Diagnostics
go to stderr; stdout gets one JSON line naming the device, its power limit
and each time.  Needs a GPU: without one, or on any failure, it exits
non-zero.

Usage: python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _spmv(name: str, fn, A, x, checked) -> dict:
    from jax_spmv.utils.testing import spmv_matches

    r = fn(A, x)
    if r.error_code != 0 or not spmv_matches(r.y_host(), checked, x,
                                              rel_tol=1e-5):
        raise RuntimeError(f"{name}: error {r.error_code} or wrong result")
    log(f"{name}: {r.kernel} {r.elapsed_ms * 1e3:.2f} us, "
        f"{r.bandwidth_gb_s:.1f} GB/s (reference byte model), "
        f"{r.gflops:.2f} GFLOP/s")
    return {"kernel": r.kernel, "us": r.elapsed_ms * 1e3,
            "gb_s": r.bandwidth_gb_s, "efficiency": r.bandwidth.efficiency}


def main() -> int:
    from jax_spmv.platform import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()
    from jax_spmv import (PageRankConfig, pagerank, spmv_auto_config,
                          spmv_csr, spmv_ell)
    from jax_spmv.ell import ELLMatrix
    from jax_spmv.utils import workloads
    from jax_spmv.utils.testing import RandomGenerator, column_normalized

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {dev.device_kind} | {card}")
    rng = RandomGenerator(11)
    auto = lambda A, x: spmv_csr(A, x, spmv_auto_config(A),  # noqa: E731
                                 measure=True, measure_samples=5)

    A = workloads.headline()
    head = _spmv("headline", auto, A, rng.vector(A.num_cols), A)
    S = workloads.stencil(512)
    sten = _spmv("stencil_ell", lambda M, x: spmv_ell(
        ELLMatrix.from_csr(M), x, measure=True, measure_samples=5),
        S, rng.vector(S.num_cols), S)
    W = workloads.web_graph()
    web = _spmv("web_graph_1m", auto, W, rng.vector(W.num_cols), W)

    P = column_normalized(workloads.web_graph(262_144))
    cfg = PageRankConfig(max_iterations=30, tolerance=0.0)
    pagerank(P, cfg)                                   # upload + compile
    t0 = time.perf_counter()
    res = pagerank(P, cfg)
    pr_ms = (time.perf_counter() - t0) * 1e3 / max(res.iterations, 1)
    if res.error_code != 0 or not np.all(np.isfinite(res.ranks_host())):
        raise RuntimeError("pagerank failed")
    log(f"pagerank_262k: {res.iterations} iterations, {pr_ms:.3f} ms/iter")

    print(json.dumps({
        "metric": "headline_csr_spmv_bandwidth",
        "value": head["gb_s"],
        "unit": "GB/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "card": card},
        "detail": {"headline": head, "stencil_ell": sten,
                   "web_graph_1m": web,
                   "pagerank_262k_ms_per_iter": pr_ms},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
