"""Run the SpMV main path once on a GPU and check every result.

    python chip_smoke.py              # one card: the phases below
    python chip_smoke.py --chips 4    # only the row-sharded path, 4 cards

Phases (each is fatal; nothing is caught and logged):

1. device: JAX's first device must be a GPU; prints its kind, the device
   count, the jax version and ``nvidia-smi``'s name and power limit;
2. headline: the 262,144 x 4,096 power-law matrix (~10.5M nnz) through
   ``spmv_csr`` under every ``KernelType`` and ``spmv_auto_config``;
3. web graph: the 1M-node graph through ``spmv_csr`` (auto), then
   ``pagerank`` on its column-normalised transition matrix against a NumPy
   power iteration of the same semantics;
4. stencil: the 512 x 512 5-point Laplacian through ``spmv_ell``;
5. CLI: ``jax_spmv.cli.main`` must return 0 with every result correct;
6. library kernels: the hand-written CUDA kernel's FFI target is
   registered and called in the compiled program (it has no interpret
   mode).

Every SpMV is compared with the NumPy oracle by the backward-error bound
``|y - y_ref| <= 1e-5 * (|A| |x|)`` per row (``spmv_matches``): the device
sums each row in another order than the oracle (warp shuffle trees,
atomics in XLA's scatter-add), so float32 rounding differs by up to a few
ulps of the row's magnitude.

The last line of standard output is the JSON result; it is printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np

import jax_spmv  # noqa: F401  (fails outside a checkout of the repository)
from jax_spmv.platform import enable_compile_cache, require_gpu

SPMV_REL_TOL = 1e-5
# PageRank: ranks of the device loop and of the NumPy loop agree to float32
# rounding propagated through a contraction of 0.85 per iteration, about
# 1e-6 relative; 1e-4 leaves room for the reordered row sums
PAGERANK_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def device_phase(want: int):
    import jax

    dev = require_gpu()
    count = len(jax.devices())
    check(count >= want, f"need {want} GPUs, JAX sees {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[device] kind={dev.device_kind} count={count} "
        f"jax={jax.__version__}")
    for line in smi.splitlines():
        log(f"[device] nvidia-smi: {line}")
    return dev, count, smi.splitlines()[0]


def oracle_ok(y, A, x) -> bool:
    from jax_spmv.utils.testing import spmv_matches

    return spmv_matches(np.asarray(y), A, x, rel_tol=SPMV_REL_TOL)


def spmv_phase(name: str, A, x, configs, card: str) -> None:
    from jax_spmv import KernelType, spmv_csr

    stats = A.compute_stats()
    log(f"[{name}] {A.num_rows}x{A.num_cols} nnz={A.nnz} "
        f"avg={stats.avg_nnz_per_row:.2f} skew={stats.skewness:.1f}")
    for label, cfg in configs:
        r = spmv_csr(A, x, cfg, measure=True)
        check(r.error_code == 0, f"{name}/{label}: error_code "
              f"{r.error_code}")
        check(r.y.shape == (A.num_rows,), f"{name}/{label}: shape")
        check(oracle_ok(r.y, A, x), f"{name}/{label}: differs from oracle")
        log(f"[{name}] {label:10s} ({KernelType(cfg.kernel_type).name}) -> "
            f"{r.kernel:10s} {r.elapsed_ms * 1e3:9.2f} us "
            f"{r.bandwidth_gb_s:8.1f} GB/s  ok  | {card}")


def numpy_pagerank(P, damping: float, tol: float, max_it: int):
    """The reference loop (pagerank.cu:50-153) in float32 with SciPy's
    sparse product: dangling mass spread evenly, L2 residual, final
    renormalisation."""
    import scipy.sparse as sp

    n = P.num_rows
    M = sp.csr_matrix((P.values, P.col_indices, P.row_ptrs), shape=(n, n))
    colsum = np.zeros(n, np.float32)
    np.add.at(colsum, P.col_indices, P.values)
    dangling = (colsum == 0.0).astype(np.float32)
    r = np.full(n, 1.0 / n, np.float32)
    it, resid = 0, np.inf
    while it < max_it and resid >= tol:
        r_new = (np.float32(damping) * (M @ r)
                 + np.float32(damping) * np.float32(dangling @ r) / n
                 + np.float32((1.0 - damping) / n)).astype(np.float32)
        resid = float(np.sqrt(np.sum((r_new - r) ** 2)))
        r, it = r_new, it + 1
    return r / r.sum(), it, resid < tol


def pagerank_phase(W, card: str) -> None:
    from jax_spmv import PageRankConfig, pagerank
    from jax_spmv.utils.testing import column_normalized

    P = column_normalized(W)
    cfg = PageRankConfig()
    t0 = time.perf_counter()
    res = pagerank(P, cfg)
    secs = time.perf_counter() - t0
    check(res.error_code == 0, f"pagerank: error_code {res.error_code}")
    ranks = res.ranks_host()
    check(ranks.shape == (P.num_rows,) and np.all(np.isfinite(ranks)),
          "pagerank: ranks not finite or wrong shape")
    ref, ref_it, ref_conv = numpy_pagerank(
        P, cfg.damping_factor, cfg.tolerance, cfg.max_iterations)
    log(f"[pagerank] {P.num_rows} nodes: {res.iterations} iterations "
        f"(NumPy {ref_it}), converged={res.converged} (NumPy {ref_conv}), "
        f"residual {res.final_residual:.3e}, first call {secs:.2f} s "
        f"| {card}")
    check(res.converged and ref_conv, "pagerank: did not converge")
    check(res.iterations == ref_it, "pagerank: iteration counts differ")
    err = np.max(np.abs(ranks - ref) / ref)
    log(f"[pagerank] max relative rank difference {err:.3e} "
        f"(limit {PAGERANK_RTOL})")
    check(err <= PAGERANK_RTOL, "pagerank: ranks differ from NumPy")


def stencil_phase(card: str) -> None:
    from jax_spmv import spmv_ell
    from jax_spmv.ell import ELLMatrix
    from jax_spmv.utils import workloads
    from jax_spmv.utils.testing import RandomGenerator

    S = workloads.stencil(512)
    ell = ELLMatrix.from_csr(S)
    x = RandomGenerator(3).vector(S.num_cols)
    r = spmv_ell(ell, x, measure=True)
    check(r.error_code == 0, f"stencil: error_code {r.error_code}")
    check(oracle_ok(r.y, S, x), "stencil: differs from oracle")
    log(f"[stencil] 512x512 5-point via spmv_ell -> {r.kernel}: "
        f"{r.elapsed_ms * 1e3:.2f} us {r.bandwidth_gb_s:.1f} GB/s  ok  "
        f"| {card}")


def cli_phase() -> None:
    from jax_spmv.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--runs", "3"])
    out = buf.getvalue()
    check(rc == 0, f"cli: exit code {rc}")
    check("correct=True" in out and "correct=False" not in out,
          "cli: a kernel result was wrong")
    log(f"[cli] exit 0, {out.count('correct=True')} correct sweeps")


def library_kernel_phase(A, x) -> None:
    """Every route in use on this card really runs its compiled kernel."""
    from jax_spmv import KernelType, SpMVConfig
    from jax_spmv.kernels import csr_vector
    from jax_spmv.spmv import CSR_PATHS, csr_path

    routes = {csr_path(kt) for kt in KernelType}
    for name in sorted(routes):
        fn, args = CSR_PATHS[name](A, SpMVConfig())
        hlo = fn.lower(*args, x).compile().as_text()
        if name == "csr_vector":
            check(csr_vector.is_registered(), "csr_vector: not registered")
            check(f'custom_call_target="{csr_vector.TARGET}"' in hlo,
                  "csr_vector: FFI call missing from the compiled HLO")
        log(f"[kernels] {name}: compiled for the card, "
            f"custom calls {hlo.count('custom-call(')}")


def sharded_phase(n_dev: int) -> None:
    import jax

    from jax_spmv import (PageRankConfig, pagerank, spmv_auto_config,
                          spmv_csr)
    from jax_spmv.pagerank import find_dangling_mask
    from jax_spmv.parallel import (make_row_mesh, pagerank_sharded,
                                   shard_csr, spmv_csr_sharded)
    from jax_spmv.utils import workloads
    from jax_spmv.utils.testing import RandomGenerator, column_normalized

    mesh = make_row_mesh(n_dev)
    for name, make in (("headline", workloads.headline),
                       ("web_graph_1m", workloads.web_graph)):
        A = make()
        x = RandomGenerator(5).vector(A.num_cols)
        sharded = shard_csr(A, mesh)
        devs = {s.device for s in sharded.values.addressable_shards}
        check(len(devs) == n_dev, f"{name}: shards on {len(devs)} devices")
        y = jax.block_until_ready(spmv_csr_sharded(sharded, x, mesh))
        check(oracle_ok(y, A, x), f"{name}: sharded differs from oracle")
        single = spmv_csr(A, x, spmv_auto_config(A))
        check(single.error_code == 0, f"{name}: one-card error")
        diff = float(np.max(np.abs(np.asarray(y) - single.y_host())))
        log(f"[sharded] {name}: {n_dev} shards on {sorted(map(str, devs))}, "
            f"nnz imbalance {sharded.nnz_imbalance:.3f}, oracle ok, "
            f"max |sharded - one card| {diff:.3e}")
        if name == "web_graph_1m":
            P = column_normalized(A)
            sp_ = shard_csr(P, mesh)
            dist = pagerank_sharded(sp_, find_dangling_mask(P),
                                    PageRankConfig(), mesh)
            one = pagerank(P, PageRankConfig())
            check(dist.converged and one.converged, "pagerank: not converged")
            check(dist.iterations == one.iterations,
                  "pagerank: sharded and one-card iterations differ")
            err = np.max(np.abs(dist.ranks_host() - one.ranks_host())
                         / one.ranks_host())
            check(err <= PAGERANK_RTOL, "pagerank: sharded ranks differ")
            log(f"[sharded] pagerank_sharded: {dist.iterations} iterations, "
                f"max relative difference to one card {err:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="4: run only the row-sharded path on 4 cards")
    args = ap.parse_args(argv)
    enable_compile_cache()
    t0 = time.perf_counter()
    dev, count, card = device_phase(args.chips)
    if args.chips > 1:
        sharded_phase(args.chips)
    else:
        from jax_spmv import KernelType, SpMVConfig, spmv_auto_config
        from jax_spmv.utils import workloads
        from jax_spmv.utils.testing import RandomGenerator

        A = workloads.headline()
        x = RandomGenerator(1).vector(A.num_cols)
        configs = [(kt.name.lower(), SpMVConfig(kernel_type=kt))
                   for kt in KernelType]
        configs.append(("auto", spmv_auto_config(A)))
        spmv_phase("headline", A, x, configs, card)
        library_kernel_phase(A, x)
        W = workloads.web_graph()
        xw = RandomGenerator(2).vector(W.num_cols)
        spmv_phase("web_graph_1m", W, xw, [("auto", spmv_auto_config(W))],
                   card)
        pagerank_phase(W, card)
        stencil_phase(card)
        cli_phase()
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s "
        f"| {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
