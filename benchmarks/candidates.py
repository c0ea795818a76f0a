"""Time the CSR kernel candidates on the GPU at the repository's shapes.

For each matrix (the 10.5M-nnz power-law headline, the 1M-node web graph
and the 512x512 5-point stencil as CSR) and each implementation in
``jax_spmv.spmv.CSR_PATHS``, plus cuSPARSE through
``jax.experimental.sparse.BCSR`` (:func:`bcsr_path`, not in the dispatch:
it lost here) and the slot-major ELL kernel on the stencil, this script

* checks the result against the NumPy oracle,
* times the steady state with the chained-loop slope
  (``jax_spmv.timing.time_jitted``, median of 5),
* traces ``--trace-calls`` calls with ``jax.profiler`` and sums the device
  time of the events on the GPU's stream lines, per call,
* reads that device time against the card's published peak and against
  the read rate this card reaches on a 256 MB reduction, using the bytes
  the path reads (:func:`path_bytes`);
* traces the CUDA kernel at every lane-group width (2..32 lanes per row)
  to check the width :func:`jax_spmv.kernels.csr_vector.threads_per_row`
  picks from the mean row length.

Usage: python benchmarks/candidates.py [--out results/candidates.json]
It needs a GPU and exits non-zero without one or when a candidate fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def log(*a):
    print(*a, flush=True)


def path_bytes(name: str, A, dev) -> int:
    """Bytes a path moves to and from device memory per call, counting x
    and y once: its compulsory traffic, not cache behaviour."""
    nnz, nnz_pad = A.nnz, dev.nnz_pad
    rows_pad = dev.rows_pad
    xy = 4 * A.num_cols + 4 * rows_pad
    if name == "flat":      # value, column, row id over the padded extent
        return 12 * nnz_pad + xy
    if name == "bcsr":      # zeroing pass (read + write 8 B) + cuSPARSE
        return 16 * nnz_pad + 8 * nnz + 4 * (rows_pad + 1) + xy
    if name == "csr_vector":
        return 8 * nnz + 4 * (rows_pad + 1) + xy
    raise ValueError(name)


def bcsr_path(A):
    """cuSPARSE's CSR matvec: ``jax.experimental.sparse.BCSR`` lowers to it
    on CUDA when ``jax_bcoo_cusparse_lowering`` is on, and falls back to a
    generic gather/scatter without an error when it cannot; the check on
    the compiled HLO makes sure cuSPARSE is what gets timed."""
    import jax
    from jax.experimental import sparse as jsparse

    from jax_spmv.spmv import _cols_pad
    from jax_spmv.kernels.scalar import pad_x

    jax.config.update("jax_bcoo_cusparse_lowering", True)

    @jax.jit
    def run(dev, x):
        xp = pad_x(x, _cols_pad(dev.num_cols))
        mat = jsparse.BCSR((dev.values, dev.col_indices, dev.row_ptrs),
                           shape=(dev.rows_pad, xp.shape[0]))
        return (mat @ xp)[: dev.num_rows]

    dev = A.to_device()
    x = np.zeros(A.num_cols, np.float32)
    if "cusparse_csr_matvec_ffi" not in run.lower(dev, x).compile().as_text():
        raise RuntimeError("BCSR did not lower to cuSPARSE")
    return run, (dev,)


def device_time_per_call(fn, args, calls: int, log_dir: str) -> dict:
    """Trace ``calls`` calls of ``fn(*args)``; sum device event time on
    the GPU planes' stream lines, per call, and name the top kernels."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(log_dir):
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    lines, kernels, total = {}, {}, 0
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            dur = 0
            for ev in line.events:
                dur += ev.duration_ns
                if "Stream" in line.name:
                    kernels[ev.name] = kernels.get(ev.name, 0) \
                        + ev.duration_ns
            lines[f"{plane.name}|{line.name}"] = dur / calls
            if "Stream" in line.name:
                total += dur
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"device_us_per_call": total / calls / 1e3,
            "lines_ns_per_call": lines,
            "top_kernels_us_per_call": {k: v / calls / 1e3 for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/candidates.json")
    ap.add_argument("--trace-calls", type=int, default=20)
    args = ap.parse_args()

    from jax_spmv.platform import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev0 = require_gpu()
    import jax

    from jax_spmv import SpMVConfig
    from jax_spmv.bandwidth import (_csr_bytes, _ell_bytes,
                                    get_peak_bandwidth,
                                    measured_stream_bandwidth)
    from jax_spmv.csr import CSRMatrix
    from jax_spmv.ell import ELLMatrix
    from jax_spmv.kernels import csr_vector
    from jax_spmv.spmv import CSR_PATHS, _resolve_ell_kernel
    from jax_spmv.timing import time_jitted
    from jax_spmv.utils import workloads
    from jax_spmv.utils.testing import RandomGenerator, spmv_matches

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    peak = get_peak_bandwidth(dev0)
    log(f"card: {smi} | jax device_kind: {dev0.device_kind} | "
        f"peak {peak} GB/s | jax {jax.__version__}")
    t0 = time.perf_counter()
    csr_vector.build()
    log(f"csr_vector library ready in {time.perf_counter() - t0:.1f} s")

    read_gbs = measured_stream_bandwidth(dev0)
    log(f"measured read rate (256 MB sum): {read_gbs:.1f} GB/s")
    report = {"card": smi, "device_kind": dev0.device_kind,
              "peak_gb_s": peak, "measured_read_gb_s": read_gbs,
              "shapes": {}}
    failed = []
    shapes = [("headline", workloads.headline),
              ("web_graph_1m", workloads.web_graph),
              ("stencil_512", workloads.stencil)]
    trace_root = os.path.join(os.path.dirname(args.out) or ".", "traces")
    for shape, make in shapes:
        t0 = time.perf_counter()
        A = make()
        x = RandomGenerator(7).vector(A.num_cols)
        stats = A.compute_stats()
        log(f"\n[{shape}] {A.num_rows}x{A.num_cols} nnz={A.nnz} "
            f"avg={stats.avg_nnz_per_row:.2f} max={stats.max_nnz_per_row} "
            f"skew={stats.skewness:.1f} (built in "
            f"{time.perf_counter() - t0:.1f} s)")
        model = _csr_bytes(A.num_rows, A.num_cols, A.nnz)
        entry = {"nnz": A.nnz, "rows": A.num_rows, "cols": A.num_cols,
                 "model_bytes": model, "paths": {}}
        xd = jax.device_put(x)
        cands = [*CSR_PATHS, "bcsr"]
        if shape == "stencil_512":
            cands.append("ell")
        for name in cands:
            fresh = CSRMatrix(A.num_rows, A.num_cols, A.values,
                              A.col_indices, A.row_ptrs)
            t_setup = time.perf_counter()
            try:
                if name == "ell":
                    ell = ELLMatrix.from_csr(fresh)
                    _, fn, fargs = _resolve_ell_kernel(ell)
                    nbytes = _ell_bytes(A.num_rows, A.num_cols,
                                        ell.max_nnz_per_row)
                else:
                    fn, fargs = bcsr_path(fresh) if name == "bcsr" else \
                        CSR_PATHS[name](fresh, SpMVConfig())
                    nbytes = path_bytes(name, A, fresh.to_device())
                y = np.asarray(jax.block_until_ready(fn(*fargs, xd)))
                setup_s = time.perf_counter() - t_setup
                ok = spmv_matches(y, A, x, rel_tol=1e-5)
                secs = time_jitted(fn, *fargs, xd, samples=5,
                                   estimator="median")
                tr = device_time_per_call(
                    fn, (*fargs, xd), args.trace_calls,
                    os.path.join(trace_root, f"{shape}_{name}"))
            except Exception as e:  # record, go on, exit non-zero at the end
                log(f"  {name:11s} FAILED {type(e).__name__}: {e}")
                failed.append(f"{shape}/{name}")
                continue
            dev_s = tr["device_us_per_call"] * 1e-6
            row = {"correct": bool(ok), "setup_s": setup_s,
                   "wall_us": secs * 1e6,
                   "device_us": tr["device_us_per_call"],
                   "path_bytes": nbytes,
                   "model_gb_s_wall": model / secs / 1e9,
                   "path_gb_s_device": nbytes / dev_s / 1e9 if dev_s else None,
                   "roofline_share_device": (nbytes / (peak * 1e9)) / dev_s
                   if dev_s and peak else None,
                   "share_of_measured_read": (nbytes / (read_gbs * 1e9))
                   / dev_s if dev_s else None,
                   "trace": tr}
            entry["paths"][name] = row
            if not ok:
                failed.append(f"{shape}/{name} (wrong result)")
            log(f"  {name:11s} correct={ok} wall {secs * 1e6:9.2f} us  "
                f"device {tr['device_us_per_call']:9.2f} us  "
                f"model {row['model_gb_s_wall']:7.1f} GB/s  "
                f"path bytes {nbytes / 1e6:7.1f} MB -> "
                f"{(row['path_gb_s_device'] or 0):7.1f} GB/s device, "
                f"roofline {(row['roofline_share_device'] or 0):.3f} "
                f"(of measured read {row['share_of_measured_read'] or 0:.3f})"
                f"  setup {setup_s:.2f} s")
            log(f"    top kernels: {tr['top_kernels_us_per_call']}")
        entry["csr_vector_width_sweep"] = sweep = {}
        base = CSR_PATHS["csr_vector"](A, SpMVConfig())[1][0]
        for tpr in (1, 2, 4, 8, 16, 32):
            thr = csr_vector.long_row_threshold(tpr)
            plan = dataclasses.replace(
                base, threads_per_row=tpr, long_row=thr,
                long_rows=jax.device_put(
                    csr_vector.long_rows(A.row_ptrs, thr)))
            fn = CSR_PATHS["csr_vector"](A, SpMVConfig())[0]
            ok = spmv_matches(np.asarray(fn(plan, xd)), A, x, rel_tol=1e-5)
            tr = device_time_per_call(fn, (plan, xd), args.trace_calls,
                                      os.path.join(trace_root,
                                                   f"{shape}_tpr{tpr}"))
            sweep[tpr] = {"correct": bool(ok), "long_rows":
                          int(plan.long_rows.shape[0]),
                          "device_us": tr["device_us_per_call"]}
            if not ok:
                failed.append(f"{shape}/csr_vector tpr={tpr}")
        log(f"  csr_vector width sweep (chosen {base.threads_per_row}): "
            + ", ".join(f"{t}: {v['device_us']:.1f} us"
                        f"{'' if v['correct'] else ' WRONG'}"
                        for t, v in sweep.items()))
        report["shapes"][shape] = entry
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    log(f"\nwrote {args.out}; card: {smi}")
    if failed:
        log(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
