"""Device timing utilities.

The reference times every kernel with cudaEvents around the launch
(``spmv_kernels.cu:258-310``).  Here a kernel is timed on the host clock
around whole jitted programs that end in a host fetch, which waits for the
device.  Two details keep the measurement honest:

1. ``n`` executions are chained *inside one jitted program* via
   ``lax.fori_loop`` with a data dependency (``carry * 1e-30`` added to one
   float input), so XLA can neither hoist nor merge iterations, and the
   result is consumed by a full ``jnp.sum`` so nothing is dead code;
2. the time per execution is the **slope** between an ``n``- and a
   ``3n``-iteration loop, ``(T(3n) − T(n)) / 2n``: the launch and fetch
   cost common to both cancels.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

# target differenced-work duration per measurement (seconds)
_TARGET_WORK_S = 0.25
_MAX_ITERS = 50_000


def _perturb(tree, carry):
    """Add carry*1e-30 to the SMALLEST non-scalar float leaf (dependency
    injection).  The add materializes a fresh copy of that leaf every
    iteration, so targeting the smallest leaf (x, not the matrix values)
    keeps that copy out of the measured time."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    float_arrays = [
        i for i, leaf in enumerate(leaves)
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating)
        and getattr(leaf, "ndim", 0) >= 1
    ]
    if float_arrays:
        tgt = min(float_arrays, key=lambda i: leaves[i].size)
        leaves[tgt] = leaves[tgt] + carry.astype(leaves[tgt].dtype) * 1e-30
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _probe_scalar(result) -> jax.Array:
    """A DCE-proof data-dependent scalar: full-sum of the first float leaf."""
    for leaf in jax.tree_util.tree_leaves(result):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            return jnp.sum(leaf).astype(jnp.float32)
    return jnp.float32(0.0)


def _make_loop(fn: Callable, iters: int):
    @jax.jit
    def looped(*a):
        def body(_, carry):
            res = fn(*_perturb(a, carry))
            return _probe_scalar(res) * jnp.float32(1e-30)
        return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))
    return looped


def _run(looped, args) -> float:
    t0 = time.perf_counter()
    _ = float(np.asarray(looped(*args)))   # host fetch forces completion
    return time.perf_counter() - t0


def _calibrate(fn: Callable, args, target_s: float) -> int:
    """Loop length whose run takes about ``target_s``."""
    probe = _make_loop(fn, 4)
    _run(probe, args)                     # compile
    per = max(_run(probe, args) / 4, 1e-6)
    return int(min(max(4, target_s / per), _MAX_ITERS))


def time_jitted(fn: Callable, *args, iters: int | None = None,
                warmup: bool = True, samples: int = 2,
                estimator: str = "min") -> float:
    """Seconds per execution of ``fn(*args)`` (see module docstring).

    ``iters`` optionally pins the base loop length; by default it is
    calibrated so the differenced measurement covers ~250 ms of work.
    ``estimator="median"`` takes the median over ``samples`` slope pairs
    instead of the min.
    """
    if iters is None:
        iters = _calibrate(fn, args, _TARGET_WORK_S / 2)
    f1 = _make_loop(fn, iters)
    f3 = _make_loop(fn, 3 * iters)
    _run(f1, args)                        # compile + warm
    _run(f3, args)
    slopes = []
    for _ in range(max(samples, 1)):
        t1 = _run(f1, args)
        t3 = _run(f3, args)
        dt = (t3 - t1) / (2 * iters)
        if dt > 0:
            slopes.append(dt)
    if not slopes:                        # work below the clock's jitter
        return max(_run(f3, args) / (3 * iters), 1e-9)
    if estimator == "median":
        return float(np.median(slopes))
    return min(slopes)


def time_runs(fn: Callable, *args, num_runs: int = 20,
              iters_per_run: int | None = None,
              warmup_runs: int = 1) -> list[float]:
    """Benchmark-harness protocol: ``num_runs`` independent slope
    measurements for avg/min/max/stddev statistics (reference protocol,
    ``benchmark.cu:41-72``)."""
    if iters_per_run is None:
        iters_per_run = _calibrate(fn, args, 0.05)
    f1 = _make_loop(fn, iters_per_run)
    f3 = _make_loop(fn, 3 * iters_per_run)
    for _ in range(max(warmup_runs, 1)):
        _run(f1, args)
        _run(f3, args)
    times = []
    for _ in range(num_runs):
        t1 = _run(f1, args)
        t3 = _run(f3, args)
        times.append(max((t3 - t1) / (2 * iters_per_run), 1e-9))
    return times
