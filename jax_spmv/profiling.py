"""Tracing / profiling utilities (SURVEY §5 'Tracing / profiling').

The reference's observability is inline cudaEvent timing around every
launch (``spmv_kernels.cu:258-310``) plus ``-lineinfo`` for Nsight source
mapping (``CMakeLists.txt:15-18``).  The JAX equivalents:

* :func:`trace` — context manager around ``jax.profiler.trace``: captures a
  TensorBoard/XProf trace of everything executed inside (device kernels,
  copies, host callbacks).  The directory can be opened with
  ``tensorboard --logdir <dir>`` or xprof.
* :func:`start_server` — live profiling endpoint
  (``jax.profiler.start_server``) for attaching TensorBoard on a running
  process.
* :func:`cost_analysis` — XLA's per-module static cost model (flops, bytes
  accessed, memory traffic estimates) for any jitted callable: the analog
  of reading the kernel's achieved-vs-model numbers without running it.
* :func:`annotate` — named trace region (``jax.profiler.TraceAnnotation``)
  so library phases (upload, kernel, solver loop) are visible in
  captured traces.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace of the enclosed block into ``log_dir``."""
    with jax.profiler.trace(log_dir):
        yield


def start_server(port: int = 9012):
    """Start the live profiler endpoint; returns the server object."""
    return jax.profiler.start_server(port)


def annotate(name: str):
    """Named region that shows up in captured traces."""
    return jax.profiler.TraceAnnotation(name)


def cost_analysis(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """XLA static cost analysis of ``jit(fn)(*args)``.

    Returns a dict with keys like ``flops``, ``bytes accessed`` (per
    memory space), as reported by the compiled module.  Values are
    estimates from the compiler's cost model, not measurements.
    """
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    compiled = jitted.lower(*args, **kwargs).compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, (list, tuple)):  # older jax returns [dict]
        costs = costs[0] if costs else {}
    return dict(costs) if costs else {}


def memory_analysis(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Compiled-module memory footprint (argument/output/temp/generated
    sizes in bytes) — what the reference could not introspect at all."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    compiled = jitted.lower(*args, **kwargs).compile()
    mem = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(mem, k, None) for k in keys} if mem else {}
