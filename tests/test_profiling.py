"""Profiling/observability utilities (SURVEY §5 'Tracing / profiling')."""

import jax.numpy as jnp

import numpy as np

from jax_spmv import profiling


def test_cost_analysis_reports_flops():
    def f(a, b):
        return a @ b

    costs = profiling.cost_analysis(f, jnp.ones((64, 64)), jnp.ones((64, 64)))
    assert isinstance(costs, dict)
    # XLA's cost model always reports flops for a matmul
    assert costs.get("flops", 0) > 0


def test_memory_analysis_reports_sizes():
    def f(a):
        return a * 2.0

    mem = profiling.memory_analysis(f, jnp.ones((128,)))
    assert isinstance(mem, dict)


def test_annotate_and_trace_contexts(tmp_path):
    with profiling.annotate("unit-test-region"):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        jnp.ones((8,)).sum().block_until_ready()


def test_cost_analysis_of_spmv_path(rng):
    """The static cost model reads the flat SpMV path's program."""
    from jax_spmv.spmv import CSR_PATHS, SpMVConfig

    A = rng.power_law_csr(300, 200, avg_nnz=6.0)
    fn, args = CSR_PATHS["flat"](A, SpMVConfig())
    costs = profiling.cost_analysis(fn, *args, np.ones(200, np.float32))
    assert costs.get("bytes accessed", 0) > 0
