"""PageRank (C15) — fully on-device power iteration.

Re-design of the reference ``pagerank()`` (``src/pagerank.cu:50-153``).  The
reference runs the teleport/dangling/convergence steps on the host every
iteration, paying two full-vector PCIe round-trips per iteration
(``pagerank.cu:110-115``).  This version keeps the entire loop on device
in a ``lax.while_loop``: fused update

    r_new = d*(A @ r_old) + d*(danglingᵀ r_old)/n + (1-d)/n

with an on-device L2 residual; only the final ranks/iteration-count leave
the device.  The dangling term is a plain sum, not a ``jnp.dot``: a
float32 dot may run in TF32 on a GPU.

Semantics preserved from the reference:
  * dangling nodes = columns with zero column-sum, found once up front
    (``pagerank.cu:20-48``);
  * the returned ranks are the last computed ``r_new`` whether or not the
    loop converged (``pagerank.cu:118-139``);
  * final renormalization to Σr = 1 (``pagerank.cu:141-150``);
  * ``pagerank_top_k`` descending ranks (``pagerank.cu:162-185``), via
    ``jax.lax.top_k`` instead of ``std::partial_sort``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from .csr import CSRMatrix
from .spmv import KernelType, _resolve_csr_kernel


@dataclasses.dataclass
class PageRankConfig:
    """Reference ``PageRankConfig`` (``pagerank.h:9-15``)."""

    damping_factor: float = 0.85
    tolerance: float = 1e-6
    max_iterations: int = 100
    # which SpMV kernel type drives the iteration; the reference
    # hardwires VECTOR_CSR (pagerank.cu:89-90)
    kernel_type: KernelType = KernelType.VECTOR_CSR


@dataclasses.dataclass
class PageRankResult:
    """Reference ``PageRankResult`` (``pagerank.h:18-26``)."""

    ranks: jax.Array | None = None
    iterations: int = 0
    final_residual: float = 0.0
    converged: bool = False
    error_code: int = 0

    def ranks_host(self) -> np.ndarray:
        return np.asarray(self.ranks) if self.ranks is not None else None


@dataclasses.dataclass
class TopKNode:
    """Reference ``TopKNode`` (``pagerank.h:21-24``)."""

    node_id: int
    rank: float


def find_dangling_mask(adj: CSRMatrix) -> np.ndarray:
    """Indicator vector of zero-column-sum nodes (reference
    ``find_dangling_nodes``, ``pagerank.cu:20-48``, vectorized)."""
    col_sums = np.zeros(adj.num_cols, np.float32)
    if adj.nnz:
        np.add.at(col_sums, adj.col_indices, adj.values)
    return (col_sums == 0.0).astype(np.float32)


@functools.partial(jax.jit,
                   static_argnames=("n", "max_iterations", "kernel_fn"))
def _pagerank_loop(kernel_fn_args, mask, r0, *, n: int, damping: float,
                   tolerance: float, max_iterations: int, kernel_fn):
    fn, args = kernel_fn, kernel_fn_args
    inv_n = 1.0 / n

    def cond(state):
        it, _, _, residual = state
        return jnp.logical_and(it < max_iterations, residual >= tolerance)

    def body(state):
        it, r_old, _, _ = state
        Ar = fn(*args, r_old)[:n]
        dangling_sum = jnp.sum(mask[:n] * r_old)
        r_new = damping * Ar + damping * dangling_sum * inv_n \
            + (1.0 - damping) * inv_n
        residual = jnp.sqrt(jnp.sum((r_new - r_old) ** 2))
        return (it + 1, r_new, r_old, residual)

    init = (jnp.int32(0), r0, r0, jnp.float32(jnp.inf))
    it, ranks, _, residual = jax.lax.while_loop(cond, body, init)
    total = jnp.sum(ranks)
    ranks = jnp.where(total > 0.0, ranks / total, ranks)
    return it, ranks, residual


def pagerank(adj_matrix: CSRMatrix | None,
             config: PageRankConfig | None = None,
             initial_ranks=None) -> PageRankResult:
    """Damped power iteration on a column-normalized adjacency matrix
    (reference ``pagerank``, ``pagerank.cu:50-153``).

    ``initial_ranks`` resumes iteration from a saved state (see
    :func:`pagerank_save_state`) — a capability the reference lacks
    (SURVEY §5: 'PageRank cannot resume')."""
    result = PageRankResult()
    if adj_matrix is None:
        return result
    if config is None:
        config = PageRankConfig()  # nullptr → defaults, pagerank.cu:60-63
    n = adj_matrix.num_rows
    if adj_matrix.num_cols != n:
        # power iteration needs a square adjacency (pagerank.cu contract)
        from .errors import SpMVError as _E
        result.ranks = None
        result.iterations = 0
        result.converged = False
        result.final_residual = float("nan")
        result.error_code = int(_E.INVALID_DIMENSION)
        return result
    if n == 0:
        result.ranks = jnp.zeros((0,), jnp.float32)
        return result

    _, fn, args = _resolve_csr_kernel(adj_matrix,
                                      KernelType(config.kernel_type))

    mask = jnp.asarray(find_dangling_mask(adj_matrix)[:n])
    if initial_ranks is not None:
        r0 = jnp.asarray(np.asarray(initial_ranks, np.float32)[:n])
    else:
        r0 = jnp.full((n,), 1.0 / n, jnp.float32)
    it, ranks, residual = _pagerank_loop(
        args, mask, r0, n=n, damping=float(config.damping_factor),
        tolerance=float(config.tolerance),
        max_iterations=int(config.max_iterations), kernel_fn=fn)

    result.ranks = ranks
    result.iterations = int(it)
    result.final_residual = float(residual)
    result.converged = result.final_residual < config.tolerance
    return result


def pagerank_top_k(result: PageRankResult, num_nodes: int,
                   k: int) -> list[TopKNode]:
    """Top-k nodes by rank, descending (reference ``pagerank_top_k``,
    ``pagerank.cu:162-185``)."""
    if result is None or result.ranks is None or k <= 0:
        return []
    actual_k = min(k, num_nodes)
    vals, idx = jax.lax.top_k(result.ranks[:num_nodes], actual_k)
    vals = np.asarray(vals)
    idx = np.asarray(idx)
    return [TopKNode(int(idx[i]), float(vals[i])) for i in range(actual_k)]


def _state_path(path) -> str:
    """``np.savez`` silently appends ``.npz``; normalize so save and load
    agree on the on-disk name for suffix-less paths."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def pagerank_save_state(result: PageRankResult, path) -> None:
    """Persist ranks + iteration count for resumption (no reference
    counterpart; the closest is matrix serialization, SURVEY §5)."""
    with open(_state_path(path), "wb") as f:
        np.savez(f, ranks=result.ranks_host(),
                 iterations=np.int64(result.iterations),
                 final_residual=np.float64(result.final_residual))


def pagerank_load_state(path) -> PageRankResult:
    """Load a saved state; feed ``.ranks`` into ``pagerank(...,
    initial_ranks=...)`` to resume."""
    data = np.load(_state_path(path))
    r = PageRankResult()
    r.ranks = jnp.asarray(data["ranks"])
    r.iterations = int(data["iterations"])
    r.final_residual = float(data["final_residual"])
    r.converged = False
    return r
