"""Multi-device row-sharded SpMV (new component — no reference counterpart).

The reference is strictly single-GPU (no MPI/NCCL anywhere; device 0
hardcoded, ``bandwidth.cpp:9``).  This layer splits a CSR matrix into
nnz-balanced row blocks over a 1-D ``jax.sharding.Mesh`` and runs the flat
gather + ``segment_sum`` SpMV on each block under ``shard_map``:

* each shard's nnz arrays are padded to a common bucket so the stacked
  ``(n_shards, nnz_pad)`` arrays are static-shaped and place exactly one
  block per device;
* ``x`` is replicated, so the SpMV itself moves no data between devices;
  the only collective is the all-gather XLA inserts when a replicated
  consumer (the PageRank update) reads the row-sharded ``y``.  On a
  multi-GPU host XLA hands it to NCCL.

Correctness oracle: the same CPU reference (``spmv_cpu.cpp:6-16``) on the
unpartitioned matrix, at the reference property-test tolerances.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..csr import CSRMatrix, _bucket
from ..errors import InvalidArgumentError


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bootstrap (SURVEY §2/§5 checklist): wire this process
    into the cluster so ``jax.devices()`` spans every host's devices and
    the row mesh below stretches across hosts.

    On single-process runs (tests, one host) this is a no-op unless the
    standard cluster environment variables are present.  Call once before
    any other JAX work, mirroring ``jax.distributed.initialize`` docs.
    """
    if coordinator_address is None and num_processes is None \
            and "JAX_COORDINATOR_ADDRESS" not in os.environ \
            and "COORDINATOR_ADDRESS" not in os.environ:
        return  # single-process: nothing to bootstrap
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def _nnz_balanced_bounds(row_ptrs: np.ndarray, n_shards: int) -> np.ndarray:
    """Row partition bounds with near-equal nnz per shard.

    Equal row COUNTS would let one shard own most of the nnz of a
    power-law graph and bound the step time.  Equal-work partitioning is
    the merge-path idea applied across devices:
    cut at the nnz quantiles via searchsorted on the row-pointer prefix
    sums (the same structure ``merge_path_search`` binary-searches,
    ``spmv_kernels.cu:48-72``).
    """
    rows = len(row_ptrs) - 1
    nnz = int(row_ptrs[-1])
    targets = (np.arange(1, n_shards, dtype=np.int64) * nnz) // n_shards
    cuts = np.searchsorted(row_ptrs, targets, side="left")
    bounds = np.concatenate([[0], cuts, [rows]]).astype(np.int64)
    return np.maximum.accumulate(bounds)


def _stitch_rows(y_padded, bounds: tuple, rps: int):
    """Reassemble the true-order y from the padded per-shard frame: each
    shard's valid prefix is a static contiguous slice, so this is a few
    vectorized copies — no elementwise gather."""
    parts = []
    for d in range(len(bounds) - 1):
        length = int(bounds[d + 1] - bounds[d])
        if length:
            parts.append(
                jax.lax.dynamic_slice_in_dim(y_padded, d * rps, length))
    if not parts:
        return y_padded[:0]
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def make_row_mesh(n_devices: int | None = None,
                  axis_name: str = "rows") -> Mesh:
    """A 1D device mesh over the first ``n_devices`` local devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise InvalidArgumentError(
            f"requested {n_devices} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_devices]), (axis_name,))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-partitioned CSR: stacked per-shard padded arrays.

    ``values/col_indices/row_ids`` are ``(n_shards, nnz_pad)``; ``row_ids``
    are shard-local.  Padding nnz carry value 0 and point at the shard's
    last local row.
    """

    values: jax.Array       # f32 (n_shards, nnz_pad)
    col_indices: jax.Array  # i32 (n_shards, nnz_pad)
    row_ids: jax.Array      # i32 (n_shards, nnz_pad), local
    num_rows: int
    num_cols: int
    nnz: int
    rows_per_shard: int     # padded per-shard frame height
    bounds: tuple           # global row bounds per shard (n_shards + 1)
    shard_nnz: tuple = ()   # per-shard nnz (diagnostics)

    @property
    def n_shards(self) -> int:
        return int(self.values.shape[0])

    @property
    def nnz_imbalance(self) -> float:
        """max/mean − 1 of per-shard nnz (0 = perfectly balanced)."""
        return _imbalance_of(self.shard_nnz)

    def tree_flatten(self):
        return (self.values, self.col_indices, self.row_ids), \
            (self.num_rows, self.num_cols, self.nnz, self.rows_per_shard,
             self.bounds, self.shard_nnz)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)


def _imbalance_of(shard_nnz: tuple) -> float:
    s = np.asarray(shard_nnz, np.float64)
    if s.size == 0 or s.mean() == 0:
        return 0.0
    return float(s.max() / s.mean() - 1.0)


def shard_csr(A: CSRMatrix, mesh: Mesh,
              axis_name: str = "rows") -> ShardedCSR:
    """Partition a host CSR matrix into nnz-balanced row blocks over
    ``mesh`` and place each block on its device.  Shards own differing
    row counts inside a common padded frame (``rows_per_shard``);
    :func:`_stitch_rows` reassembles the true-order result from a few
    static contiguous slices."""
    n_shards = int(mesh.shape[axis_name])
    rows = A.num_rows
    ptr = A.row_ptrs
    bounds = _nnz_balanced_bounds(ptr, n_shards)
    rps = max(int(np.diff(bounds).max(initial=0)), 1)
    shard_nnz = ptr[bounds[1:]] - ptr[bounds[:-1]]
    nnz_pad = _bucket(int(shard_nnz.max(initial=0)))

    values = np.zeros((n_shards, nnz_pad), np.float32)
    cols = np.zeros((n_shards, nnz_pad), np.int32)
    rids = np.full((n_shards, nnz_pad), rps - 1, np.int32)
    for d in range(n_shards):
        lo, hi = int(ptr[bounds[d]]), int(ptr[bounds[d + 1]])
        k = hi - lo
        if k:
            values[d, :k] = A.values[lo:hi]
            cols[d, :k] = A.col_indices[lo:hi]
            local_rows = np.repeat(
                np.arange(bounds[d], bounds[d + 1], dtype=np.int32)
                - bounds[d],
                np.diff(ptr[bounds[d]:bounds[d + 1] + 1]))
            rids[d, :k] = local_rows

    sharding = NamedSharding(mesh, P(axis_name, None))
    return ShardedCSR(
        values=jax.device_put(jnp.asarray(values), sharding),
        col_indices=jax.device_put(jnp.asarray(cols), sharding),
        row_ids=jax.device_put(jnp.asarray(rids), sharding),
        num_rows=rows,
        num_cols=A.num_cols,
        nnz=A.nnz,
        rows_per_shard=rps,
        bounds=tuple(int(b) for b in bounds),
        shard_nnz=tuple(int(v) for v in shard_nnz),
    )


def _local_spmv(vals, cols, rids, x, rows_per_shard):
    """Per-device flat SpMV on the local row block (shapes carry a leading
    local-shard dim of 1 inside shard_map)."""
    g = jnp.take(x, cols[0], mode="clip")
    y = jax.ops.segment_sum(vals[0] * g, rids[0],
                            num_segments=rows_per_shard,
                            indices_are_sorted=True)
    return y


@functools.lru_cache(maxsize=32)
def _sharded_spmv_fn(mesh: Mesh, axis_name: str, rows_per_shard: int):
    local = functools.partial(_local_spmv, rows_per_shard=rows_per_shard)
    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None),
                  P(axis_name, None), P()),
        out_specs=P(axis_name),
    )
    return jax.jit(mapped)


def spmv_csr_sharded(sharded: ShardedCSR, x, mesh: Mesh | None = None,
                     axis_name: str = "rows") -> jax.Array:
    """``y = A @ x`` with A row-sharded across the mesh; ``x`` replicated.
    Returns the full ``(num_rows,)`` result (row-sharded layout)."""
    x = jnp.asarray(x, jnp.float32)
    if mesh is None:
        mesh = sharded.values.sharding.mesh
    fn = _sharded_spmv_fn(mesh, axis_name, sharded.rows_per_shard)
    y = fn(sharded.values, sharded.col_indices, sharded.row_ids, x)
    return _stitch_rows(y, sharded.bounds, sharded.rows_per_shard)


def pagerank_sharded(sharded, dangling_mask,
                     config=None, mesh: Mesh | None = None,
                     axis_name: str = "rows"):
    """Fully distributed PageRank: the on-device ``lax.while_loop`` power
    iteration (C15) over the row-sharded SpMV — every iteration's
    all-gather of the row-sharded ``Ar`` back to replicated ranks is one
    collective; only the final ranks/iteration scalars leave the devices.

    ``dangling_mask`` comes from :func:`jax_spmv.pagerank.find_dangling_mask`
    on the unpartitioned matrix (a one-time host pass, as in the reference
    ``pagerank.cu:20-48``).
    """
    from ..pagerank import PageRankConfig, PageRankResult

    cfg = config or PageRankConfig()
    if mesh is None:
        mesh = sharded.values.sharding.mesh
    n = sharded.num_rows
    result = PageRankResult()
    if sharded.num_cols != n:
        from ..errors import SpMVError as _E
        result.error_code = int(_E.INVALID_DIMENSION)
        result.final_residual = float("nan")
        return result
    if n == 0:
        result.ranks = jnp.zeros((0,), jnp.float32)
        return result
    bounds, rps = sharded.bounds, sharded.rows_per_shard
    flat_fn = _sharded_spmv_fn(mesh, axis_name, sharded.rows_per_shard)
    spmv_args = (sharded.values, sharded.col_indices, sharded.row_ids)
    mask = jnp.asarray(np.asarray(dangling_mask, np.float32)[:n])
    damping = float(cfg.damping_factor)
    tol = float(cfg.tolerance)
    max_it = int(cfg.max_iterations)
    inv_n = 1.0 / n

    @jax.jit
    def run(mask, *args):
        r0 = jnp.full((n,), inv_n, jnp.float32)

        def cond(state):
            it, _, residual = state
            return jnp.logical_and(it < max_it, residual >= tol)

        def body(state):
            it, r_old, _ = state
            Ar = _stitch_rows(flat_fn(*args, r_old), bounds, rps)[:n]
            dangling_sum = jnp.sum(mask * r_old)
            r_new = damping * Ar + damping * dangling_sum * inv_n \
                + (1.0 - damping) * inv_n
            residual = jnp.sqrt(jnp.sum((r_new - r_old) ** 2))
            return (it + 1, r_new, residual)

        it, ranks, residual = jax.lax.while_loop(
            cond, body, (jnp.int32(0), r0, jnp.float32(jnp.inf)))
        total = jnp.sum(ranks)
        ranks = jnp.where(total > 0.0, ranks / total, ranks)
        return it, ranks, residual

    it, ranks, residual = run(mask, *spmv_args)
    result.ranks = ranks
    result.iterations = int(it)
    result.final_residual = float(residual)
    result.converged = result.final_residual < tol
    return result


def pagerank_step_sharded(sharded: ShardedCSR, ranks: jax.Array,
                          dangling_mask: jax.Array, damping: float = 0.85,
                          mesh: Mesh | None = None,
                          axis_name: str = "rows") -> jax.Array:
    """One distributed PageRank power iteration: row-sharded SpMV + fused
    teleport/dangling update (the multi-device form of ``pagerank.cu:93-132``).
    The all-gather of the row-sharded ``Ar`` back to the replicated ``ranks``
    layout is inserted by XLA."""
    n = sharded.num_rows
    Ar = spmv_csr_sharded(sharded, ranks, mesh, axis_name)
    dangling_sum = jnp.sum(jnp.asarray(dangling_mask)[:n] * ranks[:n])
    return damping * Ar + damping * dangling_sum / n + (1.0 - damping) / n
