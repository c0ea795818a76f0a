"""Distributed layer tests (new component) — row-sharded SpMV over a forced
multi-device CPU mesh, oracle = the same CPU reference on the unpartitioned
matrix (SURVEY §2 'Parallelism strategies')."""

import numpy as np
import pytest

import jax

from jax_spmv import csr_from_dense
from jax_spmv.ops import spmv_cpu_csr
from jax_spmv.parallel import (
    make_row_mesh,
    pagerank_step_sharded,
    shard_csr,
    spmv_csr_sharded,
)
from jax_spmv.pagerank import find_dangling_mask
from jax_spmv.utils.testing import spmv_matches, spmv_rel_equal

needs_multi = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >= 2 devices")


class TestShardedSpMV:
    @needs_multi
    def test_matches_oracle(self, rng, n_devices):
        mesh = make_row_mesh(n_devices)
        for _ in range(10):
            rows = rng.uniform_int(n_devices, 200)
            cols = rng.uniform_int(1, 200)
            csr = csr_from_dense(rng.dense_matrix(rows, cols, 0.2))
            x = rng.vector(cols)
            y = np.asarray(spmv_csr_sharded(shard_csr(csr, mesh), x, mesh))
            assert spmv_matches(y, csr, x)

    @needs_multi
    def test_skewed_matrix(self, rng, n_devices):
        mesh = make_row_mesh(n_devices)
        csr = rng.power_law_csr(150, 150, avg_nnz=5.0)
        x = rng.vector(150)
        y = np.asarray(spmv_csr_sharded(shard_csr(csr, mesh), x, mesh))
        assert spmv_matches(y, csr, x, rel_tol=1e-5)

    def test_single_device_mesh(self, rng):
        mesh = make_row_mesh(1)
        csr = csr_from_dense(rng.dense_matrix(30, 30, 0.3))
        x = rng.vector(30)
        y = np.asarray(spmv_csr_sharded(shard_csr(csr, mesh), x, mesh))
        assert spmv_matches(y, csr, x)

    @needs_multi
    def test_row_count_not_divisible(self, rng, n_devices):
        """Rows not a multiple of the shard count."""
        mesh = make_row_mesh(n_devices)
        rows = n_devices * 13 + 5
        csr = csr_from_dense(rng.dense_matrix(rows, 64, 0.15))
        x = rng.vector(64)
        y = np.asarray(spmv_csr_sharded(shard_csr(csr, mesh), x, mesh))
        assert spmv_matches(y, csr, x)


class TestShardedPageRankStep:
    @needs_multi
    def test_step_matches_dense(self, rng, n_devices):
        mesh = make_row_mesh(n_devices)
        n = 64
        dense = (rng.rng.random((n, n)) < 0.2).astype(np.float32)
        np.fill_diagonal(dense, 0.0)
        s = dense.sum(axis=0)
        dense[:, s > 0] /= s[s > 0]
        csr = csr_from_dense(dense)
        sharded = shard_csr(csr, mesh)
        mask = find_dangling_mask(csr)
        r = np.full(n, 1.0 / n, np.float32)
        out = np.asarray(pagerank_step_sharded(
            sharded, r, mask, damping=0.85, mesh=mesh))
        expected = 0.85 * (dense @ r) + 0.85 * float(mask @ r) / n + 0.15 / n
        assert spmv_rel_equal(out, expected.astype(np.float32), rel_tol=1e-5)


class TestDistributedPageRank:
    """Full on-device distributed power iteration (new component)."""

    def test_matches_single_device_pagerank(self, rng, n_devices):
        import numpy as np
        from jax_spmv import PageRankConfig, pagerank
        from jax_spmv.csr import csr_from_dense
        from jax_spmv.pagerank import find_dangling_mask
        from jax_spmv.parallel import (make_row_mesh, pagerank_sharded,
                                       shard_csr)

        n = 96
        adj = (rng.rng.random((n, n)) < 0.15).astype(np.float32)
        np.fill_diagonal(adj, 0.0)
        cs = adj.sum(axis=0)
        nz = cs > 0
        adj[:, nz] /= cs[nz]
        csr = csr_from_dense(adj)

        mesh = make_row_mesh(min(4, n_devices))
        sharded = shard_csr(csr, mesh)
        mask = find_dangling_mask(csr)
        dist = pagerank_sharded(sharded, mask, PageRankConfig(), mesh)
        single = pagerank(csr, PageRankConfig())
        assert dist.converged
        np.testing.assert_allclose(dist.ranks_host(), single.ranks_host(),
                                   rtol=1e-4, atol=1e-7)


class TestBalancedSharding:
    """nnz-balanced row partitioning."""

    def test_power_law_imbalance_under_10_percent(self, rng):
        csr = rng.power_law_csr(4096, 512, avg_nnz=16, alpha=1.6)
        mesh = make_row_mesh(4)
        sharded = shard_csr(csr, mesh)
        assert sharded.nnz_imbalance < 0.10
        x = rng.vector(512)
        y = np.asarray(spmv_csr_sharded(sharded, x, mesh))
        assert spmv_matches(y, csr, x, rel_tol=1e-5)

    def test_init_distributed_single_process_noop(self, monkeypatch):
        from jax_spmv.parallel import init_distributed

        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        init_distributed()  # must not raise or try to reach a coordinator


class TestShardPlacement:
    """Shards land one per device of the mesh (the 4-card check of
    chip_smoke.py --chips 4, here on virtual CPU devices)."""

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_one_shard_per_device(self, rng, n):
        mesh = make_row_mesh(n)
        csr = rng.power_law_csr(300, 200, avg_nnz=6.0)
        sharded = shard_csr(csr, mesh)
        devs = {s.device for s in sharded.values.addressable_shards}
        assert len(devs) == n and sharded.n_shards == n
        assert sharded.bounds[0] == 0 and sharded.bounds[-1] == 300
        assert sum(sharded.shard_nnz) == csr.nnz

    def test_matches_one_device_dispatch(self, rng):
        """The sharded result agrees with the one-device public dispatch
        and both with the oracle."""
        from jax_spmv import spmv_auto_config, spmv_csr

        csr = rng.power_law_csr(1500, 900, avg_nnz=12.0, alpha=1.6)
        x = rng.vector(900)
        y = np.asarray(spmv_csr_sharded(shard_csr(csr, make_row_mesh(4)), x))
        one = spmv_csr(csr, x, spmv_auto_config(csr)).y_host()
        assert spmv_matches(y, csr, x, rel_tol=1e-5)
        assert spmv_matches(one, csr, x, rel_tol=1e-5)

    def test_more_devices_than_rows(self, rng):
        """Empty shards (rows < devices) still give the right result."""
        mesh = make_row_mesh(8)
        csr = csr_from_dense(rng.dense_matrix(3, 20, 0.5))
        x = rng.vector(20)
        y = np.asarray(spmv_csr_sharded(shard_csr(csr, mesh), x, mesh))
        assert spmv_matches(y, csr, x)

    def test_mesh_larger_than_device_count_rejected(self):
        from jax_spmv.errors import InvalidArgumentError

        with pytest.raises(InvalidArgumentError):
            make_row_mesh(len(jax.devices()) + 1)
