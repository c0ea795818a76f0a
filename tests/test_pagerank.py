"""PageRank tests (C15) — mirrors ``tests/test_pagerank.cu``."""

import numpy as np
import pytest

from jax_spmv import (
    KernelType,
    PageRankConfig,
    SpMVError,
    csr_from_dense,
    pagerank,
    pagerank_top_k,
)

from conftest import DEVICE_PROP_ITERS


def column_normalized_adjacency(rng, n, density=0.2):
    """Random column-normalized adjacency like the reference demo
    (main.cu:102-112)."""
    adj = (rng.rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    col_sums = adj.sum(axis=0)
    nz = col_sums > 0
    adj[:, nz] /= col_sums[nz]
    return csr_from_dense(adj)


class TestProperty15Invariants:
    """Property 15: ranks non-negative, sum to 1 (±1e-4), converged or hit
    max iterations (test_pagerank.cu:18-77)."""

    def test_invariants(self, rng):
        for _ in range(max(DEVICE_PROP_ITERS // 2, 5)):
            n = rng.uniform_int(5, 60)
            adj = column_normalized_adjacency(rng, n)
            cfg = PageRankConfig(max_iterations=100)
            res = pagerank(adj, cfg)
            ranks = res.ranks_host()
            assert ranks.shape == (n,)
            assert np.all(ranks >= 0)
            assert abs(ranks.sum() - 1.0) < 1e-4
            assert res.converged or res.iterations == cfg.max_iterations
            if res.converged:
                assert res.final_residual < cfg.tolerance

    def test_matches_host_power_iteration(self, rng):
        """Cross-check the full on-device loop against a NumPy reference."""
        n = 40
        adj = column_normalized_adjacency(rng, n)
        cfg = PageRankConfig(max_iterations=100, tolerance=1e-6)
        res = pagerank(adj, cfg)

        dense = adj.to_dense()
        dangling = (dense.sum(axis=0) == 0.0).astype(np.float32)
        r = np.full(n, 1.0 / n, np.float32)
        for _ in range(cfg.max_iterations):
            r_new = (cfg.damping_factor * (dense @ r)
                     + cfg.damping_factor * float(dangling @ r) / n
                     + (1 - cfg.damping_factor) / n).astype(np.float32)
            resid = float(np.linalg.norm(r_new - r))
            r, r_prev = r_new, r
            if resid < cfg.tolerance:
                break
        r = r / r.sum()
        np.testing.assert_allclose(res.ranks_host(), r, rtol=1e-4, atol=1e-6)


class TestProperty16TopK:
    """Property 16: top-k is sorted descending and contains the true
    maxima (test_pagerank.cu:81-137)."""

    def test_topk(self, rng):
        for _ in range(max(DEVICE_PROP_ITERS // 2, 5)):
            n = rng.uniform_int(10, 50)
            adj = column_normalized_adjacency(rng, n)
            res = pagerank(adj)
            k = rng.uniform_int(1, n)
            top = pagerank_top_k(res, n, k)
            assert len(top) == min(k, n)
            ranks = [t.rank for t in top]
            assert all(ranks[i] >= ranks[i + 1] for i in range(len(ranks) - 1))
            true_sorted = np.sort(res.ranks_host())[::-1]
            np.testing.assert_allclose(ranks, true_sorted[:k], rtol=1e-6)

    def test_k_larger_than_n(self, rng):
        adj = column_normalized_adjacency(rng, 8)
        res = pagerank(adj)
        top = pagerank_top_k(res, 8, 20)
        assert len(top) == 8


class TestSymmetry:
    def test_3cycle_symmetric_ranks(self):
        """A 3-cycle gives equal ranks (test_pagerank.cu:140-164)."""
        adj = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
        res = pagerank(csr_from_dense(adj))
        ranks = res.ranks_host()
        np.testing.assert_allclose(ranks, [1 / 3] * 3, atol=1e-5)
        assert res.converged

    def test_null_and_empty(self):
        assert pagerank(None).ranks is None
        res = pagerank(csr_from_dense(np.zeros((0, 0), np.float32)))
        assert res.ranks_host().shape == (0,)


class TestResume:
    """Checkpoint/resume — an extension (SURVEY §5: the reference's
    PageRank cannot resume)."""

    def test_save_load_resume(self, rng, tmp_path):
        import numpy as np
        from jax_spmv import (PageRankConfig, pagerank, pagerank_load_state,
                              pagerank_save_state)
        from jax_spmv.csr import csr_from_dense

        n = 40
        adj = (rng.rng.random((n, n)) < 0.2).astype(np.float32)
        np.fill_diagonal(adj, 0.0)
        cs = adj.sum(axis=0)
        nz = cs > 0
        adj[:, nz] /= cs[nz]
        csr = csr_from_dense(adj)

        # run 5 iterations, checkpoint, resume — must match a straight run
        partial = pagerank(csr, PageRankConfig(max_iterations=5,
                                               tolerance=0.0))
        path = tmp_path / "state.npz"
        pagerank_save_state(partial, path)
        loaded = pagerank_load_state(path)
        assert loaded.iterations == partial.iterations
        resumed = pagerank(csr, PageRankConfig(max_iterations=95),
                           initial_ranks=loaded.ranks)
        straight = pagerank(csr, PageRankConfig(max_iterations=100))
        assert resumed.converged and straight.converged
        np.testing.assert_allclose(resumed.ranks_host(),
                                   straight.ranks_host(),
                                   rtol=1e-4, atol=1e-7)


def _host_pagerank(dense, cfg):
    """NumPy power iteration with the reference semantics
    (pagerank.cu:50-153)."""
    n = dense.shape[0]
    dangling = (dense.sum(axis=0) == 0.0).astype(np.float32)
    r = np.full(n, 1.0 / n, np.float32)
    it, resid = 0, np.inf
    while it < cfg.max_iterations and resid >= cfg.tolerance:
        r_new = (cfg.damping_factor * (dense @ r)
                 + cfg.damping_factor * float(dangling @ r) / n
                 + (1 - cfg.damping_factor) / n).astype(np.float32)
        resid = float(np.linalg.norm(r_new - r))
        r, it = r_new, it + 1
    return r / r.sum(), it


@pytest.mark.parametrize("kernel_type", list(KernelType))
def test_pagerank_each_kernel_type(rng, kernel_type):
    """Every kernel type drives the iteration to the host result, with
    the same iteration count."""
    adj = column_normalized_adjacency(rng, 70, density=0.1)
    cfg = PageRankConfig(kernel_type=kernel_type)
    res = pagerank(adj, cfg)
    ref, ref_it = _host_pagerank(adj.to_dense(), cfg)
    assert res.error_code == 0 and res.converged
    assert res.iterations == ref_it
    np.testing.assert_allclose(res.ranks_host(), ref, rtol=1e-4, atol=1e-7)


def test_dangling_mass_is_redistributed(rng):
    """Columns with no out-links (dangling nodes) spread their rank evenly;
    the ranks still sum to 1 and match the host loop."""
    adj = column_normalized_adjacency(rng, 50, density=0.1).to_dense()
    adj[:, :10] = 0.0                      # ten dangling nodes
    csr = csr_from_dense(adj)
    cfg = PageRankConfig()
    res = pagerank(csr, cfg)
    ref, _ = _host_pagerank(adj, cfg)
    assert abs(res.ranks_host().sum() - 1.0) < 1e-5
    np.testing.assert_allclose(res.ranks_host(), ref, rtol=1e-4, atol=1e-7)


def test_non_square_rejected():
    res = pagerank(csr_from_dense(np.ones((3, 4), np.float32)))
    assert res.error_code == int(SpMVError.INVALID_DIMENSION)
    assert res.ranks is None
