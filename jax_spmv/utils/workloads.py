"""The matrices that ``chip_smoke.py``, ``bench.py`` and
``benchmarks/candidates.py`` share, each generated from a fixed seed."""

from __future__ import annotations

from .testing import RandomGenerator, stencil_5pt_csr, web_graph_csr


def headline(seed: int = 42):
    """262,144 x 4,096 power-law rows (avg 40 nnz, alpha 1.6): ~10.5M nnz,
    the reference's CSR capacity class (requirements.md:32)."""
    return RandomGenerator(seed).power_law_csr(262_144, 4_096, avg_nnz=40.0,
                                               alpha=1.6)


def web_graph(n: int = 1_000_000, seed: int = 42):
    """Square web-graph-like matrix, power-law rows and columns, avg 15
    nnz per row; at 1M nodes the reference's PageRank capacity target
    (requirements.md:104)."""
    return web_graph_csr(RandomGenerator(seed), n, n, avg_nnz=15)


def stencil(g: int = 512):
    """5-point Laplacian on a g x g grid."""
    return stencil_5pt_csr(g)
