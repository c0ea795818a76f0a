"""Test utilities (C17).

Re-design of the reference test helpers (``include/spmv/test_utils.h``):
seeded random generator (seed 42, ``test_utils.h:12-32``), random dense
matrix / vector generators (``test_utils.h:35-58``), and the combined
absolute+relative float comparison at 1e-6 (``test_utils.h:61-71``).
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 42
DEFAULT_TOL = 1e-6


class RandomGenerator:
    """Seeded RNG (reference mt19937 with seed 42, ``test_utils.h:12-32``)."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.rng = np.random.Generator(np.random.MT19937(seed))

    def uniform(self, lo: float, hi: float) -> float:
        return float(self.rng.uniform(lo, hi))

    def uniform_int(self, lo: int, hi: int) -> int:
        """Inclusive range, like std::uniform_int_distribution."""
        return int(self.rng.integers(lo, hi + 1))

    def dense_matrix(self, rows: int, cols: int, density: float = 0.1,
                     lo: float = -10.0, hi: float = 10.0) -> np.ndarray:
        """Random dense matrix with ~density fraction of non-zeros
        (reference ``generateRandomDenseMatrix``, ``test_utils.h:35-46``)."""
        keep = self.rng.random((rows, cols)) < density
        vals = self.rng.uniform(lo, hi, (rows, cols)).astype(np.float32)
        out = np.where(keep, vals, np.float32(0.0))
        # uniform(lo,hi) can itself produce exact 0; the reference treats
        # those as zeros too (exact-compare semantics), nothing to fix up.
        return out.astype(np.float32)

    def vector(self, n: int, lo: float = -10.0, hi: float = 10.0) -> np.ndarray:
        """Random vector (reference ``generateRandomVector``,
        ``test_utils.h:49-58``)."""
        return self.rng.uniform(lo, hi, n).astype(np.float32)

    def csr(self, rows: int, cols: int, density: float = 0.1):
        """Random CSRMatrix via dense round-trip (how every reference
        property test builds matrices)."""
        from ..csr import CSRMatrix

        return CSRMatrix.from_dense(self.dense_matrix(rows, cols, density))

    def power_law_csr(self, rows: int, cols: int, avg_nnz: float = 8.0,
                      alpha: float = 1.5):
        """Skewed (power-law row-length) CSRMatrix — the workload class the
        merge-path kernel targets (requirements.md:68: skew > 100)."""
        from ..csr import CSRMatrix

        raw = self.rng.pareto(alpha, rows) + 1.0
        lens = np.minimum((raw * avg_nnz / raw.mean()).astype(np.int64), cols)
        row_ptrs = np.zeros(rows + 1, np.int32)
        np.cumsum(lens, out=row_ptrs[1:])
        nnz = int(row_ptrs[-1])
        cols_arr = np.empty(nnz, np.int32)
        for i in range(rows):  # sorted unique columns per row
            k = int(lens[i])
            if k:
                cols_arr[row_ptrs[i]:row_ptrs[i + 1]] = np.sort(
                    self.rng.choice(cols, size=k, replace=False)
                )
        vals = self.rng.uniform(-10, 10, nnz).astype(np.float32)
        vals[vals == 0.0] = 1.0
        return CSRMatrix(rows, cols, vals, cols_arr, row_ptrs)


def web_graph_csr(rng: RandomGenerator, rows: int, cols: int,
                  avg_nnz: float = 16.0, alpha_row: float = 1.6,
                  col_beta: float = 2.5):
    """Web-graph-like CSR: power-law row lengths AND power-law column
    popularity (in-degree skew), vectorized.

    Real graphs have both skews; reads of x concentrate on the hub
    columns, which the caches serve, as the texture cache did in the
    reference (C11).
    """
    from ..csr import CSRMatrix

    raw = rng.rng.pareto(alpha_row, rows) + 1.0
    lens = np.minimum((raw * avg_nnz / raw.mean()).astype(np.int64), cols)
    total = int(lens.sum())
    rr = np.repeat(np.arange(rows, dtype=np.int64), lens)
    u = rng.rng.random(total)
    cc = np.minimum((cols * u ** col_beta).astype(np.int64), cols - 1)
    key = np.unique(rr * cols + cc)   # dedupe + sort (rows major, cols asc)
    rr2 = (key // cols).astype(np.int64)
    cc2 = (key % cols).astype(np.int32)
    nnz = len(key)
    row_nnz = np.bincount(rr2, minlength=rows)
    row_ptrs = np.zeros(rows + 1, np.int32)
    np.cumsum(row_nnz, out=row_ptrs[1:])
    vals = rng.rng.uniform(0.1, 1.0, nnz).astype(np.float32)
    return CSRMatrix(rows, cols, vals, cc2, row_ptrs)


def rmat_csr(gen: np.random.Generator, scale: int = 18, avg_nnz: int = 16,
             a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """Recursive-matrix (Graph500 Kronecker) edge generator: ``2**scale``
    vertices, ``avg_nnz * 2**scale`` generated edges (duplicates merged),
    quadrant probabilities ``a, b, c`` (Graph500's 0.57, 0.19, 0.19)."""
    from ..csr import CSRMatrix

    n = 1 << scale
    m = n * avg_nnz
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    for lvl in range(scale):
        r = gen.random(m)
        bit_r = (r >= a + b).astype(np.int64)
        r2 = gen.random(m)
        pright = np.where(bit_r == 0, b / (a + b), (1 - (a + b + c)) /
                          max(1 - (a + b + c) + c, 1e-9))
        bit_c = (r2 < pright).astype(np.int64)
        rows |= bit_r << lvl
        cols |= bit_c << lvl
    key = np.unique(rows * n + cols)
    rr, cc = key // n, (key % n).astype(np.int32)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rr, minlength=n), out=ptr[1:])
    vals = gen.uniform(0.1, 1.0, len(key)).astype(np.float32)
    return CSRMatrix(n, n, vals, cc, ptr)


def stencil_5pt_csr(g: int):
    """The 5-point Laplacian on a ``g x g`` grid (4 on the diagonal, -1 to
    each grid neighbour), rows in row-major grid order."""
    from ..csr import CSRMatrix

    n = g * g
    ii = np.arange(n)
    r, c = ii // g, ii % g
    rl, cl, vl = [], [], []
    for dr, dc, v in ((0, 0, 4.0), (-1, 0, -1.0), (1, 0, -1.0),
                      (0, -1, -1.0), (0, 1, -1.0)):
        r2, c2 = r + dr, c + dc
        m = (r2 >= 0) & (r2 < g) & (c2 >= 0) & (c2 < g)
        rl.append(ii[m])
        cl.append((r2 * g + c2)[m])
        vl.append(np.full(int(m.sum()), v, np.float32))
    ra, ca, va = np.concatenate(rl), np.concatenate(cl), np.concatenate(vl)
    o = np.lexsort((ca, ra))
    rp = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(ra, minlength=n), out=rp[1:])
    return CSRMatrix(n, n, va[o], ca[o].astype(np.int32), rp)


def column_normalized(adj):
    """The PageRank transition matrix of ``adj``: every stored value of a
    column replaced by 1/(number of stored values in that column)."""
    from ..csr import CSRMatrix

    outdeg = np.bincount(adj.col_indices, minlength=adj.num_cols)
    vals = (1.0 / np.maximum(outdeg, 1)[adj.col_indices]).astype(np.float32)
    return CSRMatrix(adj.num_rows, adj.num_cols, vals, adj.col_indices,
                     adj.row_ptrs)


def generate_random_dense_matrix(rng: RandomGenerator, rows: int, cols: int,
                                 density: float = 0.1) -> np.ndarray:
    return rng.dense_matrix(rows, cols, density)


def generate_random_vector(rng: RandomGenerator, n: int) -> np.ndarray:
    return rng.vector(n)


def generate_random_csr(rng: RandomGenerator, rows: int, cols: int,
                        density: float = 0.1):
    return rng.csr(rows, cols, density)


def float_arrays_equal(a, b, tol: float = DEFAULT_TOL) -> bool:
    """Combined abs+rel comparison (reference ``floatArraysEqual``,
    ``test_utils.h:61-71``): |a-b| <= tol OR |a-b| <= tol * max(|a|,|b|)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        return False
    diff = np.abs(a - b)
    scale = np.maximum(np.abs(a), np.abs(b))
    return bool(np.all((diff <= tol) | (diff <= tol * scale)))


def int_arrays_equal(a, b) -> bool:
    """Reference ``intArraysEqual`` (``test_utils.h:74-79``)."""
    a = np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and bool(np.all(a == b))


def spmv_matches(y_dev, csr, x, rel_tol: float = 1e-6) -> bool:
    """Device-vs-oracle comparison with the numerically correct bound for
    reordered summation.

    The reference compares at 1e-6 relative (``test_spmv.cu:18-35``) and can,
    because its GPU scalar kernel accumulates each row in *exactly* the CPU
    loop's order.  The device paths here sum in other orders (warp shuffle
    trees, atomics, cuSPARSE's own), so the attainable bound is the
    standard backward-error one:
    ``|y - ŷ|_i <= rel_tol * (|A| |x|)_i`` — which degenerates to the
    reference's plain relative tolerance whenever a row has no catastrophic
    cancellation.  Both criteria are applied; either suffices per element.
    """
    y_dev = np.asarray(y_dev, np.float32)
    y_ref = np.zeros(csr.num_rows, np.float32)
    from ..ops.cpu_reference import spmv_cpu_csr

    spmv_cpu_csr(csr, x, y_ref)
    if y_dev.shape != y_ref.shape:
        return False
    # row-wise magnitude scale |A| |x|
    scale = np.zeros(csr.num_rows, np.float32)
    if csr.nnz:
        mags = np.abs(csr.values) * np.abs(np.asarray(x, np.float32))[csr.col_indices]
        row_ids = np.repeat(np.arange(csr.num_rows), np.diff(csr.row_ptrs))
        np.add.at(scale, row_ids, mags)
    diff = np.abs(y_dev - y_ref)
    plain = spmv_rel_equal(y_dev, y_ref, rel_tol)
    return bool(plain or np.all(diff <= rel_tol * np.maximum(scale, 1.0)))


def spmv_rel_equal(gpu, cpu, rel_tol: float = 1e-6) -> bool:
    """The GPU-vs-CPU comparison used by Property 8 (``test_spmv.cu:18-35``):
    relative tolerance with an absolute floor when both magnitudes < 1e-10."""
    gpu = np.asarray(gpu, np.float32)
    cpu = np.asarray(cpu, np.float32)
    if gpu.shape != cpu.shape:
        return False
    both_tiny = (np.abs(gpu) < 1e-10) & (np.abs(cpu) < 1e-10)
    diff = np.abs(gpu - cpu)
    denom = np.maximum(np.abs(cpu), 1e-30)
    ok = both_tiny | (diff <= 1e-6) | (diff / denom <= rel_tol)
    return bool(np.all(ok))
