"""The kernel modules and the routing table, on the CPU.

The CUDA kernel has no interpret mode: its arithmetic is checked here
through ``spmv_csr_vector_reference`` (the NumPy model of its sums) and its
wrapper through the launch shape it computes.  The kernel itself runs in
``tests/test_gpu.py`` and ``chip_smoke.py`` on a GPU.
"""

import numpy as np
import pytest

import jax

from jax_spmv import KernelType, SpMVConfig, csr_from_dense
from jax_spmv.csr import CSRMatrix
from jax_spmv.kernels import csr_vector
from jax_spmv.kernels.scalar import pad_x, spmv_csr_scalar
from jax_spmv.spmv import CSR_PATHS, csr_path
from jax_spmv.utils.testing import spmv_matches


@pytest.mark.parametrize("mean,tpr", [(0.0, 1), (3.3, 1), (3.4, 2), (5.0, 2),
                                      (6.7, 4), (14.5, 8), (39.2, 8),
                                      (500.0, 8)])
def test_threads_per_row(mean, tpr):
    """Largest power of two not above 0.6 x the mean row length, 1..8."""
    assert csr_vector.threads_per_row(mean) == tpr


def test_long_rows_split(rng):
    A = rng.power_law_csr(500, 2000, avg_nnz=8.0, alpha=1.2)
    thr = csr_vector.long_row_threshold(4)
    assert thr == 128
    lr = csr_vector.long_rows(A.row_ptrs, thr)
    lens = np.diff(A.row_ptrs)
    assert lr.dtype == np.int32
    np.testing.assert_array_equal(lr, np.flatnonzero(lens > thr))


@pytest.mark.parametrize("tpr", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("kind", ["power_law", "empty_rows", "all_long"])
def test_reference_model_matches_oracle(rng, tpr, kind):
    """Every row is summed once, by a lane group or by a long-row block,
    whatever the width and threshold."""
    if kind == "power_law":
        A = rng.power_law_csr(300, 1500, avg_nnz=20.0, alpha=1.3)
    elif kind == "empty_rows":
        dense = rng.dense_matrix(120, 90, 0.2)
        dense[::2] = 0.0
        A = csr_from_dense(dense)
    else:                       # threshold below every row length
        A = csr_from_dense(rng.dense_matrix(40, 60, 0.9))
    x = rng.vector(A.num_cols)
    thr = 0 if kind == "all_long" else csr_vector.long_row_threshold(tpr)
    y = csr_vector.spmv_csr_vector_reference(A, x, tpr, thr, block_size=64)
    assert spmv_matches(y, A, x, rel_tol=1e-5)


def test_vector_plan_shapes(rng):
    """The launch shape the dispatch builds: width from the mean row
    length, the long-row list on the device, and a pytree that keeps the
    launch parameters static."""
    A = rng.power_law_csr(1100, 700, avg_nnz=12.0, alpha=1.5)
    plan = csr_vector.VectorCSR.build(A, block_size=128)
    assert plan.threads_per_row == 4          # mean ~12: 0.6 x 12 -> 4
    assert plan.long_row == 128
    np.testing.assert_array_equal(
        np.asarray(plan.long_rows), csr_vector.long_rows(A.row_ptrs, 128))
    assert plan.dev.rows_pad == 2048 and plan.dev.num_rows == 1100
    leaves, treedef = jax.tree_util.tree_flatten(plan)
    again = jax.tree_util.tree_unflatten(treedef, leaves)
    assert (again.threads_per_row, again.long_row, again.block_size) == \
        (4, 128, 128)


@pytest.mark.parametrize("block_size", [0, 48, 2048])
def test_vector_plan_rejects_bad_block_size(rng, block_size):
    with pytest.raises(ValueError):
        csr_vector.VectorCSR.build(rng.csr(10, 10, 0.3), block_size)


def test_library_paths_live_in_the_build_dir():
    assert csr_vector.LIBRARY.parent == csr_vector.BUILD_DIR
    assert csr_vector.BUILD_DIR.name == "build"
    assert csr_vector._SRC.exists()


def test_flat_kernel_padded_extent(rng):
    """The flat kernel returns the padded row extent; padding rows are 0."""
    A = rng.csr(37, 20, 0.3)
    dev = A.to_device()
    y = np.asarray(spmv_csr_scalar(dev, pad_x(rng.vector(20), 1024)))
    assert y.shape == (dev.rows_pad,) == (1024,)
    assert np.all(y[37:] == 0.0)


def test_pad_x():
    x = np.arange(5, dtype=np.float32)
    p = np.asarray(pad_x(x, 8))
    np.testing.assert_array_equal(p, [0, 1, 2, 3, 4, 0, 0, 0])
    assert pad_x(p, 8).shape == (8,)


@pytest.mark.parametrize("kernel_type,gpu,expected", [
    (KernelType.SCALAR_CSR, True, "flat"),
    (KernelType.VECTOR_CSR, True, "csr_vector"),
    (KernelType.MERGE_PATH, True, "csr_vector"),
    (KernelType.ELL_KERNEL, True, "flat"),
    (KernelType.SCALAR_CSR, False, "flat"),
    (KernelType.VECTOR_CSR, False, "flat"),
    (KernelType.MERGE_PATH, False, "flat"),
    (KernelType.ELL_KERNEL, False, "flat"),
])
def test_routing_table(kernel_type, gpu, expected):
    """The mapping stated in the spmv module docstring."""
    assert csr_path(kernel_type, gpu=gpu) == expected
    assert expected in CSR_PATHS


def test_routing_follows_the_platform():
    """The default device's platform picks the column of the table."""
    gpu = jax.devices()[0].platform == "gpu"
    assert csr_path(KernelType.VECTOR_CSR) == \
        ("csr_vector" if gpu else "flat")


def test_dispatch_reports_the_path(rng):
    from jax_spmv import spmv_csr

    A = rng.power_law_csr(64, 64, avg_nnz=5.0)
    x = rng.vector(64)
    for kt in KernelType:
        assert spmv_csr(A, x, SpMVConfig(kernel_type=kt)).kernel == \
            csr_path(kt)


def test_device_state_cached_per_matrix(rng):
    """Uploads happen once per matrix; repeated calls reuse them."""
    A = CSRMatrix.from_dense(rng.dense_matrix(50, 40, 0.2))
    fn1, args1 = CSR_PATHS["flat"](A, SpMVConfig())
    fn2, args2 = CSR_PATHS["flat"](A, SpMVConfig())
    assert args1[0] is args2[0]
