"""Device-failure error paths.

The reference checks every CUDA call and maps failures to typed codes
(``include/spmv/common.h:53-67``); its tests exercise those paths.  Here
the upload layer (:func:`jax_spmv.errors.guarded_device_put`) performs the
same discrimination over XLA failures, and the public dispatch honors the
no-throw contract by reporting the typed code in ``SpMVResult.error_code``.
Failures are injected by monkeypatching ``jax.device_put`` (the only way
to produce RESOURCE_EXHAUSTED deterministically on the CPU backend) or
the dispatch's path table.
"""

import numpy as np
import pytest

import jax

from jax_spmv.errors import (
    DeviceAllocError,
    DeviceTransferError,
    OutOfMemoryError,
    SpMVError,
    guarded_device_put,
)
from jax_spmv.spmv import KernelType, SpMVConfig, spmv_csr, spmv_ell
from jax_spmv.utils.testing import RandomGenerator


def _fresh_csr(rows=64, cols=64):
    return RandomGenerator(7).csr(rows, cols, density=0.1)


def _raise_rt(msg):
    def fake_put(a, device=None, **kw):
        raise jax.errors.JaxRuntimeError(msg)

    return fake_put


def test_guarded_put_alloc_failure(monkeypatch):
    monkeypatch.setattr(jax, "device_put",
                        _raise_rt("RESOURCE_EXHAUSTED: Out of memory "
                                  "allocating 12345 bytes"))
    with pytest.raises(DeviceAllocError) as ei:
        guarded_device_put(np.zeros(4, np.float32))
    assert ei.value.code == SpMVError.DEVICE_ALLOC


def test_guarded_put_transfer_failure(monkeypatch):
    monkeypatch.setattr(jax, "device_put",
                        _raise_rt("INTERNAL: DMA to device failed"))
    with pytest.raises(DeviceTransferError) as ei:
        guarded_device_put(np.zeros(4, np.float32))
    assert ei.value.code == SpMVError.DEVICE_TRANSFER


def test_guarded_put_host_oom(monkeypatch):
    def fake_put(a, device=None, **kw):
        raise MemoryError("host allocation failed")

    monkeypatch.setattr(jax, "device_put", fake_put)
    with pytest.raises(OutOfMemoryError) as ei:
        guarded_device_put(np.zeros(4, np.float32))
    assert ei.value.code == SpMVError.OUT_OF_MEMORY


def test_guarded_put_non_runtime_error_propagates(monkeypatch):
    """Caller bugs (e.g. a TypeError from a bad leaf) must NOT be
    reclassified as device failures."""

    def fake_put(a, device=None, **kw):
        raise TypeError("not an array")

    monkeypatch.setattr(jax, "device_put", fake_put)
    with pytest.raises(TypeError):
        guarded_device_put(np.zeros(4, np.float32))


def test_spmv_csr_reports_device_alloc(monkeypatch):
    """A fresh matrix whose upload RESOURCE_EXHAUSTs reports
    DEVICE_ALLOC through the no-throw dispatch (common.h:53-67)."""
    A = _fresh_csr()
    x = np.ones(A.num_cols, np.float32)
    monkeypatch.setattr(jax, "device_put",
                        _raise_rt("RESOURCE_EXHAUSTED: out of memory"))
    r = spmv_csr(A, x, SpMVConfig(kernel_type=KernelType.SCALAR_CSR))
    assert r.error_code == int(SpMVError.DEVICE_ALLOC)
    assert r.y is None


def test_spmv_csr_reports_device_transfer(monkeypatch):
    A = _fresh_csr()
    x = np.ones(A.num_cols, np.float32)
    monkeypatch.setattr(jax, "device_put",
                        _raise_rt("INTERNAL: transfer aborted"))
    r = spmv_csr(A, x, SpMVConfig(kernel_type=KernelType.SCALAR_CSR))
    assert r.error_code == int(SpMVError.DEVICE_TRANSFER)


def test_spmv_csr_packed_path_reports_oom(monkeypatch):
    """The merge-path dispatch uploads the matrix; an OOM there must
    surface as a code, not an exception."""
    A = _fresh_csr(256, 256)
    x = np.ones(A.num_cols, np.float32)
    monkeypatch.setattr(jax, "device_put",
                        _raise_rt("RESOURCE_EXHAUSTED: hbm"))
    r = spmv_csr(A, x, SpMVConfig(kernel_type=KernelType.MERGE_PATH))
    assert r.error_code == int(SpMVError.DEVICE_ALLOC)


def test_spmv_ell_reports_device_alloc(monkeypatch):
    from jax_spmv.ell import ELLMatrix

    A = ELLMatrix.from_csr(_fresh_csr())
    x = np.ones(A.num_cols, np.float32)
    monkeypatch.setattr(jax, "device_put",
                        _raise_rt("RESOURCE_EXHAUSTED: out of memory"))
    r = spmv_ell(A, x)
    assert r.error_code == int(SpMVError.DEVICE_ALLOC)


def _failing_path(exc):
    def resolve(A, config):
        def fn(dev, x):
            raise exc
        return fn, (A.to_device(),)
    return resolve


def test_library_bug_not_masked(monkeypatch):
    """A library bug raised while a kernel runs (here a bare
    NotImplementedError) propagates: only device failures become codes,
    and nothing is retried on another path."""
    from jax_spmv import spmv

    monkeypatch.setitem(spmv.CSR_PATHS, "flat",
                        _failing_path(NotImplementedError("library bug")))
    with pytest.raises(NotImplementedError):
        spmv_csr(_fresh_csr(), np.ones(64, np.float32),
                 SpMVConfig(kernel_type=KernelType.SCALAR_CSR))


def test_device_failure_reports_execution(monkeypatch):
    """A runtime failure of the device program is SpMVError.EXECUTION
    (reference KERNEL_LAUNCH), with no result and no fallback path."""
    from jax_spmv import spmv

    monkeypatch.setitem(spmv.CSR_PATHS, "flat", _failing_path(
        jax.errors.JaxRuntimeError("INTERNAL: kernel launch failed")))
    r = spmv_csr(_fresh_csr(), np.ones(64, np.float32),
                 SpMVConfig(kernel_type=KernelType.SCALAR_CSR))
    assert r.error_code == int(SpMVError.EXECUTION)
    assert r.y is None and r.kernel == "flat"
