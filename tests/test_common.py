"""Foundation tests (C1, C2) — mirrors ``tests/test_common.cpp``."""

import numpy as np
import pytest

import jax.numpy as jnp

from jax_spmv import (
    DeviceBuffer,
    InvalidArgumentError,
    SpMVError,
    spmv_error_string,
)


class TestErrorStrings:
    # reference test_common.cpp:8-18
    def test_all_codes_have_strings(self):
        for err in SpMVError:
            s = spmv_error_string(err)
            assert isinstance(s, str) and len(s) > 0
            assert s != "Unknown error"

    def test_unknown_code(self):
        assert spmv_error_string(-999) == "Unknown error"

    def test_code_values_match_reference(self):
        # common.h:13-23
        assert SpMVError.SUCCESS == 0
        assert SpMVError.INVALID_DIMENSION == -1
        assert SpMVError.DEVICE_ALLOC == -2
        assert SpMVError.DEVICE_TRANSFER == -3
        assert SpMVError.EXECUTION == -4
        assert SpMVError.INVALID_FORMAT == -5
        assert SpMVError.FILE_IO == -6
        assert SpMVError.OUT_OF_MEMORY == -7
        assert SpMVError.INVALID_ARGUMENT == -8


class TestDeviceBuffer:
    # reference test_common.cpp:21-98 (CudaBuffer semantics)
    def test_alloc_and_size(self):
        buf = DeviceBuffer(100)
        assert buf.size == 100
        assert not buf.empty

    def test_empty(self):
        buf = DeviceBuffer(0)
        assert buf.empty
        with pytest.raises(InvalidArgumentError):
            buf.get()

    def test_roundtrip(self):
        buf = DeviceBuffer(64)
        data = np.arange(64, dtype=np.float32)
        buf.copy_from_host(data)
        out = buf.copy_to_host()
        np.testing.assert_array_equal(out, data)

    def test_copy_overflow_raises(self):
        # cuda_buffer.h:62-63 throws on copy-size overflow
        buf = DeviceBuffer(4)
        with pytest.raises(InvalidArgumentError):
            buf.copy_from_host(np.zeros(8, np.float32))
        with pytest.raises(InvalidArgumentError):
            buf.copy_to_host(count=8)

    def test_resize_drops_contents(self):
        buf = DeviceBuffer(8)
        buf.copy_from_host(np.ones(8, np.float32))
        buf.resize(16)
        assert buf.size == 16
        np.testing.assert_array_equal(buf.copy_to_host(),
                                      np.zeros(16, np.float32))

    def test_release(self):
        buf = DeviceBuffer(8)
        buf.release()
        assert buf.empty

    def test_take_moves_ownership(self):
        # move semantics analog (cuda_buffer.h:38-53)
        buf = DeviceBuffer(8)
        arr = buf.take()
        assert arr.shape == (8,)
        assert buf.empty

    def test_swap(self):
        a = DeviceBuffer(4)
        b = DeviceBuffer(8)
        a.swap(b)
        assert a.size == 8 and b.size == 4

    def test_partial_copy(self):
        buf = DeviceBuffer(8)
        buf.copy_from_host(np.ones(4, np.float32), count=4)
        out = buf.copy_to_host()
        np.testing.assert_array_equal(out[:4], np.ones(4, np.float32))
        np.testing.assert_array_equal(out[4:], np.zeros(4, np.float32))

    def test_dtype(self):
        buf = DeviceBuffer(4, dtype=jnp.int32)
        assert buf.dtype == jnp.int32
