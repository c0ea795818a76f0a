"""The platform decision and the compile-cache location."""

import jax
import pytest

from jax_spmv import platform


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    assert path == str(platform.DEFAULT_CACHE_DIR)
    assert platform.DEFAULT_CACHE_DIR.parent.joinpath("jax_spmv").is_dir()
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_honours_environment(monkeypatch, restore_cache_dir,
                                       tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_on_gpu_matches_default_device():
    assert platform.on_gpu() == (jax.devices()[0].platform == "gpu")


def test_require_gpu_refuses_other_devices():
    if jax.devices()[0].platform == "gpu":
        assert platform.require_gpu().platform == "gpu"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            platform.require_gpu()
