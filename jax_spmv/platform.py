"""The library's one platform decision, and where compiled code is cached.

Kernel routing (:mod:`jax_spmv.spmv`) asks :func:`on_gpu` whether the
default device is a CUDA GPU; nothing else in the package inspects the
platform.  Scripts that measure the card call :func:`require_gpu`, which
fails instead of falling back to the CPU.
"""

from __future__ import annotations

import os
import pathlib

import jax

# fixed, checkout-relative cache directory (listed in .gitignore): the
# path is part of the persistent cache's key, so it never moves
_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_CACHE_DIR = _REPO_ROOT / ".jax_cache"


def on_gpu() -> bool:
    """True when JAX's default device is a CUDA GPU."""
    return jax.devices()[0].platform == "gpu"


def require_gpu() -> jax.Device:
    """The default device, which must be a GPU; raises otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform} "
            f"({dev.device_kind})")
    return dev


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
    lives in ``.jax_cache`` at the root of the checkout.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
