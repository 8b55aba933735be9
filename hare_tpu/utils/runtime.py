"""Process set-up for the entry points (bench, configs, examples, smoke).

The library sets nothing at import; an entry point calls these once at
start-up:

- :func:`require_gpu` refuses to run anywhere but a GPU backend, so a
  measurement can never silently fall back to the CPU.
- :func:`setup_compile_cache` points JAX's persistent compilation cache at
  ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads the variable
  itself), and otherwise at ``.jax_cache/`` in the checkout.  The path is
  part of the cache key, so it is fixed: never a temporary name, a pid or
  the time.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["REPO_CACHE_DIR", "require_gpu", "setup_compile_cache"]

REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU; raise otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"a GPU backend is required, but JAX's default device is "
            f"{dev.platform!r} ({dev.device_kind}); this entry point does "
            f"not fall back to another platform"
        )
    return dev


def setup_compile_cache() -> str:
    """Enable the persistent compile cache; return the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
