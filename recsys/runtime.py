"""Process-level set-up shared by the entry points: the persistent compile
cache and a description of the devices JAX runs on."""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed, inside the checkout: the directory is part of the cache's key, so a
# path that moved between runs (temporary, per-process, per-time) never hits
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here; otherwise the cache goes to ``.jax_cache/`` at
    the root of the checkout."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def device_info() -> dict:
    """Platform, kind and count of the devices JAX sees (initializes the
    backend)."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
