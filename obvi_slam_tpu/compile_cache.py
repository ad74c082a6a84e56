"""Persistent XLA compilation cache location, shared by every entry point."""

import os
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent


def cache_dir(environ=None) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path: the cache key includes it, so a moving directory never
    hits)."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_ROOT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point jax's persistent compilation cache at ``cache_dir()``."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
