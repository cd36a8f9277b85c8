"""JAX's persistent compilation cache at a fixed path.

A fit compiles one large program per (problem spec, options); on a GPU that
compile can take longer than the fit itself.  The cache keeps compiled
programs across processes.  The path is part of the cache's key, so it never
moves: `$JAX_COMPILATION_CACHE_DIR` when set, else `.jax_cache` at the root
of the checkout (listed in .gitignore).
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory: $JAX_COMPILATION_CACHE_DIR, else DEFAULT_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir() and
    return that path.  Call before the first compilation."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
