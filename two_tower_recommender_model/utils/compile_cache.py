"""JAX's persistent compilation cache, kept at one fixed place."""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache before anything compiles.

    When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
    is set here. Otherwise the cache goes to `<repo>/.jax_cache`: a fixed
    path, because the path is part of the cache key. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
