"""Persistent XLA compilation cache setup.

First compiles take seconds to minutes; caching them on disk makes repeat
pipeline runs start fast.  The cache lives where JAX_COMPILATION_CACHE_DIR
says when it is set, and otherwise at one fixed directory inside the
checkout (the path is part of the cache key, so it must not move).
"""

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The compile-cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Point JAX's persistent compile cache at cache_dir(); returns it."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
