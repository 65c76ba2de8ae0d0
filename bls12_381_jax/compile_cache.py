"""Where the entry points keep JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
lives at a fixed directory inside the checkout (listed in .gitignore), so
that every run of every entry point finds what an earlier one compiled.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`,
    caching every compile regardless of how long it took; returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
