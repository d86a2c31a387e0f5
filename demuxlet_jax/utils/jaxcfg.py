"""JAX runtime configuration helpers."""

from __future__ import annotations

import os

# fixed default cache location inside the checkout (listed in .gitignore):
# a fixed path, because the path is part of the cache's key
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir(default: str | None = None) -> str:
    """JAX_COMPILATION_CACHE_DIR when set (then no other directory is
    used), else `default`, else DEFAULT_CACHE_DIR."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or default or DEFAULT_CACHE_DIR)


def enable_compilation_cache(default: str | None = None) -> None:
    """Persistent compilation cache: compiled executables are reused
    across processes that run the same shapes."""
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      compilation_cache_dir(default))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
