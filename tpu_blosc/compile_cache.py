"""JAX's persistent compilation cache for this checkout's scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and
JAX reads it itself; nothing here overrides it.  Otherwise the cache is
``.jax_cache/`` at the root of the checkout: a fixed path, because the
path is part of what a later process must find again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on for every compiled program; returns
    its directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
