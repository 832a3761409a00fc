"""Persistent XLA compile cache, set up the same way by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at a fixed path
inside the checkout, ``<checkout>/.jax_cache`` (listed in
``.gitignore``): the path is part of the cache key, so it is never built
from a temporary name, a pid or the time.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache(default_dir: str = DEFAULT_DIR,
                         min_compile_secs: float = 0.5) -> str:
    """Turn the persistent cache on; return the directory in effect."""
    import jax

    env = os.environ.get(ENV)
    if not env:
        jax.config.update("jax_compilation_cache_dir", default_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return env or default_dir
