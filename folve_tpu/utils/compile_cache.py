"""Where JAX keeps its persistent compilation cache.

A new filter shape otherwise stalls its first stream for the whole XLA
compile on every restart.  The cache directory is part of the cache
key, so it must not move between runs: it is either the directory that
``JAX_COMPILATION_CACHE_DIR`` names (JAX reads that variable itself) or
a fixed ``.jax_cache`` directory inside the checkout.
"""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Sets nothing when ``JAX_COMPILATION_CACHE_DIR``
    is set.  Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT_DIR, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
