"""The persistent XLA compile cache every entry point shares.

The frame function takes tens of seconds to compile at full size, so
every entry point calls :func:`enable_compile_cache` first.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
else is set.  Otherwise the cache lives at the fixed ``<repo>/.jax_cache``
(a fixed path: the path is part of what a later run has to find).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
