"""Persistent XLA compilation cache for the command-line entry points."""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# A fixed directory inside the checkout: the cache key includes nothing
# about where the cache lives, but a directory that moves is never hit.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache goes to `.jax_cache/` at the root of
    the checkout."""
    import jax

    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
