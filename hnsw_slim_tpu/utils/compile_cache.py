"""Persistent XLA compilation cache, shared by the bench and the scripts."""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this sets
    nothing. Otherwise the cache goes to `<checkout>/.jax_cache`, a fixed path
    so that later runs from the same checkout hit it.
    """
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
