"""The persistent XLA compile cache for the entry scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and JAX reads it
itself; nothing else is set here.  Otherwise the cache lives at a fixed
path inside the checkout (``.jax_cache/``, git-ignored): the directory is
part of the cache key, so it never depends on a temporary name, a pid or
the time.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
