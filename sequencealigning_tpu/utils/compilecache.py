"""Persistent XLA compilation cache bootstrap.

Affects compile time only -- never results or kernel timings.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and this
module sets no other directory.  Otherwise the cache goes to one fixed
directory inside the checkout (``.jax_cache``, listed in .gitignore): a
fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_dir() -> str:
    """The checkout-local cache directory used when ENV is unset."""
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def cache_dir() -> str:
    """Where the cache lives: ENV if set, else default_dir()."""
    return os.environ.get(ENV) or default_dir()


def enable() -> str:
    """Turn the persistent cache on and return its directory ("" when
    SEQALIGN_NO_COMPILE_CACHE opts out, as the test suite does: it
    manages its own cache)."""
    if os.environ.get("SEQALIGN_NO_COMPILE_CACHE"):
        return ""
    path = cache_dir()
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
