"""JAX's persistent compilation cache, at one fixed place.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to ``.jax_cache/`` at the root
of the checkout (listed in ``.gitignore``): a fixed path, because the path is
part of what the cache is keyed on, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
