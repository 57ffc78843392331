"""Persistent compile cache at a fixed path.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
program sets no cache directory in code.  Where it is unset, the cache goes
to ``<checkout>/.jax_cache`` (listed in ``.gitignore``): a fixed path, since
the path is part of what makes a cached entry found again.
"""
from __future__ import annotations

import os
import pathlib

#: cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def enable() -> str | None:
    """Point JAX's persistent compile cache at ``DEFAULT_DIR`` unless the
    environment names one; returns the directory set, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
