"""Persistent XLA compilation cache location.

One helper for every entry point (the CLI, `bench.py`, `chip_smoke.py`),
so repeat runs of the same shapes skip the jit compiles.  When
`JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing is
set here.  Otherwise the cache lives at a fixed `<checkout>/.jax_cache`:
the directory is part of the cache key, so a path built from a
temporary name, a pid or the time would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Make sure JAX's persistent compilation cache is on; returns the
    directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    DEFAULT_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
