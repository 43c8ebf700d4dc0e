"""Persistent XLA compilation cache.

Sketch-step programs are compiled per chunk-count bucket; the persistent
cache makes every process after the first start hot. JAX_COMPILATION_CACHE_DIR,
when set, is JAX's own setting and is left alone; otherwise the cache lives
at a fixed `<checkout>/.jax_cache` (the path is part of the cache key, so it
must not move between runs).
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> None:
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    try:
        DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return  # read-only checkout: run uncached rather than fail
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
