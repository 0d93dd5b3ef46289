"""Where the persistent XLA compilation cache lives.

JAX_COMPILATION_CACHE_DIR, when set, names the directory and JAX reads it
itself.  Otherwise the cache goes to one fixed directory inside the checkout
(`.jax_cache/`, listed in .gitignore): the path is part of the cache key,
so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The compilation-cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache (chunk-step programs are
    large; later processes load them instead of compiling).  Returns the
    directory."""
    import jax

    d = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return d
