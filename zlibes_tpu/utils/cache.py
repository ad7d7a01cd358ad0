"""Persistent XLA compilation cache setup.

The codec compiles one program per (lanes, tokens, table-width) bucket,
and a cold GPU compile of the matcher and decode programs takes seconds
to minutes.  A persistent on-disk cache lets every later process start
warm.
"""
from __future__ import annotations

import os
from pathlib import Path

# inside the checkout (listed in .gitignore): the cache path is part of
# the cache key, so it must not move between runs
DEFAULT_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")
_done = False


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's own
    ``.jax_cache`` directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> None:
    """Enable the on-disk cache for accelerator backends.

    Deliberately skipped for CPU: XLA:CPU AOT cache entries are
    machine-feature-sensitive and reload with loud warnings.
    """
    global _done
    if _done:
        return
    _done = True
    import jax

    if jax.default_backend() == "cpu":
        return
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
