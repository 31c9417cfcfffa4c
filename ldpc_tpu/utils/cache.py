"""Persistent XLA compilation cache setup.

The decode engines compile large programs (the unrolled QC chunk is tens of
thousands of HLO ops), and a cold compile of the bench program takes tens
of seconds. JAX's persistent cache makes that a one-time cost per
(program, config) across processes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache in that
directory and this module sets no other. Otherwise the cache is the fixed
``.jax_cache/`` at the repository root (listed in ``.gitignore``): the path
is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent; safe to
    call before or after backend init). Returns the cache directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
