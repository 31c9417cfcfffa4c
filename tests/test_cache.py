"""Persistent compilation cache location (utils/cache.py)."""

import os

import jax

from ldpc_tpu.utils.cache import DEFAULT_CACHE_DIR, enable_compilation_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restore(saved):
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def _saved():
    return (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)


def test_cache_obeys_environment_variable(tmp_path, monkeypatch):
    saved = _saved()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    try:
        path = enable_compilation_cache()
        assert path == str(tmp_path / "cc")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
    finally:
        _restore(saved)


def test_cache_default_is_fixed_repo_path(monkeypatch):
    saved = _saved()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compilation_cache()
        assert path == DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        _restore(saved)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
