"""Compile-cache directory selection (tpu_blosc.compile_cache)."""

import os

from tpu_blosc import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_names_the_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_default_is_a_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.compile_cache_dir()
    assert first == os.path.join(ROOT, ".jax_cache")
    assert compile_cache.compile_cache_dir() == first  # stable across calls
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
