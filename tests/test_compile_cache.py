"""Placement of the persistent compilation cache (compile_cache.py)."""

import os

import jax
import pytest

from bls12_381_jax import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_jax_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_wins(monkeypatch, tmp_path, restore_jax_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_ignored_dir_in_checkout(monkeypatch,
                                            restore_jax_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        listed = {line.strip().rstrip("/") for line in f}
    assert ".jax_cache" in listed, ".jax_cache must be listed in .gitignore"


def test_path_stable_across_calls(monkeypatch, restore_jax_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert compile_cache.cache_dir() == first
    assert compile_cache.enable_compile_cache() == first
