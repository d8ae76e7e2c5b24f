"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR when set, otherwise
a fixed .jax_cache/ at the checkout root."""
import os

import jax

from slowflow_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.compile_cache_dir() == os.path.join(ROOT,
                                                             ".jax_cache")


def test_enable_sets_jax_config(monkeypatch, tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_clock_counts_a_compile():
    import jax.numpy as jnp

    with compile_cache.CompileClock() as clock:
        jax.jit(lambda x: x * 3.0 + 1.0)(jnp.ones(17)).block_until_ready()
    assert clock.seconds() > 0.0
    # spans are merged: the union never exceeds the clock's own lifetime
    assert clock.seconds() == clock.seconds(since=0.0)
