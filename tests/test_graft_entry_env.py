"""Env construction for the multi-device dry run's CPU fallback child.

The child must come up with EXACTLY the forced device count even when the
parent env already carries a --xla_force_host_platform_device_count flag
(XLA honors the LAST occurrence of a repeated flag).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as g


def test_forced_env_appends_flag_last():
    env = g._forced_cpu_env(8, base_env={})
    flags = env["XLA_FLAGS"].split()
    assert flags[-1] == "--xla_force_host_platform_device_count=8"
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["JAX_COMPILATION_CACHE_DIR"].endswith(".jax_cache")


def test_forced_env_strips_inherited_device_count():
    base = {"XLA_FLAGS": "--xla_force_host_platform_device_count=2 "
                         "--xla_cpu_enable_fast_math=false"}
    env = g._forced_cpu_env(8, base_env=base)
    flags = env["XLA_FLAGS"].split()
    counts = [f for f in flags
              if f.startswith("--xla_force_host_platform_device_count")]
    assert counts == ["--xla_force_host_platform_device_count=8"]
    # unrelated inherited flags survive
    assert "--xla_cpu_enable_fast_math=false" in flags
    # and ours is last, so XLA's last-wins rule picks it
    assert flags[-1] == "--xla_force_host_platform_device_count=8"


def test_forced_env_preserves_other_vars():
    base = {"HOME": "/home/u", "JAX_COMPILATION_CACHE_DIR": "/custom"}
    env = g._forced_cpu_env(4, base_env=base)
    assert env["HOME"] == "/home/u"
    assert env["JAX_COMPILATION_CACHE_DIR"] == "/custom"  # setdefault only
