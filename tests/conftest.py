"""Test configuration: JAX on a virtual 8-device CPU mesh unless
JAX_PLATFORMS says otherwise.

Tests exercise the sharded code paths without several accelerators; the
multi-device path on real cards runs through `chip_smoke.py --four`.
Tests marked `gpu` need the card and skip elsewhere (see `_gpu_only`); on
the card run them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the config route also works when jax was imported before XLA_FLAGS was set
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from slowflow_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute tests, excluded from the default fast tier "
        "(run_tests.sh --all runs them)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips on any other backend. On the card: "
        "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's backend is a GPU. Decided here,
    at run time, so every xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is %r)" % jax.default_backend())
    yield


@pytest.fixture
def rng():
    return np.random.default_rng(0)
