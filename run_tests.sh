#!/bin/sh
# Test runner on the virtual 8-device CPU mesh. XLA reads XLA_FLAGS when jax
# is first imported, so the device count is set here, at process start;
# tests/conftest.py sets the same defaults for a bare `pytest`.
#
# Tiers:
#   default : fast tier (skips tests marked `slow`).
#   --all   : every test, slow end-to-end ones included; extra arguments
#             (e.g. a test path) pass through to pytest.
# Tests marked `gpu` skip here; run them on the card with
#   JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
run() {
    exec env \
        JAX_PLATFORMS=cpu \
        XLA_FLAGS="--xla_force_host_platform_device_count=8 ${XLA_FLAGS:-}" \
        python -m pytest "$@"
}

if [ "$1" = "--all" ]; then
    shift
    if [ $# -eq 0 ]; then
        set -- tests/
    fi
    run "$@"
fi
run tests/ -m "not slow" "$@"
