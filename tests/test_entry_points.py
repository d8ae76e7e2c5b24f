"""Measurement entry points refuse to run without a GPU: they exit non-zero
and print no result, except `bench.py --small` (a smoke test anywhere)."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_bench_without_gpu_exits_nonzero():
    r = _run("bench.py", "--no-dt", "--no-pipeline")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no GPU" in r.stderr


def test_chip_smoke_without_gpu_exits_nonzero():
    r = _run("chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_small_runs_on_cpu():
    r = _run("bench.py", "--small")
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["flow_recovery_err_px"] < 0.2
