"""Multi-device batch-sharded slow_flow CLI vs the single-device path.

The CLI auto-shards a jet batch over the device mesh when the group size is
divisible by the device count (cli/slow_flow.py, the replacement for
OpenMP-over-jets at slow_flow.cpp:706). The sharded path runs the SAME
unrolled per-jet body per shard via shard_map
(variational_mt_sharded), so sharded vs single-device outputs must agree
BITWISE — any deviation means the sharding itself perturbed the math.
"""
import textwrap

import numpy as np
import pytest


from slowflow_tpu.io import read_flo

from test_e2e import make_sequence, U, V

JETS = 8
START = 1


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("sharded_e2e")
    return tmp_path, make_sequence(tmp_path)


def _cfg(tmp_path, seq_dir, out):
    cfg = tmp_path / f"sf_{out}.cfg"
    cfg.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{tmp_path}/{out}
    Jets\t{JETS}
    start\t{START}
    max_fps\t40
    ref_fps\t20
    jet_fps\t40
    adaptive\t0
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t0
    slow_flow_method\tforward
    slow_flow_S\t2
    slow_flow_layers\t1
    slow_flow_occlusion_reasoning\t1
    slow_flow_niter_alter\t2
    slow_flow_niter_outer\t3
    slow_flow_niter_solver\t10
    """))
    return cfg


def test_sharded_batch_matches_single_device(seq):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the forced multi-device CPU mesh (run_tests.sh)")

    tmp_path, seq_dir = seq
    from slowflow_tpu.cli.slow_flow import main

    n_dev = len(jax.devices())
    assert JETS % n_dev == 0, "batch must be divisible to hit the mesh path"

    # sharded: one group of JETS jets, JETS % n_dev == 0 -> mesh path
    rc = main([str(_cfg(tmp_path, seq_dir, "sharded")), "-batch", str(JETS)])
    assert rc == 0
    # single-device: group of 3 is never divisible by the mesh -> unrolled
    rc = main([str(_cfg(tmp_path, seq_dir, "single")), "-batch", "3"])
    assert rc == 0

    import glob
    import os
    flos = sorted(glob.glob(str(tmp_path / "sharded" / "*.flo")))
    assert len(flos) == 2 * JETS  # forward + backward per jet
    for f in flos:
        single = str(tmp_path / "single" / os.path.basename(f))
        a = np.asarray(read_flo(f))
        b = np.asarray(read_flo(single))
        # shard_map runs the identical unrolled kernel body per shard, so
        # sharding must not change a single bit
        np.testing.assert_array_equal(a, b, err_msg=os.path.basename(f))
        if f.endswith("_back.flo"):
            continue
        # and the solve recovered the true motion
        inner = a[10:-10, 10:-10]
        assert abs(np.median(inner[..., 0]) - U) < 0.25
        assert abs(np.median(inner[..., 1]) - V) < 0.25
