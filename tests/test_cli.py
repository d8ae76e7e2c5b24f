"""CLI contract tests: flag parsing, rate derivation, naming conventions —
the parts of the CLI surface that don't need the heavy compute path."""
import os

import numpy as np

from slowflow_tpu.cli.common import (
    sintel_frame_name, frame_path, unique_output_dir,
)
from slowflow_tpu.cli.slow_flow import compute_rates, read_adaptive_table
from slowflow_tpu.cli.adaptive_fr import quantile_of_magnitudes
from slowflow_tpu.config import ParameterList
from slowflow_tpu.tracking.driver import TrackingConfig


def test_sintel_frame_numbering():
    # sintel ids encode frame*1000 + subframe with 42 subframes per frame
    # (slow_flow.cpp:453-465)
    assert sintel_frame_name(491000, 0) == (491, 0)
    assert sintel_frame_name(491000, 43) == (492, 1)
    assert sintel_frame_name(491000, -1) == (490, 41)
    assert sintel_frame_name(491005, 40) == (492, 3)


def test_frame_path():
    assert frame_path("/seq", "f_%03i.png", 10, 2, False) == "/seq/f_012.png"
    assert frame_path("/seq", "o_%i_%03i.png", 491000, 1, True) \
        == "/seq/o_491_001.png"


def test_unique_output_dir(tmp_path):
    base = str(tmp_path / "out")
    os.makedirs(base)
    # without resume/overwrite: suffix _N (slow_flow.cpp:253-265)
    assert unique_output_dir(base, resume=False, overwrite=False) \
        == base + "_1/"
    os.makedirs(base + "_1")
    assert unique_output_dir(base, resume=False, overwrite=False) \
        == base + "_2/"
    assert unique_output_dir(base, resume=True, overwrite=False) == base + "/"


def test_compute_rates_no_keyframes():
    # exact-rate branch (slow_flow.cpp:325-336)
    hfr, lfr = compute_rates(quantil=1.0, hfr_quantil=2.0, lfr_rate_mult=4,
                             keyframes=0, steps=2)
    assert hfr == 2
    assert lfr % hfr == 0


def test_compute_rates_keyframes_divisibility():
    # keyframe branch: hfr*steps must divide keyframes; lfr*steps aligned
    # (slow_flow.cpp:338-351)
    hfr, lfr = compute_rates(quantil=0.5, hfr_quantil=2.0, lfr_rate_mult=4,
                             keyframes=10, steps=2)
    assert hfr >= 4
    assert keyframes_ok(hfr, lfr, 10, 2)


def keyframes_ok(hfr, lfr, keyframes, steps):
    if lfr * steps < keyframes:
        return keyframes % (lfr * steps) == 0 \
            and (lfr * steps) % (hfr * steps) == 0
    return (lfr * steps) % (hfr * steps) == 0


def test_read_adaptive_table(tmp_path):
    (tmp_path / "adaptiveFR.dat").write_text(
        "opt_hfr_quantil\t2\nopt_lfr_quantil\t8\nopt_lfr_rate\t4\n")
    hq, lr, found = read_adaptive_table([str(tmp_path)])
    assert found and hq == 2.0 and lr == 4
    hq, lr, found = read_adaptive_table([str(tmp_path / "missing")])
    assert not found


def test_quantile_convention():
    # reference quantile index: np = q*n - 1, interpolating at even indices
    # (adaptiveFR.cpp:660-666)
    flows = [np.zeros((4, 5, 2), np.float32)]
    flows[0][..., 0] = np.arange(20, dtype=np.float32).reshape(4, 5)
    q, mx = quantile_of_magnitudes(flows, 0.90)
    assert mx == 19.0
    assert 16.0 <= q <= 18.0


def test_tracking_config_from_cfg(tmp_path):
    cfg = tmp_path / "dt.cfg"
    cfg.write_text(
        "acc_skip_pixel\t1\nacc_alternate\t3\nacc_approach\t1\n"
        "acc_beta\t10.0\nacc_traj_sim_method\t2\nseed\t42\n")
    params = ParameterList(str(cfg))
    tc = TrackingConfig.from_parameter_list(params, jets=4, rates=1)
    assert tc.skip_pixel == 1
    assert tc.alternate == 3
    assert tc.approach == 1
    assert tc.acc_beta == 10.0
    assert tc.traj_sim_method == 2
    assert tc.seed == 42
    # defaults flow through (dense_tracking.cpp:118-166)
    assert tc.acc_occ == 500.0
    assert tc.trws_max_iter == 10


def test_slow_flow_defaults():
    from slowflow_tpu.cli.slow_flow import set_default

    p = ParameterList()
    set_default(p)
    assert p.parameter("slow_flow_S", type=int) == 2
    assert p.parameter("slow_flow_sor_omega", type=float) == 1.9
    assert p.parameter("slow_flow_occlusion_reasoning", type=bool) is True
    mf_defaults_ok(p)


def mf_defaults_ok(p):
    from slowflow_tpu.variational.multiframe import MultiFrameParams

    mp = MultiFrameParams.from_parameter_list(p)
    assert mp.S == 2
    assert mp.sor_omega == 1.9
    assert mp.rho == (1.0,)
    assert mp.occlusion_reasoning is True
    # the batching choice follows the dataclass default and is overridable
    assert mp.unroll_jets is MultiFrameParams.unroll_jets
    p.set_parameter("slow_flow_unroll_jets", "0")
    assert MultiFrameParams.from_parameter_list(p).unroll_jets is False


def test_slow_flow_batched_sharded_mesh():
    """The batched jet solve must run with its batch axis sharded over the
    virtual multi-device mesh (the CLI's multi-chip path)."""
    import jax
    import numpy as np

    if len(jax.devices()) < 2:
        import pytest
        pytest.skip("needs multi-device mesh")

    from slowflow_tpu.parallel.mesh import make_mesh, shard_jet_batch
    from slowflow_tpu.variational.multiframe import (
        MultiFrameParams, variational_mt_batched)

    n = len(jax.devices())
    b, h, w = n, 32, 40
    rng = np.random.default_rng(0)
    seq = rng.random((b, 3, 3, h, w)).astype(np.float32) * 255
    p = MultiFrameParams(S=2, rho=(1.0,), omega=(1.0,), layers=1,
                         niter_alter=1, niter_outer=2, niter_solver=5,
                         occlusion_reasoning=False)
    mesh = make_mesh(n_jet=n, n_sp=1)
    wx = np.zeros((b, h, w), np.float32)
    args = shard_jet_batch(mesh, wx, wx.copy(), seq,
                           np.ones((b, 3, h, w), np.float32),
                           np.zeros((b, 3), np.float32),
                           np.ones((b, 3), np.float32))
    out = variational_mt_batched(args[0], args[1], args[2], p,
                                 args[3], args[4], args[5])
    assert np.asarray(out[0]).shape == (b, h, w)
