"""Adaptive-frame-rate pipeline end-to-end: quantil.dat + adaptiveFR.dat
drive the high_fr/low_fr split in slow_flow (slow_flow.cpp:274-402), and
dense_tracking fuses hypotheses from both rates (rate ratios exercise
adaptFPS resampling)."""
import os
import textwrap

import numpy as np
import pytest


from slowflow_tpu.io import read_flo
from slowflow_tpu.io.images import write_image

U, V = 1.0, 0.5
H, W = 64, 88
N_FRAMES = 28
START = 4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("adaptive")
    rng = np.random.default_rng(11)
    pad = 40
    base = rng.random((H + 2 * pad, W + 2 * pad, 3)) * 255
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    seq_dir = tmp_path / "seq"
    seq_dir.mkdir()
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(N_FRAMES):
        xs = np.clip(xx + pad - f * U, 0, W + 2 * pad - 2)
        ys = np.clip(yy + pad - f * V, 0, H + 2 * pad - 2)
        x0 = xs.astype(int); y0 = ys.astype(int)
        fx = (xs - x0)[..., None]; fy = (ys - y0)[..., None]
        img = (base[y0, x0] * (1 - fx) * (1 - fy)
               + base[y0, x0 + 1] * fx * (1 - fy)
               + base[y0 + 1, x0] * (1 - fx) * fy
               + base[y0 + 1, x0 + 1] * fx * fy)
        write_image(seq_dir / f"frame_{f:03d}.png", img)

    # stage-1 outputs: per-frame flow-magnitude quantile ~|(U, V)| and the
    # tuning table (hfr targets quantile 2 -> hfr_rate 2 at 40 fps)
    (seq_dir / "quantil.dat").write_text("1.0\n1.2\n")
    (tmp_path / "adaptiveFR.dat").write_text(
        "opt_hfr_quantil\t2\nopt_lfr_quantil\t8\nopt_lfr_rate\t4\n")
    return tmp_path, seq_dir


def test_adaptive_slow_flow_and_multirate_tracking(scene):
    tmp_path, seq_dir = scene
    from slowflow_tpu.cli.slow_flow import main as sf_main
    from slowflow_tpu.cli.dense_tracking import main as dt_main

    cfg = tmp_path / "sf.cfg"
    cfg.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    output\t{tmp_path}/sf_out
    Jets\t4
    start\t{START}
    max_fps\t40
    ref_fps\t10
    adaptive\t1
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t0
    slow_flow_S\t2
    slow_flow_layers\t3
    slow_flow_p_scale\t0.6
    slow_flow_occlusion_reasoning\t0
    slow_flow_niter_alter\t1
    slow_flow_niter_outer\t6
    slow_flow_niter_solver\t25
    """))
    # the cfg directory holds adaptiveFR.dat -> adaptive rates activate
    rc = sf_main([str(cfg), "-batch", "4"])
    assert rc == 0

    out = tmp_path / "sf_out"
    # keyframes = 40/10 = 4, steps 1: hfr_rate 2 (jet_fps 20, skip 2),
    # lfr_rate 4 (jet_fps 10, skip 4)
    high = out / "high_fr"
    low = out / "low_fr"
    assert (high / "frame_004.flo").exists()
    assert (high / "frame_006.flo").exists()
    assert (low / "frame_004.flo").exists()
    assert (low / "frame_008.flo").exists()

    # per-jet flow spans skip frames: high ~2*(U,V), low ~4*(U,V)
    fh = read_flo(high / "frame_004.flo")
    fl = read_flo(low / "frame_004.flo")
    inner = (slice(10, -10), slice(10, -10))
    assert abs(fh[inner][..., 0].mean() - 2 * U) < 0.4
    assert abs(fl[inner][..., 0].mean() - 4 * U) < 0.6

    # config snapshots carry the jet_fps dense_tracking derives rates from
    assert "jet_fps" in (high / "config.cfg").read_text()

    dt_cfg = tmp_path / "dt.cfg"
    dt_cfg.write_text(textwrap.dedent(f"""\
    file\t{seq_dir}/frame_%03i.png
    jet_estimation\t{low}/
    jet_estimation\t{high}/
    flow_format\tframe_%03i
    output\t{tmp_path}/dt_out
    start\t{START}
    max_fps\t40
    ref_fps\t5
    ref_fps_F\t1
    16bit\t0
    raw\t0
    scale\t1.0
    acc_skip_pixel\t0
    acc_epic_interpolation\t1
    acc_alternate\t2
    acc_trws_max_iter\t5
    acc_neigh_hyp\t2
    acc_hyp_neigh_tryouts\t4
    seed\t5
    """))
    rc = dt_main([str(dt_cfg)])
    assert rc == 0

    # Jets = jet_fps[low]/(ref_fps*steps) = 10/5 = 2 -> final span 8 frames
    flow = read_flo(tmp_path / "dt_out" / f"frame_{START:03d}.flo")
    inner = (slice(14, -14), slice(14, -14))
    err = np.hypot(flow[inner][..., 0] - 8 * U, flow[inner][..., 1] - 8 * V)
    assert err.mean() < 1.2, err.mean()
