"""Minimal runnable demo: synthesize a moving sequence, run the three
pipeline stages through their CLIs, and render the final reference flow.

    python examples/demo.py [output_dir]

Produces <output_dir>/dt_out/frame_004.flo plus color visualizations at every
stage. Uses the built-in edge detector and grid matcher (no external
binaries); runs on CPU or GPU, whichever JAX selects.
"""
from __future__ import annotations

import os
import sys
import tempfile
import textwrap

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slowflow_tpu.io import read_flo
from slowflow_tpu.io.images import write_image
from slowflow_tpu.utils.colorwheel import flow_color_img

U, V = 1.0, 0.5
H, W, N = 72, 96, 12
START = 4


def make_sequence(seq_dir):
    rng = np.random.default_rng(7)
    pad = 40
    base = rng.random((H + 2 * pad, W + 2 * pad, 3)) * 255
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(N):
        xs = xx + pad - f * U
        ys = yy + pad - f * V
        x0 = np.floor(xs).astype(int); y0 = np.floor(ys).astype(int)
        fx = (xs - x0)[..., None]; fy = (ys - y0)[..., None]
        img = (base[y0, x0] * (1 - fx) * (1 - fy)
               + base[y0, x0 + 1] * fx * (1 - fy)
               + base[y0 + 1, x0] * (1 - fx) * fy
               + base[y0 + 1, x0 + 1] * fx * fy)
        write_image(os.path.join(seq_dir, f"frame_{f:03d}.png"), img)


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="slowflow_demo_")
    seq_dir = os.path.join(root, "seq")
    os.makedirs(seq_dir, exist_ok=True)
    make_sequence(seq_dir)
    print(f"sequence: {seq_dir} (motion {U}, {V} px/frame)")

    from slowflow_tpu.cli.adaptive_fr import main as afr
    afr(["-path", root, "-folder", "seq", "-format", "frame_%03i.png",
         "-scale", "0.5", "-skip", "2", "-samples", "2", "-step", "2",
         "-start", "0"])

    sf_cfg = os.path.join(root, "slow_flow.cfg")
    with open(sf_cfg, "w") as f:
        f.write(textwrap.dedent(f"""\
        file\t{seq_dir}/frame_%03i.png
        output\t{root}/sf_out
        Jets\t2
        start\t{START}
        max_fps\t40
        ref_fps\t20
        jet_fps\t40
        adaptive\t0
        16bit\t0
        raw\t0
        scale\t1.0
        deep_matching\t0
        slow_flow_S\t2
        slow_flow_layers\t2
        slow_flow_p_scale\t0.8
        slow_flow_occlusion_reasoning\t1
        slow_flow_niter_alter\t2
        slow_flow_niter_outer\t4
        slow_flow_niter_solver\t20
        """))
    from slowflow_tpu.cli.slow_flow import main as sf
    sf([sf_cfg, "-batch", "2"])

    dt_cfg = os.path.join(root, "dense_tracking.cfg")
    with open(dt_cfg, "w") as f:
        f.write(textwrap.dedent(f"""\
        file\t{seq_dir}/frame_%03i.png
        jet_estimation\t{root}/sf_out/
        flow_format\tframe_%03i
        output\t{root}/dt_out
        start\t{START}
        max_fps\t40
        ref_fps\t20
        ref_fps_F\t1
        16bit\t0
        raw\t0
        scale\t1.0
        acc_skip_pixel\t0
        acc_alternate\t2
        acc_trws_max_iter\t5
        acc_neigh_hyp\t2
        acc_hyp_neigh_tryouts\t4
        seed\t3
        """))
    from slowflow_tpu.cli.dense_tracking import main as dt
    dt([dt_cfg])

    flo = os.path.join(root, "dt_out", f"frame_{START:03d}.flo")
    flow = read_flo(flo)
    inner = flow[12:-12, 12:-12]
    print(f"final flow: mean u={inner[..., 0].mean():.3f} "
          f"v={inner[..., 1].mean():.3f} (ground truth {2 * U}, {2 * V})")
    vis = os.path.join(root, "dt_out", "final_flow.png")
    write_image(vis, flow_color_img(flow[..., 0], flow[..., 1]))
    print(f"outputs under {root}")


if __name__ == "__main__":
    main()
