"""End-to-end pipeline benchmark: adaptive_fr -> slow_flow -> dense_tracking
through the REAL CLIs on a teaser-shaped synthetic sequence.

The north star (BASELINE.md) is defined on a full teaser sequence; this
harness measures the whole pipeline — frame I/O, EPIC init, device solves,
occlusion output, dense tracking — not just the device kernel. The scene is
the bench.py two-layer scene (translating background + counter-moving
foreground disc, real occlusion boundaries) generated directly at the
480x270 working resolution (the reference's teaser works at scale 0.25 of
1080p; generating at working res measures the same compute without 12 MB
PNG decodes inflating stage I/O).

Production shape: 200 fps -> 20 fps, S=3 (steps=2) => 5 jets per final
pair (dense_tracking.cpp:564). Default --jets 10 / --finals 2 keeps the
wall-clock bounded; --jets 225 reproduces the full teaser jet count.

Usage: python tools/bench_pipeline.py [--jets N] [--finals N] [--out DIR]
Prints one JSON line with per-stage wall-clock, the part of each stage spent
tracing and compiling, and accuracy checks.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from slowflow_tpu.utils.compile_cache import (  # noqa: E402
    CompileClock, enable_compile_cache)

U, V = 1.5, -0.8
H, W = 270, 480
START = 2     # = ref * skip: the first jet window reaches back ref frames


def make_sequence(seq_dir: Path, n_frames: int, seed=0):
    """The two-layer scene of tools/scene.py (background translating
    (U, V) px/frame, counter-moving foreground disc) at frame times
    0..n_frames-1, saved as 8-bit PNGs."""
    from scene import two_layer_frames

    from slowflow_tpu.io.images import write_image

    pad = int(np.ceil(n_frames * max(abs(U), abs(V)))) + 4
    frames = two_layer_frames(range(n_frames), H, W, U, V, seed=seed,
                              pad=pad)
    seq_dir.mkdir(parents=True, exist_ok=True)
    for f, im in enumerate(frames):
        write_image(seq_dir / f"frame_{f:04d}.png",
                    np.repeat(im[..., None], 3, -1))


def run_pipeline(root: Path, jets: int, finals: int, samples: int = 4,
                 batch: int = 4, threads: int = 1):
    """Returns the metrics dict; `root` is wiped first. Stage times are
    wall clock and include compilation; `stageN_compile_s` is the part of
    stage N spent tracing, lowering and compiling (utils.compile_cache.
    CompileClock)."""
    with CompileClock() as clock:
        return _run_pipeline(root, jets, finals, samples, batch, threads,
                             clock)


def _run_pipeline(root, jets, finals, samples, batch, threads, clock):
    import textwrap

    from slowflow_tpu.cli.adaptive_fr import main as afr_main
    from slowflow_tpu.cli.dense_tracking import main as dt_main
    from slowflow_tpu.cli.slow_flow import main as sf_main
    from slowflow_tpu.io import read_flo

    if root.exists():
        shutil.rmtree(root)
    steps = 2                       # S = 3
    n_frames = START + 1 + (jets + 2) * steps
    t0 = time.perf_counter()
    make_sequence(root / "seq", n_frames)
    t_gen = time.perf_counter() - t0

    # ---------------------------------------------------------- stage 1
    c1 = time.time()
    t0 = time.perf_counter()
    rc = afr_main(["-path", str(root), "-folder", "seq",
                   "-format", "frame_%04i.png", "-scale", "0.5",
                   "-skip", "2", "-samples", str(samples), "-step", "2",
                   "-start", "0"])
    assert rc == 0
    t1 = time.perf_counter() - t0
    quantil = float(open(root / "seq" / "quantil.dat").readline())

    # ---------------------------------------------------------- stage 2
    # full production config (cfgs/slow_flow.cfg defaults); adaptive off so
    # jets/finals arithmetic stays exact: 200->20 fps, steps=2 => 5 jets
    # per final pair
    cfg2 = root / "slow_flow.cfg"
    cfg2.write_text(textwrap.dedent(f"""\
    file	{root}/seq/frame_%04i.png
    output	{root}/sf_out
    Jets	{jets}
    start	{START}
    max_fps\t200
    ref_fps\t20
    jet_fps\t200
    adaptive\t0
    16bit\t0
    raw\t0
    scale\t1.0
    deep_matching\t1
    slow_flow_method\tsymmetric
    slow_flow_S\t3
    slow_flow_rho_0\t1
    slow_flow_rho_1\t1
    slow_flow_omega_0\t0
    slow_flow_omega_1\t2
    slow_flow_dataterm\t1
    slow_flow_smoothing\t1
    slow_flow_delta\t1.0
    slow_flow_gamma\t6.0
    slow_flow_alpha\t4.0
    slow_flow_layers\t5
    slow_flow_p_scale\t0.9
    slow_flow_occlusion_reasoning\t1
    slow_flow_niter_alter\t10
    slow_flow_niter_outer\t10
    slow_flow_niter_inner\t1
    slow_flow_niter_solver\t30
    """))
    c2 = time.time()
    t0 = time.perf_counter()
    rc = sf_main([str(cfg2), "-batch", str(batch)])
    assert rc == 0
    t2 = time.perf_counter() - t0

    def bg_mask(f_lo: int, f_hi: int):
        """True background pixels over frames [f_lo, f_hi]: everything
        outside the foreground disc's trajectory corridor (the corridor's
        true flow is the DISC's counter-motion, so scoring it against the
        background constant penalizes correct output)."""
        yy, xx = np.mgrid[0:H, 0:W]
        cy, cx, r = H // 2, W // 2, min(H, W) // 6
        m = np.ones((H, W), bool)
        for f in range(f_lo, f_hi + 1):
            m &= ((yy - (cy + f * V)) ** 2
                  + (xx - (cx - f * U)) ** 2) >= (r + 6) ** 2
        return m

    flow0 = read_flo(root / "sf_out" / f"frame_{START:04d}.flo")
    inner = (slice(12, -12), slice(12, -12))
    bg = np.hypot(flow0[inner][..., 0] - steps * U,
                  flow0[inner][..., 1] - steps * V)
    sf_mask = bg_mask(START, START + steps)[inner]
    sf_err = float(np.median(bg[sf_mask]))

    # ---------------------------------------------------------- stage 3
    cfg3 = root / "dense_tracking.cfg"
    cfg3.write_text(textwrap.dedent(f"""\
    file\t{root}/seq/frame_%04i.png
    jet_estimation\t{root}/sf_out/
    flow_format\tframe_%04i
    output\t{root}/dt_out
    start\t{START}
    max_fps\t200
    ref_fps\t20
    ref_fps_F\t{finals}
    16bit\t0
    raw\t0
    scale\t1.0
    acc_skip_pixel\t1
    acc_occlusion\t0
    acc_epic_interpolation\t1
    acc_epic_skip\t2
    acc_alternate\t5
    acc_trws_max_iter\t10
    acc_neigh_hyp\t5
    acc_hyp_neigh_tryouts\t20
    acc_consistency_threshold\t1.0
    acc_brightness_constancy\t0.1
    acc_gradient_constancy\t1.0
    seed\t3
    """))
    c3 = time.time()
    t0 = time.perf_counter()
    dt_args = [str(cfg3)]
    if threads > 1:
        dt_args += ["-threads", str(threads)]
    rc = dt_main(dt_args)
    assert rc == 0
    t3 = time.perf_counter() - t0

    dt_jets = 200 // (20 * steps)          # jets per final pair
    dt_flow = read_flo(root / "dt_out" / f"frame_{START:04d}.flo")
    # final flow is in subsampled-grid units: the reference divides by
    # xy_incr = acc_skip_pixel + 1 (dense_tracking.cpp:1856-1857)
    xy_incr = 2.0
    dt_inner = (slice(6, -6), slice(6, -6))
    dt_bg = np.hypot(
        dt_flow[dt_inner][..., 0] - dt_jets * steps * U / xy_incr,
        dt_flow[dt_inner][..., 1] - dt_jets * steps * V / xy_incr)
    dt_mask = bg_mask(START, START + dt_jets * steps)[::int(xy_incr),
                                                      ::int(xy_incr)]
    dt_err = float(np.median(dt_bg[dt_mask[dt_inner]]))

    k1 = clock.seconds(c1) - clock.seconds(c2)
    k2 = clock.seconds(c2) - clock.seconds(c3)
    k3 = clock.seconds(c3)
    solves = 2 * jets                       # forward + backward per jet
    return {
        "pipeline_s": t1 + t2 + t3,
        # whole-pipeline amortized jet throughput: the north-star metric
        # (frame-pairs/sec) charged with EVERY cost — stage-1 sampling,
        # EPIC init, I/O, device solves, and dense tracking
        "pipeline_jets_per_sec": jets / (t1 + t2 + t3),
        "stage1_adaptive_fr_s": t1,
        "stage1_compile_s": k1,
        "stage2_slow_flow_s": t2,
        "stage2_compile_s": k2,
        "stage2_solves": solves,
        "stage2_solves_per_sec": solves / t2,
        "stage3_dense_tracking_s": t3,
        "stage3_compile_s": k3,
        "stage3_finals": finals,
        "stage3_threads": threads,
        "stage3_s_per_final": t3 / finals,
        "jets": jets,
        "quantil": quantil,
        "sf_flow_err_px": sf_err,
        "dt_flow_err_px": dt_err,
        "seq_gen_s": t_gen,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jets", type=int, default=10)
    ap.add_argument("--finals", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--threads", type=int, default=1,
                    help="stage-3 final-pair batch + prefetch threads")
    ap.add_argument("--out", default="",
                    help="working directory (default: a temporary one)")
    args = ap.parse_args()

    enable_compile_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = run_pipeline(Path(args.out or tmp) / "run", args.jets,
                           args.finals, batch=args.batch,
                           threads=args.threads)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
