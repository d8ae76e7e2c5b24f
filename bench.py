"""Benchmark: the stage-2 jet solve, one stage-3 final pair, and the
three-CLI pipeline, on one GPU.

Workload (BASELINE.md): the Slow Flow multi-frame variational jet solve at
the default working configuration (cfgs/slow_flow.cfg: scale 0.25 of 1080p
-> 480x270 working resolution, S=3 window, 5 pyramid layers at p_scale 0.9,
10 alter x 10 outer x 30 SOR iterations, occlusion reasoning on), batched
over jets on one device; stage 3 at Jets=10, K=16 with EPIC hypotheses; and
the adaptive_fr -> slow_flow -> dense_tracking pipeline on 8 jets.

A measurement runs only on the card: without a GPU the script exits
non-zero. `--small` runs a reduced solve anywhere as a smoke test. Every
result names the device it ran on.

Usage: python bench.py [--batch B] [--no-dt] [--no-pipeline] [--small]
Prints ONE JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "tools"))

from scene import moving_sequence  # noqa: E402


def jets_per_sec(batch, h, w, p, repeats=7):
    """Stage-2 solve throughput with device-resident inputs (staging the
    window to the device is set-up, not timed). Completion is forced by
    fetching a scalar reduction of all outputs."""
    import jax
    import jax.numpy as jnp

    from slowflow_tpu.variational.multiframe import variational_mt_batched

    f = 2 * p.ref + 1
    seq = jnp.asarray(np.stack(
        [moving_sequence(f, h, w, 1.5 + 0.2 * s, -0.8, seed=s)
         for s in range(batch)]))
    wx = jnp.zeros((batch, h, w), jnp.float32)
    wy = jnp.zeros((batch, h, w), jnp.float32)
    jax.block_until_ready(seq)

    def run(k=1):
        # k > 1: enqueue k executions of the SAME compiled program before
        # the single scalar fetch — steady-state pipelined dispatch, as the
        # CLIs run it (prefetch thread keeps the device queue non-empty).
        # The k=1 number pays one dispatch+fetch round trip per batch.
        outs = [variational_mt_batched(wx, wy, seq, p) for _ in range(k)]
        return float(sum(jnp.sum(o) for out in outs for o in out))

    t0 = time.perf_counter()
    run()
    first_call_s = time.perf_counter() - t0
    # sanity: the solve must have recovered most of the motion
    out = variational_mt_batched(wx, wy, seq, p)
    err = abs(float(np.median(np.asarray(out[0])[0, 8:-8, 8:-8])) - 1.5)
    times, times3 = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        run(3)
        times3.append(time.perf_counter() - t0)
    return {"single_dispatch": batch / min(times),
            "pipelined_k3": batch / (min(times3) / 3),
            "wall_s_per_batch": min(times),
            "first_call_s": first_call_s,
            "flow_recovery_err_px": err}


def dt_final_pair_seconds(h=270, w=480, jets=10, seed=0):
    """Stage-3 dense tracking at the production shape (Jets=10, working
    resolution, capacity 16, 5 alternations, 20 tryouts, EPIC-interpolated
    hypotheses ON — the production default, driver.py TrackingConfig):
    seconds per final frame pair and the recovered-flow error."""
    import jax.numpy as jnp

    from slowflow_tpu.core.conv import DERIV_5PT, conv_horiz, conv_vert
    from slowflow_tpu.core.image import normalize_sequence, rgb_to_lab
    from slowflow_tpu.epic import EpicParams
    from slowflow_tpu.epic.edges import detect_edges
    from slowflow_tpu.tracking.driver import TrackingConfig, track_final_pair

    u, v = 1.5, -0.8
    frames = moving_sequence(jets + 1, h, w, u, v, seed=seed)
    stack, avg, std = normalize_sequence(frames)
    dx = np.asarray(conv_horiz(jnp.asarray(stack), DERIV_5PT))
    dy = np.asarray(conv_vert(jnp.asarray(stack), DERIV_5PT))
    data = np.moveaxis(stack, 1, -1)
    data_dx = np.moveaxis(dx, 1, -1)
    data_dy = np.moveaxis(dy, 1, -1)

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx, r = h // 2, w // 2, min(h, w) // 6
    fg = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
    fwd = np.zeros((jets, h, w, 2), np.float32)
    fwd[..., 0] = np.where(fg, -u, u)
    fwd[..., 1] = v
    fwd += rng.normal(0, 0.08, fwd.shape).astype(np.float32)
    bwd = (-fwd).astype(np.float32)
    sw = np.full((h, w), 0.4, np.float32)

    from dataclasses import replace

    cfg = TrackingConfig(jets=jets, rates=1, skip_pixel=1, capacity=16,
                         alternate=5, hyp_neigh_tryouts=20,
                         epic_interpolation=True, seed=1)
    rate_flows = [(fwd, bwd, None)]
    im0 = jnp.asarray(frames[0])
    epic_ctx = (np.asarray(rgb_to_lab(im0)),
                np.asarray(detect_edges(im0)), EpicParams.sintel())

    def run(c):
        t0 = time.perf_counter()
        flow, occ, info = track_final_pair(c, rate_flows, fwd, bwd, None,
                                           data, data_dx, data_dy, sw,
                                           epic_ctx=epic_ctx)
        return time.perf_counter() - t0, flow

    # a 2-alternation pass compiles every kernel (the alternation loop is
    # host-level and reuses the cached jits), so the warmup stays short
    run(replace(cfg, alternate=2))
    wall, flow = run(cfg)
    gt = fwd.sum(0)[::2, ::2, 0] / 2
    err = float(np.median(np.abs(flow[8:-8, 8:-8, 0] - gt[8:-8, 8:-8])))
    return wall, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4, help="jet batch")
    ap.add_argument("--no-dt", action="store_true",
                    help="skip the dense-tracking stage metric")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="skip the end-to-end CLI pipeline metric")
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--small", action="store_true",
                    help="reduced solve only, on any backend (smoke test)")
    args = ap.parse_args(argv)

    from slowflow_tpu.utils.compile_cache import enable_compile_cache
    from slowflow_tpu.utils.device import card_name_and_power, device_info
    from slowflow_tpu.variational.multiframe import MultiFrameParams

    enable_compile_cache()
    device = device_info()
    if device["platform"] != "gpu" and not args.small:
        print(f"bench.py: no GPU (JAX platform {device['platform']!r}); "
              "measurements run only on the card, --small runs a smoke "
              "test anywhere", file=sys.stderr)
        return 2

    if args.small:
        p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), layers=2,
                             niter_alter=2, niter_outer=3, niter_solver=10,
                             occlusion_reasoning=True, smoothing=1)
        h, w, batch = 96, 128, 2
    else:
        # cfgs/slow_flow.cfg defaults at the 1080p*0.25 working resolution
        p = MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0,
                             rho=(1.0, 1.0), omega=(0.0, 2.0),
                             layers=5, p_scale=0.9,
                             niter_alter=10, niter_outer=10, niter_inner=1,
                             niter_solver=30, occlusion_reasoning=True,
                             smoothing=1)
        h, w, batch = args.height, args.width, args.batch

    solve = jets_per_sec(batch, h, w, p)
    best = max(solve["single_dispatch"], solve["pipelined_k3"])
    out = {
        "metric": "stage-2 jets/s per device (1080p jets @ scale 0.25, S=3, "
                  "full slow_flow config)",
        "value": best,
        "unit": "jets/s",
        "device": device,
        "card": card_name_and_power(),
        "batch": batch, "height": h, "width": w,
        "jets_per_sec_single_dispatch": solve["single_dispatch"],
        "jets_per_sec_pipelined_k3": solve["pipelined_k3"],
        "value_method": ("pipelined_k3"
                         if solve["pipelined_k3"] >= solve["single_dispatch"]
                         else "single_dispatch"),
        "wall_s_per_batch": solve["wall_s_per_batch"],
        "solve_first_call_s": solve["first_call_s"],
        "flow_recovery_err_px": solve["flow_recovery_err_px"],
    }
    if not (args.no_dt or args.small):
        dt_wall, dt_err = dt_final_pair_seconds()
        out["dt_seconds_per_final_pair"] = dt_wall
        out["dt_flow_err_px"] = dt_err

    # end-to-end pipeline through the real CLIs (adaptive_fr -> slow_flow
    # -> dense_tracking); tools/bench_pipeline.py scales it to 225 jets
    if not (args.no_pipeline or args.small):
        from bench_pipeline import run_pipeline

        with tempfile.TemporaryDirectory() as tmp:
            out["pipeline"] = run_pipeline(Path(tmp) / "run", jets=8,
                                           finals=2, samples=2, threads=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
