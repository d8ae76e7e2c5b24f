"""Measured baseline anchor: time the REAL reference `epicflow` binary at
the pipeline's working resolution (480x270) against our epicflow CLI.

The reference binary's per-pair time is a strict LOWER bound on the
reference's per-jet cost (a slow_flow jet adds the multi-frame window,
occlusion MRF and alternation on top of the same epic + variational core),
so `vs_baseline` claims anchored on it are conservative.

Usage: python tools/measure_baseline.py  (needs the reference sources and
Pillow)
"""
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "tests" / "parity"))

import make_parity_fixture as fx  # noqa: E402

H, W = 270, 480
OUT = Path(tempfile.gettempdir()) / "baseline_measure"


def make_inputs():
    from PIL import Image

    rng = np.random.default_rng(3)
    pad = 24
    base = rng.random((H + 2 * pad, W + 2 * pad, 3)).astype(np.float32) * 255
    for _ in range(3):
        base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                       + np.roll(base, 1, 1) + np.roll(base, -1, 1))
    base = (base - base.min()) / (base.max() - base.min()) * 255
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    u, v = 2.2, -1.3

    def sample(xs, ys):
        xs = np.clip(xs + pad, 0, base.shape[1] - 2)
        ys = np.clip(ys + pad, 0, base.shape[0] - 2)
        x0 = np.floor(xs).astype(int)
        y0 = np.floor(ys).astype(int)
        fxp = (xs - x0)[..., None]
        fyp = (ys - y0)[..., None]
        return (base[y0, x0] * (1 - fxp) * (1 - fyp)
                + base[y0, x0 + 1] * fxp * (1 - fyp)
                + base[y0 + 1, x0] * (1 - fxp) * fyp
                + base[y0 + 1, x0 + 1] * fxp * fyp)

    im1 = np.round(sample(xx, yy)).astype(np.uint8)
    im2 = np.round(sample(xx - u, yy - v)).astype(np.uint8)

    OUT.mkdir(exist_ok=True)
    Image.fromarray(im1).save(OUT / "im1.png")
    Image.fromarray(im2).save(OUT / "im2.png")

    g = im1.astype(np.float32).mean(-1)
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    gx[:, 1:-1] = 0.5 * (g[:, 2:] - g[:, :-2])
    gy[1:-1] = 0.5 * (g[2:] - g[:-2])
    e = np.hypot(gx, gy)
    edges = (e / (e.max() + 1e-9)).astype(np.float32)
    # SED binary format: transposed float32 (io.c:14-20)
    edges.T.astype(np.float32).tofile(OUT / "edges.dat")

    lines = []
    for y in range(4, H - 4, 8):
        for x in range(4, W - 4, 8):
            x2, y2 = x + u, y + v
            if 0 <= x2 <= W - 1 and 0 <= y2 <= H - 1:
                lines.append(f"{x} {y} {x2:.4f} {y2:.4f} 1.0 100")
    (OUT / "matches.txt").write_text("\n".join(lines) + "\n")
    return u, v


def main():
    u, v = make_inputs()
    binary = fx.build_oracle()

    import os
    env = dict(os.environ, OMP_NUM_THREADS="1")
    args = [str(binary), str(OUT / "im1.png"), str(OUT / "im2.png"),
            str(OUT / "edges.dat"), str(OUT / "matches.txt"),
            str(OUT / "ref.flo"), "-sintel"]
    subprocess.run(args, check=True, capture_output=True,
                   env=env)                                 # warm FS caches
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        subprocess.run(args, check=True, capture_output=True, env=env)
        times.append(time.perf_counter() - t0)
    t_ref = min(times)

    from slowflow_tpu.cli.epicflow import main as ours

    def run_ours():
        t0 = time.perf_counter()
        rc = ours([str(OUT / "im1.png"), str(OUT / "im2.png"),
                   str(OUT / "edges.dat"), str(OUT / "matches.txt"),
                   str(OUT / "ours.flo"), "-sintel"])
        assert rc == 0
        return time.perf_counter() - t0

    run_ours()                                  # compile/warm
    t_ours = min(run_ours() for _ in range(3))

    from slowflow_tpu.io import read_flo
    ref = np.asarray(read_flo(OUT / "ref.flo"))
    mine = np.asarray(read_flo(OUT / "ours.flo"))
    epe = float(np.hypot(*(ref - mine).transpose(2, 0, 1)).mean())
    print(f"reference epicflow binary (1 thread, 480x270): {t_ref:.2f} s")
    print(f"our epicflow CLI (same pair):                  {t_ours:.2f} s")
    print(f"mean EPE ours vs reference: {epe:.4f} px; gt=({u},{v})")


if __name__ == "__main__":
    main()
