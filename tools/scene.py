"""Seeded two-layer test scene shared by bench.py, tools/bench_pipeline.py
and chip_smoke.py.

A smooth random background translates (u, v) px per frame while a disc of
its own texture, centred in the frame at time 0, moves (-u, v): real
occlusion boundaries keep the occlusion reasoning and the alternation loop
busy, and the true flow is known at every pixel.
"""
from __future__ import annotations

import numpy as np


def two_layer_frames(times, h, w, u, v, seed=0, pad=16):
    """Gray frames [len(times), h, w], 0-255, at the given frame times.
    `pad` is the texture margin; samples beyond it are clamped."""
    rng = np.random.default_rng(seed)
    shape = (h + 2 * pad, w + 2 * pad)
    base = rng.random(shape).astype(np.float32) * 255
    fg = rng.random(shape).astype(np.float32) * 255
    for _ in range(2):  # cheap smoothing
        base = 0.25 * (np.roll(base, 1, 0) + np.roll(base, -1, 0)
                       + np.roll(base, 1, 1) + np.roll(base, -1, 1))
        fg = 0.25 * (np.roll(fg, 1, 0) + np.roll(fg, -1, 0)
                     + np.roll(fg, 1, 1) + np.roll(fg, -1, 1))
    yy, xx = np.mgrid[0:h, 0:w]

    def sample(img, dx_t, dy_t):
        xs = np.clip(xx + pad - dx_t, 0, shape[1] - 2)
        ys = np.clip(yy + pad - dy_t, 0, shape[0] - 2)
        x0 = xs.astype(int)
        y0 = ys.astype(int)
        fx = xs - x0
        fy = ys - y0
        return (img[y0, x0] * (1 - fx) * (1 - fy)
                + img[y0, x0 + 1] * fx * (1 - fy)
                + img[y0 + 1, x0] * (1 - fx) * fy
                + img[y0 + 1, x0 + 1] * fx * fy)

    cy, cx, r = h // 2, w // 2, min(h, w) // 6
    frames = []
    for t in times:
        im = sample(base, t * u, t * v)
        im_fg = sample(fg, -t * u, t * v)          # foreground counter-moves
        in_fg = ((yy - (cy + t * v)) ** 2
                 + (xx - (cx - t * u)) ** 2) < r * r
        frames.append(np.where(in_fg, im_fg, im))
    return np.stack(frames)


def moving_sequence(f, h, w, u, v, seed=0):
    """[f, 3, h, w] window whose middle frame is time 0."""
    ref = (f - 1) // 2
    gray = two_layer_frames(range(-ref, f - ref), h, w, u, v, seed=seed)
    return np.repeat(gray[:, None], 3, 1)
