"""Sparse grid matching — the built-in replacement for the DeepMatching binary.

The reference invokes an external `deepmatching` executable and parses its
`x1 y1 x2 y2` text output (slow_flow.cpp:766-784, io.c:23-47). The framework
ingests those files when present; this module provides a native matcher with
the same output contract: for a grid of points in im1, find the integer
displacement in [-radius, radius]^2 minimizing the sum of absolute differences
over a local patch, with a forward-backward consistency check.

Array formulation: instead of per-patch loops, scan over displacements — each
step is one shifted absolute-difference image plus a box filter (all fused
elementwise/stencil work), with a running argmin kept at the grid points only.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _box_filter(x, r: int):
    """Sum over a (2r+1)^2 window, zero-padded, as two separable
    reduce_window sums.

    The integral-image (double-cumsum) formulation this replaces ran as
    multi-pass associative scans — and the matcher evaluates the box
    filter once per displacement inside a (2*radius+1)^2 fori_loop. Two
    d-tap window sums are ~18 adds/pixel of plain elementwise work and
    numerically tighter (no huge cumsum partials)."""
    from jax import lax

    d = 2 * r + 1
    s = lax.reduce_window(x, 0.0, lax.add, (1, d), (1, 1), "SAME")
    return lax.reduce_window(s, 0.0, lax.add, (d, 1), (1, 1), "SAME")


@partial(jax.jit, static_argnames=("radius", "patch_r"))
def _match_costs(g1, g2, ys, xs, radius: int, patch_r: int):
    """For each grid point, SAD cost over all (2*radius+1)^2 displacements.

    g1, g2: [H, W] luminance. Returns [P, D, D] costs (D = 2*radius+1).
    """
    d = 2 * radius + 1

    def one_disp(k, best):
        dy = k // d - radius
        dx = k % d - radius
        shifted = _shift2(g2, dy, dx)
        diff = jnp.abs(g1 - shifted)
        # invalid (out of image) regions get high cost
        valid = _shift2(jnp.ones_like(g2), dy, dx)
        cost_map = _box_filter(diff + (1.0 - valid) * 1e3, patch_r)
        c = cost_map[ys, xs]
        return best.at[:, k].set(c)

    costs = jnp.full((ys.shape[0], d * d), jnp.inf, jnp.float32)
    costs = jax.lax.fori_loop(0, d * d, one_disp, costs)
    return costs.reshape(ys.shape[0], d, d)


def _shift2(x, dy, dx):
    """out[y, x] = x[y + dy, x + dx], zero padded; dy/dx traced scalars."""
    h, w = x.shape
    big = jnp.pad(x, ((h, h), (w, w)))
    return jax.lax.dynamic_slice(big, (h + dy, w + dx), (h, w))


@partial(jax.jit, static_argnames=("radius", "patch_r"))
def _grid_match_core(im1, im2, ys, xs, radius: int, patch_r: int):
    """Forward match + backward check in one compiled dispatch."""
    g1 = (0.299 * im1[0] + 0.587 * im1[1] + 0.114 * im1[2]) / 255.0
    g2 = (0.299 * im2[0] + 0.587 * im2[1] + 0.114 * im2[2]) / 255.0
    h, w = g1.shape
    d = 2 * radius + 1

    costs_f = _match_costs(g1, g2, ys, xs, radius, patch_r)
    kf = jnp.argmin(costs_f.reshape(-1, d * d), axis=1)
    dyf = kf // d - radius
    dxf = kf % d - radius

    x2 = jnp.clip(xs + dxf, 0, w - 1)
    y2 = jnp.clip(ys + dyf, 0, h - 1)
    costs_b = _match_costs(g2, g1, y2, x2, radius, patch_r)
    kb = jnp.argmin(costs_b.reshape(-1, d * d), axis=1)
    dyb = kb // d - radius
    dxb = kb % d - radius

    fb_err = jnp.hypot((dxf + dxb).astype(jnp.float32),
                       (dyf + dyb).astype(jnp.float32))
    return dxf, dyf, fb_err


def grid_matches(im1: np.ndarray, im2: np.ndarray, step: int = 8,
                 radius: int = 32, patch_r: int = 4,
                 fb_threshold: float = 2.0) -> np.ndarray:
    """Dense-grid matches between [3, H, W] images.

    Returns [N, 4] float32 (x1, y1, x2, y2), forward-backward checked.
    """
    return grid_matches_batched(im1[None], im2[None], step, radius, patch_r,
                                fb_threshold)[0]


def grid_matches_batched(im1s, im2s, step: int = 8, radius: int = 32,
                         patch_r: int = 4,
                         fb_threshold: float = 2.0) -> list[np.ndarray]:
    """Matches for a batch of [B, 3, H, W] pairs in ONE device dispatch —
    the jet-batched replacement for per-pair DeepMatching invocations
    (slow_flow.cpp:766-784 shells out once per jet)."""
    im1s = jnp.asarray(im1s, jnp.float32)
    im2s = jnp.asarray(im2s, jnp.float32)
    h, w = im1s.shape[2:]
    ys_np, xs_np = np.mgrid[step // 2:h:step, step // 2:w:step]
    ys = jnp.asarray(ys_np.ravel())
    xs = jnp.asarray(xs_np.ravel())

    core = jax.vmap(partial(_grid_match_core, radius=radius,
                            patch_r=patch_r), in_axes=(0, 0, None, None))
    dxf, dyf, fb_err = jax.jit(core)(im1s, im2s, ys, xs)
    dxf = np.asarray(dxf)
    dyf = np.asarray(dyf)
    keep = np.asarray(fb_err) <= fb_threshold
    out = []
    for b in range(im1s.shape[0]):
        m = np.stack([xs_np.ravel(), ys_np.ravel(),
                      xs_np.ravel() + dxf[b],
                      ys_np.ravel() + dyf[b]], 1)
        out.append(m[keep[b]].astype(np.float32))
    return out
