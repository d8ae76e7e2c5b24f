"""Trajectory accumulation and forward-backward consistency kernels.

Array re-expression of utils/utils.cpp:449-996: the per-pixel sequential chains
become a `lax.scan` over the jet axis with all pixels updated in parallel;
bilinear flow sampling is a batched gather.

Conventions: flows are [J, H, W, 2] with channel order (u, v) = (x, y)
displacement; positions are (x, y). UNKNOWN_FLOW marks lost pixels.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.flo import UNKNOWN_FLOW


def bilinear_sample(field, x, y):
    """Sample [H, W, C] field at float (x, y); clamp-at-border semantics of
    the reference's bilinearInterp (utils.h:183-218): the +1 neighbour is only
    used when inside."""
    h, w = field.shape[:2]
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0c = jnp.clip(x0, 0, w - 1)
    y0c = jnp.clip(y0, 0, h - 1)
    x1c = jnp.clip(x0 + 1, 0, w - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)
    fx = jnp.clip(x - x0, 0.0, 1.0) * (x0 + 1 <= w - 1)
    fy = jnp.clip(y - y0, 0.0, 1.0) * (y0 + 1 <= h - 1)
    fx = fx[..., None]
    fy = fy[..., None]
    return (field[y0c, x0c] * (1 - fx) * (1 - fy)
            + field[y0c, x1c] * fx * (1 - fy)
            + field[y1c, x0c] * (1 - fx) * fy
            + field[y1c, x1c] * fx * fy)


def _grid(h, w, xy_incr, xy_start):
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    return xx * xy_incr + xy_start, yy * xy_incr + xy_start


@partial(jax.jit, static_argnames=("skip_pixel", "discard", "has_occ"))
def _acc_consistent(forward, backward, occlusions, epsilon,
                    skip_pixel: int, discard: bool, has_occ: bool):
    J, oh, ow = forward.shape[:3]
    xy_incr = skip_pixel + 1
    xy_start = int(0.5 * skip_pixel)
    h = int(np.floor(oh / xy_incr))
    w = int(np.floor(ow / xy_incr))
    gx, gy = _grid(h, w, xy_incr, xy_start)

    last0 = forward[0, gy.astype(jnp.int32), gx.astype(jnp.int32)]

    def step(carry, inp):
        acc, last, occluded, tracked, f = carry
        fwd, bwd, occ_f = inp

        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = (cx >= 0) & (cx < ow) & (cy >= 0) & (cy < oh)

        # occlusion trigger at the current correspondence (rounded position)
        rx = jnp.clip(jnp.round(cx).astype(jnp.int32), 0, ow - 1)
        ry = jnp.clip(jnp.round(cy).astype(jnp.int32), 0, oh - 1)
        occ_hit = has_occ & inside & (occ_f[ry, rx] == 0)

        vec = bilinear_sample(fwd, cx, cy)
        nx = cx + vec[..., 0]
        ny = cy + vec[..., 1]
        inside_n = (nx >= 0) & (nx < ow) & (ny >= 0) & (ny < oh)
        bvec = bilinear_sample(bwd, nx, ny)
        diff = jnp.where(inside_n[..., None], vec + bvec, vec - last)
        err = jnp.linalg.norm(diff, axis=-1)
        inconsistent = err > epsilon

        # new accumulated flow for active pixels
        acc_cv = acc + last                      # constant-velocity fallback
        acc_ok = acc + vec
        new_acc = jnp.where(inside[..., None],
                            jnp.where(inconsistent[..., None], acc_cv, acc_ok),
                            acc_cv)
        new_last = jnp.where((inside & ~inconsistent)[..., None], vec, last)

        lost = (~inside) | inconsistent | occ_hit
        first_loss = lost & (tracked == J)
        new_tracked = jnp.where(first_loss, 0 if discard else f + 1, tracked)

        active = ~occluded
        acc = jnp.where(active[..., None], new_acc, 0.0)
        last = jnp.where(active[..., None], new_last, last)
        tracked = jnp.where(active, new_tracked, tracked)
        occluded = occluded | (active & occ_hit)

        return (acc, last, occluded, tracked, f + 1), acc

    occ_in = occlusions if has_occ else jnp.zeros((J, oh, ow), jnp.uint8)
    init = (jnp.zeros((h, w, 2)), last0, jnp.zeros((h, w), bool),
            jnp.full((h, w), J, jnp.int32), jnp.int32(0))
    (acc, _, _, tracked, _), acc_seq = jax.lax.scan(
        step, init, (forward, backward, occ_in))
    return acc_seq, tracked


def accumulate_consistent_batches(forward, backward, occlusions=None,
                                  epsilon=1.0, skip_pixel=0, discard=False):
    """Consistent trajectory accumulation with constant-velocity fallback
    (accumulateConsistentBatches, utils.cpp:517-617).

    forward/backward: [J, H, W, 2]; occlusions: optional [J, H, W] uint8 where
    0 marks an occluded correspondence. Returns
    (acc_forward [J, h, w, 2], tracked [h, w] int32) on the subsampled grid.
    """
    forward = jnp.asarray(forward, jnp.float32)
    backward = jnp.asarray(backward, jnp.float32)
    has_occ = occlusions is not None
    occ = jnp.asarray(occlusions) if has_occ else None
    return _acc_consistent(forward, backward, occ, float(epsilon),
                           int(skip_pixel), bool(discard), has_occ)


@partial(jax.jit, static_argnames=())
def _acc_flow(forward, occlusions):
    J, h, w = forward.shape[:3]
    gx, gy = _grid(h, w, 1, 0)

    def step(carry, inp):
        acc, occluded, f = carry
        fwd, occ_prev = inp
        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        rx = jnp.clip(jnp.round(cx).astype(jnp.int32), 0, w - 1)
        ry = jnp.clip(jnp.round(cy).astype(jnp.int32), 0, h - 1)
        becomes_occ = (f > 0) & inside & (occ_prev[ry, rx] != 0)
        vec = bilinear_sample(fwd, cx, cy)
        new_acc = acc + vec
        now_occ = occluded | becomes_occ | ~inside
        out = jnp.where(now_occ[..., None], UNKNOWN_FLOW, new_acc)
        acc = jnp.where(now_occ[..., None], acc, new_acc)
        return (acc, now_occ, f + 1), out

    init = (jnp.zeros((h, w, 2)), jnp.zeros((h, w), bool), jnp.int32(0))
    # occlusions[i-1] gates step i; prepend a zero map for step 0
    occ_shift = jnp.concatenate([jnp.zeros_like(occlusions[:1]),
                                 occlusions[:-1]], 0)
    (_, _, _), acc_seq = jax.lax.scan(step, init, (forward, occ_shift))
    return acc_seq


def accumulate_flow(forward, occlusions):
    """Accumulate flow chains, marking pixels lost to occlusion with
    UNKNOWN_FLOW (accumulateFlow, utils.cpp:860-916).

    forward: [J, H, W, 2]; occlusions: [J, H, W] (nonzero = occluded).
    Returns acc [J, H, W, 2].
    """
    return _acc_flow(jnp.asarray(forward, jnp.float32),
                     jnp.asarray(occlusions))


def fuse_occlusions(forward, occlusions, start: int, length: int):
    """Accumulate occlusion state along flow chains (fuseOcclusions,
    utils.cpp:724-766). Returns [H, W] uint8 (1 = occluded)."""
    forward = jnp.asarray(forward, jnp.float32)
    occlusions = jnp.asarray(occlusions)
    J, h, w = forward.shape[:3]
    gx, gy = _grid(h, w, 1, 0)

    def step(carry, inp):
        acc, occluded = carry
        fwd, occ_f = inp
        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        rx = jnp.clip(jnp.round(cx).astype(jnp.int32), 0, w - 1)
        ry = jnp.clip(jnp.round(cy).astype(jnp.int32), 0, h - 1)
        occ_hit = inside & (occ_f[ry, rx] != 0)
        vec = bilinear_sample(fwd, cx, cy)
        new_occ = occluded | occ_hit | ~inside
        new_acc = jnp.where((occluded | occ_hit | ~inside)[..., None],
                            acc * 0.0, acc + vec)
        return (new_acc, new_occ), None

    init = (jnp.zeros((h, w, 2)), jnp.zeros((h, w), bool))
    (acc, occluded), _ = jax.lax.scan(
        step, init, (forward[start:start + length],
                     occlusions[start:start + length]))
    return np.asarray(occluded).astype(np.uint8)


def accumulate_batches(forward, backward, mask, S: int, skip_pixel: int = 0):
    """Accumulate forward and backward flow over jet batches
    (accumulateBatches, utils.cpp:918-996). mask [h, w] (0 = invalid).
    Returns (acc_forward [J, h, w, 2], acc_backward [J, h, w, 2])."""
    forward = jnp.asarray(forward, jnp.float32)
    backward = jnp.asarray(backward, jnp.float32)
    J, oh, ow = forward.shape[:3]
    steps = S - 1
    xy_incr = skip_pixel + 1
    xy_start = int(0.5 * skip_pixel)
    h = int(np.floor(oh / xy_incr))
    w = int(np.floor(ow / xy_incr))
    gx, gy = _grid(h, w, xy_incr, xy_start)
    maskv = jnp.asarray(mask)[..., None]

    def step(carry, inp):
        acc, accb, last, lastb, i = carry
        fwd, bwd = inp
        jet_frame = i % steps

        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = ((cx >= 0) & (cx < ow) & (cy >= 0) & (cy < oh))[..., None]
        vec = bilinear_sample(fwd, cx, cy)
        incr = jnp.where(inside, acc + vec,
                         acc + (jet_frame + 1).astype(jnp.float32) * last)
        last = jnp.where(inside & (jet_frame == 0), vec, last)

        bx = gx + accb[..., 0]
        by = gy + accb[..., 1]
        inside_b = ((bx >= 0) & (bx < ow) & (by >= 0) & (by < oh))[..., None]
        vecb = bilinear_sample(bwd, bx, by)
        incr_b = jnp.where(inside_b, accb + vecb,
                           acc + (jet_frame + 1).astype(jnp.float32) * lastb)
        lastb = jnp.where(inside_b & (jet_frame == 0), vecb, lastb)

        out_f = jnp.where(maskv == 0, UNKNOWN_FLOW, incr)
        out_b = jnp.where(maskv == 0, UNKNOWN_FLOW, incr_b)

        commit = jet_frame == steps - 1
        acc = jnp.where(commit, incr, acc)
        accb = jnp.where(commit, incr_b, accb)
        return (acc, accb, last, lastb, i + 1), (out_f, out_b)

    init = (jnp.zeros((h, w, 2)), jnp.zeros((h, w, 2)),
            jnp.zeros((h, w, 2)), jnp.zeros((h, w, 2)), jnp.int32(0))
    _, (accf, accb) = jax.lax.scan(step, init, (forward, backward[::-1]))
    return accf, accb[::-1]


def forward_backward_consistency(forward, backward, S: int, epsilon: float,
                                 jetwise: bool = False, skip_pixel: int = 0):
    """Keyframe-stride FB-consistency (forwardBackwardConsistency,
    utils.cpp:619-722): accumulate forward/backward flow over batches of
    `steps = S-1` jets on the subsampled grid, then compare round trips.

    Returns (mask [h, w] float, flow_diff [h, w]) with the reference's
    convention: mask 1 = consistent, 0 = inconsistent.
    """
    forward = jnp.asarray(forward, jnp.float32)
    backward = jnp.asarray(backward, jnp.float32)
    J, oh, ow = forward.shape[:3]
    steps = S - 1
    J = J - (J % steps)
    xy_incr = skip_pixel + 1
    xy_start = int(0.5 * skip_pixel)
    h = int(np.floor(oh / xy_incr))
    w = int(np.floor(ow / xy_incr))
    gx, gy = _grid(h, w, xy_incr, xy_start)

    if jetwise:
        def step(carry, inp):
            mask, diff = carry
            fwd, bwd = inp
            fg = fwd[gy.astype(jnp.int32), gx.astype(jnp.int32)]
            cx = (gx + steps * fg[..., 0]) / xy_incr
            cy = (gy + steps * fg[..., 1]) / xy_incr
            inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            bwd_s = bwd[gy.astype(jnp.int32), gx.astype(jnp.int32)]
            d = fg + jnp.where(inside[..., None],
                               bilinear_sample(bwd, cx * xy_incr + xy_start,
                                               cy * xy_incr + xy_start), 0.0)
            err = jnp.linalg.norm(d, axis=-1)
            mask = jnp.where(err > epsilon, 0.0, mask)
            return (mask, err), None

        (mask, diff), _ = jax.lax.scan(
            step, (jnp.ones((h, w)), jnp.zeros((h, w))),
            (forward[:J:steps], backward[:J:steps]))
        return mask, diff

    def acc_step(acc, fwd):
        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = ((cx >= 0) & (cx < ow) & (cy >= 0) & (cy < oh))[..., None]
        return acc + jnp.where(inside, bilinear_sample(fwd, cx, cy), 0.0), None

    acc_f, _ = jax.lax.scan(acc_step, jnp.zeros((h, w, 2)),
                            forward[steps - 1:J:steps])
    acc_b, _ = jax.lax.scan(acc_step, jnp.zeros((h, w, 2)),
                            backward[J - steps::-steps]
                            if steps > 0 else backward[::-1])
    cx = (gx + acc_f[..., 0]) / xy_incr
    cy = (gy + acc_f[..., 1]) / xy_incr
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    bvec = bilinear_sample(acc_b, jnp.clip(cx, 0, w - 1),
                           jnp.clip(cy, 0, h - 1))
    diff = jnp.linalg.norm(acc_f + bvec, axis=-1)
    diff = jnp.where(inside, diff, jnp.float32(2 ** 31 - 1))
    mask = jnp.where(inside & (diff > epsilon), 0.0, 1.0)
    return mask, diff


def forward_backward_check(forward, backward, epsilon: float,
                           jetwise: bool = True):
    """FB-consistency mask (forwardBackwardCheck, utils.cpp:449-515).

    Returns [H, W] uint8 mask where 1 marks *inconsistent* pixels (the
    reference's convention).
    """
    forward = jnp.asarray(forward, jnp.float32)
    backward = jnp.asarray(backward, jnp.float32)
    J, h, w = forward.shape[:3]
    gx, gy = _grid(h, w, 1, 0)

    if jetwise:
        def step(mask, inp):
            fwd, bwd = inp
            cx = gx + fwd[..., 0]
            cy = gy + fwd[..., 1]
            inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            diff = fwd + jnp.where(inside[..., None],
                                   bilinear_sample(bwd, cx, cy), 0.0)
            err = jnp.linalg.norm(diff, axis=-1)
            return mask | (err > epsilon), None

        mask, _ = jax.lax.scan(step, jnp.zeros((h, w), bool),
                               (forward, backward))
        return np.asarray(mask).astype(np.uint8)

    def acc_step(acc, fwd):
        cx = gx + acc[..., 0]
        cy = gy + acc[..., 1]
        inside = ((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h))[..., None]
        return acc + jnp.where(inside, bilinear_sample(fwd, cx, cy), 0.0), None

    acc_f, _ = jax.lax.scan(acc_step, jnp.zeros((h, w, 2)), forward)
    acc_b, _ = jax.lax.scan(acc_step, jnp.zeros((h, w, 2)), backward[::-1])
    cx = gx + acc_f[..., 0]
    cy = gy + acc_f[..., 1]
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    diff = acc_f + bilinear_sample(acc_b, cx, cy)
    err = jnp.linalg.norm(diff, axis=-1)
    mask = jnp.where(inside, err > epsilon, True)
    return np.asarray(mask).astype(np.uint8)
