"""Bilinear warping with boundary masks.

Matches `Variational_AUX_MT::image_warp` (variational_aux_mt.cpp:722-756):
sample src at (x + factor*wx, y + factor*wy) with bilinear weights; sample
coordinates are clamped per-corner (RECTIFY); the mask is 1 iff the continuous
coordinate lies inside [0, W-1] x [0, H-1].

The four corners are plain gathers, so the result is exact in f32 whatever
the flow (no matrix product, hence no reduced-precision contraction).
"""
from __future__ import annotations

import jax.numpy as jnp


def _coords(wx, wy, factor, h, w):
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=wx.dtype),
                          jnp.arange(w, dtype=wx.dtype), indexing="ij")
    x = xx + factor * wx
    y = yy + factor * wy
    return x, y


def warp_bilinear(src: jnp.ndarray, wx: jnp.ndarray, wy: jnp.ndarray,
                  factor: float = 1.0, with_mask: bool = True):
    """Warp `src` [..., H, W] by flow (wx, wy) [H, W] scaled by `factor`.

    Returns (warped, mask) — mask is float32 [H, W] (1 inside, 0 outside),
    or None when with_mask is False.
    """
    h, w = src.shape[-2], src.shape[-1]
    x, y = _coords(wx, wy, factor, h, w)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x0c = jnp.clip(x0i, 0, w - 1)
    x1c = jnp.clip(x0i + 1, 0, w - 1)
    y0c = jnp.clip(y0i, 0, h - 1)
    y1c = jnp.clip(y0i + 1, 0, h - 1)

    top = (1.0 - dx) * src[..., y0c, x0c] + dx * src[..., y0c, x1c]
    bottom = (1.0 - dx) * src[..., y1c, x0c] + dx * src[..., y1c, x1c]
    out = (1.0 - dy) * top + dy * bottom

    if not with_mask:
        return out, None
    mask = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).astype(src.dtype)
    return out, mask


def warp_image(src: jnp.ndarray, wx: jnp.ndarray, wy: jnp.ndarray):
    """Two-frame variant (variational_aux.c:18-52): factor fixed to 1."""
    return warp_bilinear(src, wx, wy, factor=1.0, with_mask=True)


def warp_backward(img: jnp.ndarray, flow: jnp.ndarray, scale: float = 1.0):
    """Backward warping (utils/utils.cpp:286-306): sample `img` at
    (x - scale*u, y - scale*v); unknown-flow pixels produce zeros.

    img [..., H, W]; flow [H, W, 2]. Returns the warped image.
    """
    from ..io.flo import UNKNOWN_FLOW_THRESH

    u = flow[..., 0]
    v = flow[..., 1]
    known = (jnp.abs(u) <= UNKNOWN_FLOW_THRESH) & \
        (jnp.abs(v) <= UNKNOWN_FLOW_THRESH)
    out, mask = warp_bilinear(img, jnp.where(known, -scale * u, 0.0),
                              jnp.where(known, -scale * v, 0.0))
    return out * jnp.where(known, mask, 0.0)
