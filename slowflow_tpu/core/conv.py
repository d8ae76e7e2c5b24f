"""Separable convolutions with clamp-to-edge boundaries.

The reference's `convolve_horiz/vert` (epic_flow_extended/image.c:400-645)
implement separable correlation with edge-replicate padding: the fast 3/5-tap
paths fold out-of-range taps onto the border pixel, and the generic path's
accumulated coefficients do the same. Out[i] = sum_k coeffs[k] * src[i+k-order]
with src clamped to [0, N-1].

Filters are expressed exactly like the reference (image.c:351-373): a
`half_coeffs` array and an even/odd flag produce the full tap vector
  even (symmetric):      coeffs[order -+ i] = half[i]
  odd  (anti-symmetric): coeffs[order - i] = +half[i], coeffs[order + i] = -half[i]

Key filters:
  DERIV_5PT  = conv(order=2, half=[0, -8/12, 1/12], odd)
             -> [1/12, -8/12, 0, 8/12, -1/12]  (4th-order central difference)
  DERIV_3PT  = conv(order=1, half=[0, -0.5], odd) -> [-0.5, 0, 0.5]

All ops run on [..., H, W] arrays and are jit/vmap friendly.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def full_coeffs(half_coeffs, even: bool) -> np.ndarray:
    half = np.asarray(half_coeffs, np.float32)
    order = len(half) - 1
    coeffs = np.zeros(2 * order + 1, np.float32)
    for i in range(order + 1):
        if even:
            coeffs[order - i] = half[i]
            coeffs[order + i] = half[i]
        else:
            coeffs[order - i] = +half[i]
            coeffs[order + i] = -half[i]
    return coeffs


DERIV_5PT = full_coeffs([0.0, -8.0 / 12.0, 1.0 / 12.0], even=False)
DERIV_3PT = full_coeffs([0.0, -0.5], even=False)


def _shift_clamped(x: jnp.ndarray, off: int, axis: int) -> jnp.ndarray:
    """x shifted so out[i] = x[clamp(i + off)] along `axis` (edge replicate).

    Implemented as slice + edge pad (pure data movement), which XLA fuses
    into the consuming elementwise op.
    """
    if off == 0:
        return x
    axis = axis % x.ndim
    pads = [(0, 0)] * x.ndim
    idx = [slice(None)] * x.ndim
    if off > 0:
        idx[axis] = slice(off, None)
        pads[axis] = (0, off)
    else:
        idx[axis] = slice(None, off)
        pads[axis] = (-off, 0)
    return jnp.pad(x[tuple(idx)], pads, mode="edge")


def _conv_axis(x: jnp.ndarray, coeffs, axis: int) -> jnp.ndarray:
    coeffs = np.asarray(coeffs, np.float32)
    order = (len(coeffs) - 1) // 2
    out = None
    for k, c in enumerate(coeffs):
        if c == 0.0:
            continue
        term = c * _shift_clamped(x, k - order, axis)
        out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(x)
    return out


def conv_horiz(x: jnp.ndarray, coeffs) -> jnp.ndarray:
    """Horizontal (x/width axis) correlation with edge-clamped boundaries."""
    return _conv_axis(x, coeffs, axis=-1)


def conv_vert(x: jnp.ndarray, coeffs) -> jnp.ndarray:
    """Vertical (y/height axis) correlation with edge-clamped boundaries."""
    return _conv_axis(x, coeffs, axis=-2)


def conv_sep(x: jnp.ndarray, horiz_coeffs=None, vert_coeffs=None) -> jnp.ndarray:
    """Horizontal then vertical separable convolution
    (color_image_convolve_hv, image.c:658-688)."""
    if horiz_coeffs is not None:
        x = conv_horiz(x, horiz_coeffs)
    if vert_coeffs is not None:
        x = conv_vert(x, vert_coeffs)
    return x


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Full normalized Gaussian taps matching `gaussian_filter`
    (image.c:310-348): order = floor(3*sigma) + 1 (minimum 1)."""
    if sigma <= 0:
        raise ValueError("sigma must be > 0")
    order = int(math.floor(3 * sigma)) + 1
    order = max(order, 1)
    i = np.arange(-order, order + 1, dtype=np.float64)
    k = np.exp(-i * i / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with replicate borders (matches the reference's
    GaussianBlur(..., BORDER_REPLICATE) usage up to OpenCV's kernel-size rule)."""
    k = gaussian_kernel(sigma)
    return conv_sep(x, k, k)
