"""Coupled 2x2-block SOR solver for the linearized flow system.

The reference (`sor_coupled`, epic_flow_extended/solver.c:17-399) runs
sequential Gauss-Seidel SOR with over-relaxation omega on the system

  [a11 + S, a12    ] [du]   [b1 + sum_n w_n du_n]
  [a12,     a22 + S] [dv] = [b2 + sum_n w_n dv_n],   S = sum_n w_n

over the 4-neighborhood with horizontal weights wh (edge (i,j)-(i+1,j)) and
vertical weights wv (edge (i,j)-(i,j+1)).

Array version: **red-black** coupled SOR — two half-sweeps per iteration on the
checkerboard coloring. Same fixed point as the sequential sweep (the system is
unchanged; only the update order differs), so parity with the reference is
defined at convergence, not per-iteration (SURVEY.md §7 hard-part 1).

`sor_coupled_reference` is a NumPy port of the sequential
`sor_coupled_slow_but_readable` path used as a test oracle.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _shift(x, dy: int, dx: int):
    """Zero-fill shift: out[j, i] = x[j + dy, i + dx] (0 outside)."""
    pad_y = (max(-dy, 0), max(dy, 0))
    pad_x = (max(-dx, 0), max(dx, 0))
    padded = jnp.pad(x, (pad_y, pad_x))
    h, w = x.shape[-2], x.shape[-1]
    return padded[..., pad_y[1]:pad_y[1] + h, pad_x[1]:pad_x[1] + w]


@partial(jax.jit, static_argnames=("iterations",))
def sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv,
                   iterations: int = 30, omega: float = 1.9):
    """Red-black coupled SOR. All inputs are [H, W] float32.

    wh[j, i] weights edge (i,j)-(i+1,j); wv[j, i] weights edge (i,j)-(i,j+1).
    The last column of wh / last row of wv are ignored (boundary).
    Returns updated (du, dv).
    """
    h, w = du.shape
    wh = wh.at[:, -1].set(0.0)
    wv = wv.at[-1, :].set(0.0)

    w_n = _shift(wv, -1, 0)   # weight to north neighbor: wv[j-1, i]
    w_w = _shift(wh, 0, -1)   # weight to west neighbor:  wh[j, i-1]
    w_s = wv                  # weight to south neighbor
    w_e = wh                  # weight to east neighbor

    sum_w = w_n + w_w + w_s + w_e
    A11 = a11 + sum_w
    A22 = a22 + sum_w
    det = A11 * A22 - a12 * a12
    det = jnp.where(det == 0, 1.0, det)
    i11 = A22 / det
    i12 = -a12 / det
    i22 = A11 / det

    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    red = ((yy + xx) % 2 == 0)

    def half_sweep(du, dv, mask):
        su = (w_n * _shift(du, -1, 0) + w_w * _shift(du, 0, -1)
              + w_s * _shift(du, 1, 0) + w_e * _shift(du, 0, 1))
        sv = (w_n * _shift(dv, -1, 0) + w_w * _shift(dv, 0, -1)
              + w_s * _shift(dv, 1, 0) + w_e * _shift(dv, 0, 1))
        B1 = b1 + su
        B2 = b2 + sv
        nu = i11 * B1 + i12 * B2
        nv = i12 * B1 + i22 * B2
        du = jnp.where(mask, (1 - omega) * du + omega * nu, du)
        dv = jnp.where(mask, (1 - omega) * dv + omega * nv, dv)
        return du, dv

    def body(_, carry):
        du, dv = carry
        du, dv = half_sweep(du, dv, red)
        du, dv = half_sweep(du, dv, ~red)
        return du, dv

    du, dv = jax.lax.fori_loop(0, iterations, body, (du, dv))
    return du, dv


def sor_coupled_reference(du, dv, a11, a12, a22, b1, b2, wh, wv,
                          iterations: int = 30, omega: float = 1.9):
    """Sequential Gauss-Seidel oracle (solver.c:17-57). NumPy, slow."""
    du = np.array(du, np.float64)
    dv = np.array(dv, np.float64)
    a11 = np.asarray(a11); a12 = np.asarray(a12); a22 = np.asarray(a22)
    b1 = np.asarray(b1); b2 = np.asarray(b2)
    wh = np.asarray(wh); wv = np.asarray(wv)
    h, w = du.shape
    for _ in range(iterations):
        for j in range(h):
            for i in range(w):
                sigma_u = sigma_v = sum_d = 0.0
                if j > 0:
                    sigma_u -= wv[j - 1, i] * du[j - 1, i]
                    sigma_v -= wv[j - 1, i] * dv[j - 1, i]
                    sum_d += wv[j - 1, i]
                if i > 0:
                    sigma_u -= wh[j, i - 1] * du[j, i - 1]
                    sigma_v -= wh[j, i - 1] * dv[j, i - 1]
                    sum_d += wh[j, i - 1]
                if j < h - 1:
                    sigma_u -= wv[j, i] * du[j + 1, i]
                    sigma_v -= wv[j, i] * dv[j + 1, i]
                    sum_d += wv[j, i]
                if i < w - 1:
                    sigma_u -= wh[j, i] * du[j, i + 1]
                    sigma_v -= wh[j, i] * dv[j, i + 1]
                    sum_d += wh[j, i]
                A11 = a11[j, i] + sum_d
                A12 = a12[j, i]
                A22 = a22[j, i] + sum_d
                det = A11 * A22 - A12 * A12
                B1 = b1[j, i] - sigma_u
                B2 = b2[j, i] - sigma_v
                du[j, i] = (1 - omega) * du[j, i] + omega * (A22 * B1 - A12 * B2) / det
                dv[j, i] = (1 - omega) * dv[j, i] + omega * (-A12 * B1 + A11 * B2) / det
    return du, dv
