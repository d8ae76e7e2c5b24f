"""Batched trajectory hypotheses.

The reference's per-pixel `hypothesis` objects (utils/hypothesis.{h,cpp}) —
heap-allocated flow arrays with occlusion labels and energies — become fixed-
capacity padded tensors with validity masks (SURVEY.md §7 design stance):

  flows   [H, W, K, J, 2]   per-jet *accumulated* flow (u, v)
  occl    [H, W, K, J + 1]  occlusion label per frame (0 visible, 1 occluded)
  energy  [H, W, K]
  valid   [H, W, K]
  jet_est [H, W, K]         source jet-estimation id

All energies/distances are computed for the whole set in single vectorized
dispatches; K is a static capacity (invalid slots carry +inf energy).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.penalty import Penalty
from .accumulate import bilinear_sample

UNKNOWN = 1e10


@dataclass
class HypothesisSet:
    flows: np.ndarray    # [H, W, K, J, 2]
    occl: np.ndarray     # [H, W, K, J+1]
    energy: np.ndarray   # [H, W, K]
    valid: np.ndarray    # [H, W, K] bool
    jet_est: np.ndarray  # [H, W, K] int32

    @classmethod
    def empty(cls, h, w, k, j):
        return cls(
            flows=np.zeros((h, w, k, j, 2), np.float32),
            occl=np.zeros((h, w, k, j + 1), np.int32),
            energy=np.full((h, w, k), np.inf, np.float32),
            valid=np.zeros((h, w, k), bool),
            jet_est=np.zeros((h, w, k), np.int32),
        )

    @property
    def K(self):
        return self.flows.shape[2]

    @property
    def J(self):
        return self.flows.shape[3]

    def count(self):
        return int(self.valid.sum())


def adapt_fps(flows, new_j: int):
    """Resample accumulated per-jet flow to a different jet count
    (hypothesis.h:136-178). flows [..., J, 2] -> [..., new_j, 2].
    Works on numpy or jax arrays (indices are static)."""
    J = flows.shape[-2]
    if J == new_j:
        return flows
    skip = J / new_j
    if skip >= 1:
        idx = (np.arange(new_j) * skip + (skip - 1)).astype(int)
        return flows[..., idx, :]
    cols = []
    for i in range(new_j):
        off = int(np.floor(i * skip))
        offm1 = int(np.floor((i - 1) * skip))
        last = flows[..., offm1, :] if i > 0 \
            else np.zeros(flows.shape[:-2] + (2,), np.float32)
        cols.append(last + skip * (flows[..., off, :] - last))
    if isinstance(flows, np.ndarray):
        return np.stack(cols, axis=-2).astype(flows.dtype)
    return jnp.stack(cols, axis=-2)


def complete_hypothesis(flows: np.ndarray, start_f: int, end_f: int,
                        px, py, approach: int = 0):
    """Extrapolate a partial trajectory to the full jet range by linear
    (approach 0) or quadratic (approach 1) least-squares fits over the
    tracked prefix (hypothesis::new_complete, hypothesis.cpp:12-123; the
    reference's GSL fits become closed-form polyfits).

    flows [..., J, 2] accumulated flow valid on [start_f, end_f);
    px/py broadcastable positions. Returns extrapolated flows [..., J, 2]
    of the pure-polynomial trajectory (positions replaced like the
    reference, which refits even the observed frames).
    """
    J = flows.shape[-2]
    l = end_f - start_f + 1
    deg = 1 if approach == 0 else 2
    if l < deg + 1:
        return None
    # sample positions: t = start_f ... end_f (frame start_f = the anchor)
    t = np.arange(start_f, end_f + 1, dtype=np.float64)
    xs = np.concatenate([
        np.broadcast_to(np.asarray(px, np.float64)[..., None],
                        flows.shape[:-2] + (1,)),
        np.asarray(px, np.float64)[..., None]
        + flows[..., start_f:end_f, 0]], axis=-1)
    ys = np.concatenate([
        np.broadcast_to(np.asarray(py, np.float64)[..., None],
                        flows.shape[:-2] + (1,)),
        np.asarray(py, np.float64)[..., None]
        + flows[..., start_f:end_f, 1]], axis=-1)

    # Vandermonde least squares, batched over leading dims
    V = np.stack([t ** k for k in range(deg + 1)], axis=-1)       # [l, deg+1]
    pinv = np.linalg.pinv(V)                                      # [deg+1, l]
    cx = np.einsum("kl,...l->...k", pinv, xs)
    cy = np.einsum("kl,...l->...k", pinv, ys)

    f = np.arange(1, J + 1, dtype=np.float64)
    out = np.zeros(flows.shape[:-2] + (J, 2), np.float32)
    out[..., 0] = cx[..., 1:2] * f + (cx[..., 2:3] * f * f if deg == 2 else 0.0)
    out[..., 1] = cy[..., 1:2] * f + (cy[..., 2:3] * f * f if deg == 2 else 0.0)
    return out


def perturb_hypothesis(flows: np.ndarray, u_p: float, v_p: float):
    """Sign-aligned, linearly scaled perturbation of a trajectory
    (hypothesis::new_perturbed, hypothesis.cpp:126-149)."""
    J = flows.shape[-2]
    scale = (0.9 / J) * np.arange(J) + 0.1
    du = np.where(flows[..., 0] > 0, scale * u_p, -scale * u_p)
    dv = np.where(flows[..., 1] > 0, scale * v_p, -scale * v_p)
    return np.stack([flows[..., 0] + du, flows[..., 1] + dv], axis=-1)


# --------------------------------------------------------------------------
# occlusion estimation per hypothesis
# --------------------------------------------------------------------------
@partial(jax.jit, static_argnames=())
def set_occlusions(px, py, flows, forward, backward, occ_threshold,
                   fb_threshold):
    """Per-frame occlusion labels from jet-flow consistency + FB check
    (hypothesis::setOcclusions, hypothesis.cpp:172-221).

    px/py: [...]; flows: [..., J, 2] accumulated; forward/backward [J, H, W, 2].
    Returns occl [..., J+1] int32 (occluded stays occluded).
    """
    J = flows.shape[-2]
    h, w = forward.shape[1:3]
    shape = jnp.broadcast_shapes(px.shape, flows.shape[:-2])
    px = jnp.broadcast_to(px, shape)
    py = jnp.broadcast_to(py, shape)

    def step(occ_prev, t):
        prev_flow = jnp.where(t > 0, flows[..., jnp.maximum(t - 1, 0), :], 0.0)
        x_tm1 = px + prev_flow[..., 0]
        y_tm1 = py + prev_flow[..., 1]
        inside1 = (x_tm1 >= 0) & (x_tm1 < w) & (y_tm1 >= 0) & (y_tm1 < h)
        F = bilinear_sample(forward[t], jnp.clip(x_tm1, 0, w - 1),
                            jnp.clip(y_tm1, 0, h - 1))
        cur = flows[..., t, :]
        jet_err = jnp.linalg.norm(cur - prev_flow - F, axis=-1)

        x_t = px + cur[..., 0]
        y_t = py + cur[..., 1]
        inside2 = (x_t >= 0) & (x_t < w) & (y_t >= 0) & (y_t < h)
        B = bilinear_sample(backward[t], jnp.clip(x_t, 0, w - 1),
                            jnp.clip(y_t, 0, h - 1))
        fb_err = jnp.linalg.norm(B + F, axis=-1)

        visible = (inside1 & inside2 & (fb_err < fb_threshold)
                   & (jet_err < occ_threshold))
        occ_t = jnp.where(occ_prev == 1, 1, jnp.where(visible, 0, 1))
        return occ_t, occ_t

    occ0 = jnp.zeros(px.shape, jnp.int32)
    _, occ_seq = jax.lax.scan(step, occ0, jnp.arange(J))
    # occ_seq: [J, ...] -> [..., J]; prepend frame-0 visibility
    occ_seq = jnp.moveaxis(occ_seq, 0, -1)
    return jnp.concatenate([occ0[..., None], occ_seq], axis=-1)


# --------------------------------------------------------------------------
# energies (dense_tracking.cpp:176-365)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class EnergyParams:
    acc_jc: float = 1.0
    acc_bc: float = 0.1
    acc_gc: float = 1.0
    acc_occ: float = 500.0
    acc_cv: float = 0.0
    acc_temporal_occ: float = 10.0
    skip_pixel: int = 1


def add_jc(px, py, flows, occl, forward, pen: Penalty, p: EnergyParams):
    """Jet-consistency + constant-velocity energy (addJC,
    dense_tracking.cpp:176-233). flows [..., J, 2]; returns [...]."""
    J = flows.shape[-2]
    h, w = forward.shape[1:3]
    shape = jnp.broadcast_shapes(px.shape, flows.shape[:-2])
    px = jnp.broadcast_to(px, shape)
    py = jnp.broadcast_to(py, shape)

    def step(carry, t):
        jenergy, cv, contrib = carry
        u_j = flows[..., t, :]
        prev = jnp.where(t > 0, flows[..., jnp.maximum(t - 1, 0), :], 0.0)
        nxt = jnp.where(t + 1 < J, flows[..., jnp.minimum(t + 1, J - 1), :], 0.0)

        x = px + prev[..., 0]
        y = py + prev[..., 1]
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        F = bilinear_sample(forward[t], jnp.clip(x, 0, w - 1),
                            jnp.clip(y, 0, h - 1))
        res = ((u_j - prev - F) ** 2).sum(-1)
        vis = (occl[..., t] == 0) & (occl[..., t + 1] == 0)
        known = jnp.abs(u_j).max(-1) < UNKNOWN / 10
        use = inside & vis & known
        jenergy = jenergy + jnp.where(use, 0.5 * pen.apply(res), 0.0)
        contrib = contrib + jnp.where(use, 1.0, 0.0)

        # the reference's occluded-frame `continue` (dense_tracking.cpp:203)
        # also skips the constant-velocity term for inside-but-occluded jets
        cv_use = (~inside | vis) & known
        cv_term = jnp.linalg.norm(2 * u_j - prev - nxt, axis=-1)
        cv = cv + jnp.where(cv_use, cv_term, 0.0)
        return (jenergy, cv, contrib), None

    zero = jnp.zeros(px.shape, jnp.float32)
    (jenergy, cv, contrib), _ = jax.lax.scan(
        step, (zero, zero, zero), jnp.arange(J))
    jenergy = jnp.where(contrib > 0, jenergy / jnp.maximum(contrib, 1), jenergy)
    return p.acc_jc * jenergy + p.acc_cv * cv


# Scan add_bcgc over hypothesis groups once the pre-gathered patch tensor
# would exceed this many bytes: the vectorized body materializes
# [J+1, 9, G, ps, ps, bh, bw] patches (plus XLA remat copies), which at
# production shapes (270x480 grid, J=10, G=16) is ~7 GB per final pair —
# fine for one serial final, fatal for the F-batched stage-3 path on a
# 16 GB chip. The G axis is embarrassingly independent, so a lax.map over
# groups trades one dispatch's breadth for a G-fold smaller working set.
BCGC_SCAN_BYTES = 384 * 1024 * 1024


def add_bcgc(px, py, flows, occl, data, data_dx, data_dy, p: EnergyParams,
             occ_masks=None):
    """Pairwise all-frames brightness/gradient constancy (addBCGC,
    dense_tracking.cpp:240-349) — the hot energy term. Dispatches to the
    fully vectorized body, or to a group-at-a-time lax.map when the patch
    working set would be too large (see BCGC_SCAN_BYTES)."""
    from jax import lax

    Jp1 = data.shape[0]
    lead = jnp.broadcast_shapes(px.shape[:2], flows.shape[:2])
    bh, bw = lead
    G = flows.shape[2]
    r = int(0.5 * (p.skip_pixel + 1))
    ps = 2 * r + 2
    est = Jp1 * 9 * G * ps * ps * bh * bw * 4
    if G == 1 or est <= BCGC_SCAN_BYTES:
        return _add_bcgc_groups(px, py, flows, occl, data, data_dx, data_dy,
                                p, occ_masks)

    fG = jnp.moveaxis(jnp.broadcast_to(flows, (bh, bw) + flows.shape[2:]),
                      2, 0)                     # [G, bh, bw, J, 2]
    oG = jnp.moveaxis(jnp.broadcast_to(occl, (bh, bw) + occl.shape[2:]),
                      2, 0)                     # [G, bh, bw, J+1]

    def one(args):
        f1, o1 = args
        return _add_bcgc_groups(px, py, f1[:, :, None], o1[:, :, None],
                                data, data_dx, data_dy, p, occ_masks)[..., 0]

    e = lax.map(one, (fG, oG))                  # [G, bh, bw]
    return jnp.moveaxis(e, 0, -1)


def _add_bcgc_groups(px, py, flows, occl, data, data_dx, data_dy,
                     p: EnergyParams, occ_masks=None):
    """Vectorized addBCGC body (all hypothesis groups in one dispatch).

    For each pixel in a (2r+1)^2 window around p, sample image + gradients at
    the trajectory positions in all J+1 frames and sum |I_i - I_j| over all
    visible frame pairs, vectorized over hypotheses, window offsets and frame
    pairs in one dispatch (the replacement for the reference's quadruple
    loop).

    Layout: every large intermediate keeps the PIXEL dims (bh, bw) trailing.
    The natural channels/offsets-trailing formulation made XLA tile the
    [.., ps, ps, 9] patch tensor on its tiny tail dims, padding device
    memory traffic many times over. Window
    offsets are integers, so every offset shares the trajectory's fractional
    weights: one (2r+2)^2 patch is gathered per (frame, plane) from an
    edge-padded image (equivalent to clamp-at-border, utils.h:183-218) and
    the (2r+1)^2 bilinear values fall out as static views of the patch.
    The O(J^2) frame-pair reduction runs as a fori_loop over the pair list,
    accumulating into one [G, Wd, bh, bw] plane.

    data/data_dx/data_dy: [J+1, H, W, 3]; flows [bh, bw, G, J, 2] (leading
    dims broadcast against px/py [bh, bw, 1]). `occ_masks` ([J, H, W],
    nonzero = visible — the jet occlusion maps when `acc_occlusion` is on,
    dense_tracking.cpp:289) additionally gates the warped samples of frames
    1..J. Returns [bh, bw, G].
    """
    from jax import lax

    Jp1 = data.shape[0]
    h, w = data.shape[1:3]
    r = int(0.5 * (p.skip_pixel + 1))
    ps = 2 * r + 2
    lead = jnp.broadcast_shapes(px.shape[:2], flows.shape[:2])
    bh, bw = lead
    G = flows.shape[2]

    offs = [(oy, ox) for oy in range(-r, r + 1) for ox in range(-r, r + 1)]

    pxT = jnp.broadcast_to(px[..., 0], (bh, bw))
    pyT = jnp.broadcast_to(py[..., 0], (bh, bw))

    # displacements / occlusions, pixel-last: [J+1, G, bh, bw]
    fT = jnp.transpose(flows, (4, 3, 2, 0, 1))              # [2, J, G, bh, bw]
    zr = jnp.zeros((1, G, bh, bw), jnp.float32)
    dispx = jnp.concatenate([zr, fT[0]], 0)
    dispy = jnp.concatenate([zr, fT[1]], 0)
    occT = jnp.transpose(occl, (3, 2, 0, 1))

    cx = pxT[None, None] + dispx                            # [J+1, G, bh, bw]
    cy = pyT[None, None] + dispy
    x0b = jnp.floor(cx).astype(jnp.int32)
    y0b = jnp.floor(cy).astype(jnp.int32)
    fx = jnp.clip(cx - x0b, 0.0, 1.0)
    fy = jnp.clip(cy - y0b, 0.0, 1.0)

    # edge-padded image: pad >= max(2r, r+2) keeps the patch corner in range
    # for every window whose own position can be inside (the center may sit
    # up to r px outside while an offset position is still in the image)
    stacked = jnp.concatenate([data, data_dx, data_dy], -1)  # [J+1, H, W, 9]
    pad = max(2 * r, r + 2)
    spad = jnp.pad(stacked, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                   mode="edge")
    splanes = jnp.transpose(spad, (0, 3, 1, 2))             # [J+1, 9, Hp, Wp]
    hp, wp = h + 2 * pad, w + 2 * pad
    cyc = jnp.clip(y0b + (pad - r), 0, hp - ps)             # patch corner
    cxc = jnp.clip(x0b + (pad - r), 0, wp - ps)

    dg = jnp.arange(ps, dtype=jnp.int32)
    yg = jnp.broadcast_to(
        cyc[:, :, None, None] + dg[None, None, :, None, None, None],
        (Jp1, G, ps, ps, bh, bw))
    xg = jnp.broadcast_to(
        cxc[:, :, None, None] + dg[None, None, None, :, None, None],
        (Jp1, G, ps, ps, bh, bw))

    def patch_frame(t, P):
        return P.at[t].set(splanes[t][:, yg[t], xg[t]])

    P = jnp.zeros((Jp1, 9, G, ps, ps, bh, bw), jnp.float32)
    P = lax.fori_loop(0, Jp1, patch_frame, P)

    # bilinear views at each window offset (static patch indices); the gates
    # zero the +1 row/col exactly like bilinear_sample's clamp-at-border
    oyi = [o[0] + r for o in offs]
    oxi = [o[1] + r for o in offs]
    c00 = jnp.stack([P[:, :, :, a, b] for a, b in zip(oyi, oxi)], 3)
    c01 = jnp.stack([P[:, :, :, a, b + 1] for a, b in zip(oyi, oxi)], 3)
    c10 = jnp.stack([P[:, :, :, a + 1, b] for a, b in zip(oyi, oxi)], 3)
    c11 = jnp.stack([P[:, :, :, a + 1, b + 1]
                     for a, b in zip(oyi, oxi)], 3)   # [J+1, 9, G, Wd, bh, bw]

    oxf = jnp.asarray(np.array([o[1] for o in offs], np.float32))
    oyf = jnp.asarray(np.array([o[0] for o in offs], np.float32))
    oxi_j = jnp.asarray(np.array(oxi, np.int32) - r)
    oyi_j = jnp.asarray(np.array(oyi, np.int32) - r)
    gate_x = ((x0b[:, :, None] + oxi_j[None, None, :, None, None] + 1)
              <= w - 1)
    gate_y = ((y0b[:, :, None] + oyi_j[None, None, :, None, None] + 1)
              <= h - 1)
    gx = (fx[:, :, None] * gate_x)[:, None]           # [J+1, 1, G, Wd, bh, bw]
    gy = (fy[:, :, None] * gate_y)[:, None]
    vals = (c00 * (1 - gx) * (1 - gy) + c01 * gx * (1 - gy)
            + c10 * (1 - gx) * gy + c11 * gx * gy)

    # visible = offset position inside AND center inside AND not occluded
    bx = pxT[None, None, None] + oxf[:, None, None]          # [1,1,Wd,bh,bw]
    by = pyT[None, None, None] + oyf[:, None, None]
    center_inside = ((bx >= 0) & (bx < w) & (by >= 0) & (by < h))
    xo = cx[:, :, None] + oxf[:, None, None]                 # [J+1,G,Wd,bh,bw]
    yo = cy[:, :, None] + oyf[:, None, None]
    inside = ((xo >= 0) & (xo < w) & (yo >= 0) & (yo < h)) & center_inside
    vis = inside & (occT[:, :, None] == 0)
    if occ_masks is not None:
        def mask_frame(t, v):
            xc = jnp.clip(xo[t], 0, w - 1).astype(jnp.int32)
            yc = jnp.clip(yo[t], 0, h - 1).astype(jnp.int32)
            return v.at[t].set(v[t] & (occ_masks[t - 1][yc, xc] != 0))

        vis = lax.fori_loop(1, Jp1, mask_frame, vis)
    visf = vis.astype(jnp.float32)

    # frame-pair accumulation
    pi = np.array([i for i in range(Jp1) for j in range(i + 1, Jp1)], np.int32)
    pj = np.array([j for i in range(Jp1) for j in range(i + 1, Jp1)], np.int32)
    pi_j = jnp.asarray(pi)
    pj_j = jnp.asarray(pj)
    bc_c = jnp.float32(p.acc_bc * 0.3334)
    gc_c = jnp.float32(p.acc_gc * 0.3334)

    def pair_body(k, carry):
        e_acc, contrib = carry
        i = pi_j[k]
        j = pj_j[k]
        d = jnp.abs(lax.dynamic_index_in_dim(vals, i, 0, keepdims=False)
                    - lax.dynamic_index_in_dim(vals, j, 0, keepdims=False))
        wp_ = (lax.dynamic_index_in_dim(visf, i, 0, keepdims=False)
               * lax.dynamic_index_in_dim(visf, j, 0, keepdims=False))
        e_acc = e_acc + (bc_c * d[0:3].sum(0) + gc_c * d[3:9].sum(0)) * wp_
        return e_acc, contrib + wp_

    z = jnp.zeros(vals.shape[2:], jnp.float32)
    e_acc, contrib = lax.fori_loop(0, len(pi), pair_body, (z, z))
    e_p = e_acc / jnp.maximum(contrib, 1.0)                  # [G, Wd, bh, bw]
    neighs = center_inside[0, 0].astype(jnp.float32).sum(0)  # [bh, bw]
    e = e_p.sum(1) / jnp.maximum(neighs, 1.0)[None]
    return jnp.transpose(e, (1, 2, 0))


def add_oc(occl, p: EnergyParams):
    """Occlusion count + temporal-change penalty (addOC,
    dense_tracking.cpp:351-365). occl [..., J+1]."""
    occ = occl.astype(jnp.float32)
    count = occ.sum(-1)
    change = jnp.abs(occ[..., 1:] - occ[..., :-1]).sum(-1)
    return p.acc_occ * count + p.acc_temporal_occ * change


@partial(jax.jit, static_argnames=("pen", "p", "has_occ_masks"))
def _hypothesis_energy(px, py, flows, occl, forward, data, data_dx, data_dy,
                       occ_masks, pen: Penalty, p: EnergyParams,
                       has_occ_masks: bool):
    return (add_jc(px, py, flows, occl, forward, pen, p)
            + add_bcgc(px, py, flows, occl, data, data_dx, data_dy, p,
                       occ_masks if has_occ_masks else None)
            + add_oc(occl, p))


def hypothesis_energy(px, py, flows, occl, forward, data, data_dx, data_dy,
                      pen: Penalty, p: EnergyParams, occ_masks=None):
    """Full unary energy of a hypothesis (without the jet-estimation weight)."""
    import jax.numpy as jnp

    dummy = occ_masks if occ_masks is not None \
        else jnp.zeros((1,) + data.shape[1:3], jnp.uint8)
    return _hypothesis_energy(px, py, flows, occl, forward, data, data_dx,
                              data_dy, dummy, pen, p, occ_masks is not None)


# --------------------------------------------------------------------------
# trajectory distances (hypothesis.cpp:223-285)
# --------------------------------------------------------------------------
ADJ, ACC, FINAL = 0, 1, 2


def trajectory_distance(fa, fb, method: int):
    """Distance between accumulated-flow trajectories.

    fa/fb: [..., J, 2] broadcastable. ACC: mean over frames of ||diff||/l;
    ADJ: mean ||adjacent-flow diff||; FINAL: ||final-flow diff||.
    """
    J = fa.shape[-2]
    known = (jnp.abs(fa).max((-1, -2)) < UNKNOWN / 10) & \
            (jnp.abs(fb).max((-1, -2)) < UNKNOWN / 10)
    if method == FINAL:
        d = jnp.linalg.norm(fa[..., -1, :] - fb[..., -1, :], axis=-1)
    elif method == ACC:
        l = jnp.arange(1, J + 1, dtype=jnp.float32)
        d = (jnp.linalg.norm(fa - fb, axis=-1) / l).sum(-1)
    else:  # ADJ
        da = jnp.diff(jnp.concatenate(
            [jnp.zeros_like(fa[..., :1, :]), fa], axis=-2), axis=-2)
        db = jnp.diff(jnp.concatenate(
            [jnp.zeros_like(fb[..., :1, :]), fb], axis=-2), axis=-2)
        d = jnp.linalg.norm(da - db, axis=-1).mean(-1)
    return jnp.where(known, d, 1e6)
