"""Multi-frame, occlusion-aware variational flow — the Slow Flow core.

Array re-design of `Variational_MT` (variational_mt.cpp) +
`Variational_AUX_MT` (variational_aux_mt.cpp): instead of per-frame pointer
loops, the window of S frames around the reference becomes stacked tensors
[2*ref, 3, H, W] of warped-image derivatives (successive s->s+1 and
to-reference), and the IRLS data-term assembly is one fused vectorized
expression over the frame axis. The discrete occlusion step (binary Potts MRF,
GCO alpha-expansion in the reference, variational_aux_mt.cpp:758-887) is
re-expressed as red-black ICM sweeps on the checkerboard grid — same energy,
parallel-friendly updates.

Structure of the continuous optimization (variational_mt.cpp:264-439):
  for alter_it:           (alternation: discrete occlusions <-> continuous flow)
    get_derivatives       (warp all 2*ref frames, 17 conv planes each)
    optimizeOcc           (alter > 0, occlusion_reasoning)
    for outer_it:         (re-warp + re-linearize)
      gate masks by occlusion state
      for inner_it:       (IRLS: smoothness + data normal equations + SOR)
        sor_coupled
      break on avg |du| change < thres  (masked no-op under jit)
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..core.conv import DERIV_5PT, DERIV_3PT, conv_horiz, conv_vert
from ..core.image import pyramid_sizes, build_pyramid, resize_bilinear
from ..core.penalty import make_penalty
from ..core.solver import sor_coupled_rb
from ..core.warp import warp_bilinear

DATANORM = 0.1 * 0.1          # variational_aux_mt.h:25
DT_SCALE_GRAPHC = 0.01        # variational_aux_mt.h:26


@dataclass(frozen=True)
class MultiFrameParams:
    """slow_flow_* parameters (defaults: slow_flow.cpp:64-128, cfgs/slow_flow.cfg)."""

    S: int = 2                       # frames in (half-)window; ref = S - 1
    alpha: float = 4.0
    gamma: float = 6.0
    delta: float = 1.0
    rho: tuple = (1.0,)              # successive data-term weights, len ref
    omega: tuple = (1.0,)            # reference data-term weights, len ref
    dataterm_norm: bool = True       # slow_flow_dataterm
    smoothing: int = 1               # slow_flow_smoothing 0/1/2
    layers: int = 1
    p_scale: float = 0.9
    sigma: float = 0.0               # presmoothing of layer 0
    niter_alter: int = 10
    niter_graphc: int = 10
    niter_outer: int = 10
    thres_outer: float = 1e-5
    niter_inner: int = 1
    thres_inner: float = 1e-5
    niter_solver: int = 30
    sor_omega: float = 1.9
    occlusion_reasoning: bool = True
    occlusion_penalty: float = 0.1
    occlusion_alpha: float = 0.1
    robust_color: tuple = (1, 0.001, 0.5)   # (fct, eps, truncation)
    robust_grad: tuple | None = None        # defaults to robust_color
    robust_reg: tuple = (1, 0.001, 0.5)
    one_direction: bool = False             # slow_flow_method == "forward"
    hbit: bool = False                      # 16-bit input
    unroll_jets: bool = True                # unroll small jet batches (single
                                            # device); MUST be False when the
                                            # batch axis is sharded over a
                                            # device mesh (per-jet indexing
                                            # would gather across devices)

    @property
    def ref(self) -> int:
        return self.S - 1

    def penalties(self):
        color = make_penalty(*self.robust_color)
        grad = make_penalty(*(self.robust_grad or self.robust_color))
        reg = make_penalty(*self.robust_reg)
        return color, grad, reg

    @classmethod
    def from_parameter_list(cls, params) -> "MultiFrameParams":
        """Build from a ParameterList holding slow_flow_* keys."""
        S = params.parameter("slow_flow_S", type=int)
        ref = S - 1
        rho = tuple(params.parameter(f"slow_flow_rho_{a}", "1.0", float)
                    for a in range(ref))
        omega = tuple(params.parameter(f"slow_flow_omega_{a}", "1.0", float)
                      for a in range(ref))
        rg = None
        if params.exists("slow_flow_robust_grad"):
            rg = (params.parameter("slow_flow_robust_grad", type=int),
                  params.parameter("slow_flow_robust_grad_eps", "0.001", float),
                  params.parameter("slow_flow_robust_grad_truncation", "0.5", float))
        return cls(
            S=S,
            alpha=params.parameter("slow_flow_alpha", type=float),
            gamma=params.parameter("slow_flow_gamma", type=float),
            delta=params.parameter("slow_flow_delta", type=float),
            rho=rho, omega=omega,
            dataterm_norm=params.parameter("slow_flow_dataterm", "1", bool),
            smoothing=params.parameter("slow_flow_smoothing", "0", int),
            layers=params.parameter("slow_flow_layers", type=int),
            p_scale=params.parameter("slow_flow_p_scale", type=float),
            sigma=params.parameter("slow_flow_sigma", "0", float)
            if params.parameter("sigma", "0", float) > 0 else 0.0,
            niter_alter=params.parameter("slow_flow_niter_alter", "1", int),
            niter_graphc=params.parameter("slow_flow_niter_graphc", "10", int),
            niter_outer=params.parameter("slow_flow_niter_outer", type=int),
            thres_outer=params.parameter("slow_flow_thres_outer", type=float),
            niter_inner=params.parameter("slow_flow_niter_inner", type=int),
            thres_inner=params.parameter("slow_flow_thres_inner", type=float),
            niter_solver=params.parameter("slow_flow_niter_solver", type=int),
            sor_omega=params.parameter("slow_flow_sor_omega", type=float),
            occlusion_reasoning=params.parameter(
                "slow_flow_occlusion_reasoning", "0", bool),
            occlusion_penalty=params.parameter(
                "slow_flow_occlusion_penalty", "1.0", float),
            occlusion_alpha=params.parameter(
                "slow_flow_occlusion_alpha", "0.5", float),
            robust_color=(params.parameter("slow_flow_robust_color", type=int),
                          params.parameter("slow_flow_robust_color_eps", type=float),
                          params.parameter("slow_flow_robust_color_truncation",
                                           "0.5", float)),
            robust_grad=rg,
            robust_reg=(params.parameter("slow_flow_robust_reg", type=int),
                        params.parameter("slow_flow_robust_reg_eps", type=float),
                        params.parameter("slow_flow_robust_reg_truncation",
                                         "0.5", float)),
            one_direction=(params.exists("slow_flow_method")
                           and params.parameter("slow_flow_method") == "forward"),
            hbit=params.parameter("16bit", "0", bool),
            unroll_jets=params.parameter("slow_flow_unroll_jets",
                                         "1" if cls.unroll_jets else "0",
                                         bool),
        )


# --------------------------------------------------------------------------
# derivative stacks
# --------------------------------------------------------------------------
def warp_window_frames(seq, wx, wy, ref: int):
    """Warp every window frame once by factor (k - ref). The reference warps
    frames s and s+1 independently per offset (variational_mt.cpp:97-110),
    but w_b[s] == w_a[s+1] — sharing halves the warp count. Frame ref has
    factor 0: the identity with an all-ones mask, free.

    Returns (warped [2*ref+1, 3, H, W], masks [2*ref+1, H, W])."""
    def one(k):
        if k == ref:
            return seq[k], jnp.ones(wx.shape, seq.dtype)
        return warp_bilinear(seq[k], wx, wy, factor=float(k - ref))
    pairs = [one(k) for k in range(2 * ref + 1)]
    return (jnp.stack([o for o, _ in pairs]),
            jnp.stack([m for _, m in pairs]))


def get_derivatives_mt(seq, wx, wy, ref: int):
    """Warp all 2*ref window frames and build derivative stacks
    (variational_mt.cpp:87-166).

    seq: [2*ref+1, 3, H, W]. Returns dict with successive fields
    (ix..iyz) and to-reference fields (ix_ref..iyz_ref), each
    [2*ref, 3, H, W], plus mask [2*ref, H, W].
    """
    n = 2 * ref
    warped, masks = warp_window_frames(seq, wx, wy, ref)
    w_a, m_a = warped[:n], masks[:n]                      # frame s
    w_b, m_b = warped[1:], masks[1:]                      # frame s+1

    s_idx = jnp.arange(n)
    past = (s_idx < ref)[:, None, None]
    mask = jnp.where(past, m_a, m_b)

    def derivs(tmp, iz):
        ix = conv_horiz(tmp, DERIV_5PT)
        iy = conv_vert(tmp, DERIV_5PT)
        return dict(
            ix=ix, iy=iy, iz=iz,
            ixx=conv_horiz(ix, DERIV_5PT),
            ixy=conv_vert(ix, DERIV_5PT),
            iyy=conv_vert(iy, DERIV_5PT),
            ixz=conv_horiz(iz, DERIV_5PT),
            iyz=conv_vert(iz, DERIV_5PT),
        )

    succ = derivs(0.5 * (w_a + w_b), w_a - w_b)

    ref_img = seq[ref][None]
    past4 = past[:, None]
    a_ref = jnp.where(past4, w_a, ref_img)
    b_ref = jnp.where(past4, ref_img, w_b)
    to_ref = derivs(0.5 * (a_ref + b_ref), a_ref - b_ref)

    return succ, to_ref, mask


# --------------------------------------------------------------------------
# smoothness
# --------------------------------------------------------------------------
def compute_smoothness_mt(uu, vv, dpsis_weight, alpha, reg_penalty, method: int):
    """Edge-aware robust smoothness weights (variational_aux_mt.cpp:18-127).

    method 0: phi(u_dx) + phi(u_dy) per direction, no symmetric cross terms
    method 1: adds the averaged orthogonal derivative (the EpicFlow scheme)
    method 2: one combined weight shared by both directions
    """
    ux1 = jnp.pad(uu[:, 1:] - uu[:, :-1], ((0, 0), (0, 1)))
    vx1 = jnp.pad(vv[:, 1:] - vv[:, :-1], ((0, 0), (0, 1)))
    uy1 = jnp.pad(uu[1:] - uu[:-1], ((0, 1), (0, 0)))
    vy1 = jnp.pad(vv[1:] - vv[:-1], ((0, 1), (0, 0)))

    def east(x):
        return jnp.pad(x[:, 1:], ((0, 0), (0, 1)), mode="edge")

    def south(x):
        return jnp.pad(x[1:], ((0, 1), (0, 0)), mode="edge")

    if method <= 1:
        if method == 1:
            ux2 = conv_horiz(uu, DERIV_3PT)
            vx2 = conv_horiz(vv, DERIV_3PT)
            uy2 = conv_vert(uu, DERIV_3PT)
            vy2 = conv_vert(vv, DERIV_3PT)
            th_u = 0.5 * (uy2 + east(uy2))
            th_v = 0.5 * (vy2 + east(vy2))
            tv_u = 0.5 * (ux2 + south(ux2))
            tv_v = 0.5 * (vx2 + south(vx2))
        else:
            th_u = th_v = tv_u = tv_v = 0.0
        hsq = ux1 * ux1 + th_u * th_u + vx1 * vx1 + th_v * th_v
        vsq = uy1 * uy1 + tv_u * tv_u + vy1 * vy1 + tv_v * tv_v
        wh = (dpsis_weight + east(dpsis_weight)) * alpha * reg_penalty.derivative(hsq)
        wv = (dpsis_weight + south(dpsis_weight)) * alpha * reg_penalty.derivative(vsq)
    else:
        h, w = uu.shape
        xx = jnp.arange(w)[None, :]
        yy = jnp.arange(h)[:, None]
        has_e = xx < w - 1
        has_s = yy < h - 1
        sq = jnp.where(has_e, ux1 * ux1 + vx1 * vx1, 0.0) \
            + jnp.where(has_s, uy1 * uy1 + vy1 * vy1, 0.0)
        wsum = dpsis_weight + jnp.where(has_e, east(dpsis_weight), 0.0) \
            + jnp.where(has_s, south(dpsis_weight), 0.0)
        wh = wv = wsum * alpha * reg_penalty.derivative(sq)

    wh = wh.at[:, -1].set(0.0)
    wv = wv.at[-1, :].set(0.0)
    return wh, wv


def compute_dpsis_weight_mt(im, norm_avg, norm_std, coef=5.0, hbit=False):
    """0.5*exp(-coef*|grad lum|) on de-normalized intensities
    (variational_aux_mt.cpp:673-719)."""
    scale = 65535.0 if hbit else 255.0
    lum = (0.299 * (im[0] * norm_std[0] + norm_avg[0])
           + 0.587 * (im[1] * norm_std[1] + norm_avg[1])
           + 0.114 * (im[2] * norm_std[2] + norm_avg[2])) / scale
    lx = conv_horiz(lum, DERIV_5PT)
    ly = conv_vert(lum, DERIV_5PT)
    return 0.5 * jnp.exp(-coef * jnp.sqrt(lx * lx + ly * ly))


def sub_laplacian(dst, src, wh, wv):
    """dst += div(w grad src) (variational_aux_mt.cpp:130-161)."""
    th = wh * (jnp.pad(src[:, 1:], ((0, 0), (0, 1)), mode="edge") - src)
    th = th.at[:, -1].set(0.0)
    dst = dst + th - jnp.pad(th[:, :-1], ((0, 0), (1, 0)))
    tv = wv * (jnp.pad(src[1:], ((0, 1), (0, 0)), mode="edge") - src)
    tv = tv.at[-1, :].set(0.0)
    dst = dst + tv - jnp.pad(tv[:-1], ((1, 0), (0, 0)))
    return dst


# --------------------------------------------------------------------------
# data terms (vectorized over the 2*ref frame axis)
# --------------------------------------------------------------------------
def _succ_weights(p: MultiFrameParams):
    """Per-frame successive/reference weights for s in 0..2*ref-1
    (variational_mt.cpp:343-361): past uses rho[ref-1-s], future rho[s-ref]."""
    ref = p.ref
    rho = [p.rho[ref - 1 - s] if s < ref else p.rho[s - ref] for s in range(2 * ref)]
    om = [p.omega[ref - 1 - s] if s < ref else p.omega[s - ref] for s in range(2 * ref)]
    if p.one_direction:
        rho = [0.0] * ref + rho[ref:]
        om = [0.0] * ref + om[ref:]
    return jnp.asarray(rho, jnp.float32), jnp.asarray(om, jnp.float32)


def _ref_factors(p: MultiFrameParams):
    """Signed time factor of the to-reference linearization
    (variational_aux_mt.cpp:416-425): s-ref for past, -(s-ref+1) for future."""
    ref = p.ref
    f = [float(s - ref) if s < ref else -float(s - ref + 1) for s in range(2 * ref)]
    return jnp.asarray(f, jnp.float32)


def add_data_terms(du, dv, mask, succ, to_ref, channel_w, p: MultiFrameParams):
    """Assemble the IRLS normal equations: successive + reference data terms
    for all 2*ref frames in one vectorized pass
    (variational_aux_mt.cpp:166-403 and 408-634, normalized branch by default).

    All stacked fields are [N=2*ref, 3, H, W]; mask is [N, H, W];
    channel_w is [3, H, W]. Returns (a11, a12, a22, b1, b2) each [H, W].
    """
    color_pen, grad_pen, _ = p.penalties()
    rho_w, omega_w = _succ_weights(p)                 # [N]
    N = 2 * p.ref
    cw = channel_w[None]                              # [1, 3, H, W]
    m4 = mask[:, None]                                # [N, 1, H, W]

    a11 = a12 = a22 = b1 = b2 = 0.0

    # ---------------- successive term: effective jacobian is -Ix, -Iy -------
    # (factor*I - (factor+1)*I = -I for every frame offset, so the residual is
    #  Iz - Ix du - Iy dv regardless of s.)
    ix, iy, iz = succ["ix"], succ["iy"], succ["iz"]
    ixx, ixy, iyy = succ["ixx"], succ["ixy"], succ["iyy"]
    ixz, iyz = succ["ixz"], succ["iyz"]
    rho4 = rho_w[:, None, None]                       # [N, 1, 1] -> weights HxW

    if p.delta != 0.0:
        t = cw * (iz - ix * du - iy * dv)             # [N, 3, H, W]
        if p.dataterm_norm:
            n = ix * ix + iy * iy + DATANORM
            arg = (t * t / n).sum(1)                  # [N, H, W]
            w = mask * (rho_w[:, None, None] * (p.delta / 3.0)) \
                * color_pen.derivative(arg)
            coef = w[:, None] * cw / n                # [N, 3, H, W]
        else:
            arg = (t * t).sum(1)
            w = mask * (rho_w[:, None, None] * (p.delta / 3.0)) \
                * color_pen.derivative(arg)
            coef = w[:, None] * cw
        a11 = a11 + (coef * ix * ix).sum((0, 1))
        a12 = a12 + (coef * ix * iy).sum((0, 1))
        a22 = a22 + (coef * iy * iy).sum((0, 1))
        b1 = b1 + (coef * iz * ix).sum((0, 1))
        b2 = b2 + (coef * iz * iy).sum((0, 1))

    if p.gamma != 0.0:
        t1 = cw * (ixz - ixx * du - ixy * dv)
        t2 = cw * (iyz - ixy * du - iyy * dv)
        if p.dataterm_norm:
            n1 = ixx * ixx + ixy * ixy + DATANORM
            n2 = iyy * iyy + ixy * ixy + DATANORM
            arg = (t1 * t1 / n1 + t2 * t2 / n2).sum(1)
            w = mask * (rho_w[:, None, None] * (p.gamma / 3.0)) \
                * grad_pen.derivative(arg)
            c1 = w[:, None] * cw / n1
            c2 = w[:, None] * cw / n2
        else:
            arg = (t1 * t1 + t2 * t2).sum(1)
            w = mask * (rho_w[:, None, None] * (p.gamma / 3.0)) \
                * grad_pen.derivative(arg)
            c1 = c2 = w[:, None] * cw
        a11 = a11 + (c1 * ixx * ixx + c2 * ixy * ixy).sum((0, 1))
        a12 = a12 + (c1 * ixx * ixy + c2 * ixy * iyy).sum((0, 1))
        a22 = a22 + (c2 * iyy * iyy + c1 * ixy * ixy).sum((0, 1))
        b1 = b1 + (c1 * ixx * ixz + c2 * ixy * iyz).sum((0, 1))
        b2 = b2 + (c2 * iyy * iyz + c1 * ixy * ixz).sum((0, 1))

    # ---------------- reference term: jacobian scaled by signed factor ------
    fac = _ref_factors(p)[:, None, None, None]        # [N, 1, 1, 1]
    facsq = fac * fac
    ix, iy, iz = to_ref["ix"], to_ref["iy"], to_ref["iz"]
    ixx, ixy, iyy = to_ref["ixx"], to_ref["ixy"], to_ref["iyy"]
    ixz, iyz = to_ref["ixz"], to_ref["iyz"]

    if p.delta != 0.0:
        t = cw * (iz + ix * fac * du + iy * fac * dv)
        if p.dataterm_norm:
            n = facsq * (ix * ix + iy * iy) + DATANORM
        else:
            n = facsq + jnp.zeros_like(ix)
        arg = (t * t / n).sum(1)
        w = mask * (omega_w[:, None, None] * (p.delta / 3.0)) \
            * color_pen.derivative(arg)
        coef = w[:, None] * cw / n
        b1 = b1 - (coef * fac * iz * ix).sum((0, 1))
        b2 = b2 - (coef * fac * iz * iy).sum((0, 1))
        a11 = a11 + (coef * facsq * ix * ix).sum((0, 1))
        a12 = a12 + (coef * facsq * ix * iy).sum((0, 1))
        a22 = a22 + (coef * facsq * iy * iy).sum((0, 1))

    if p.gamma != 0.0:
        t1 = cw * (ixz + ixx * fac * du + ixy * fac * dv)
        t2 = cw * (iyz + ixy * fac * du + iyy * fac * dv)
        if p.dataterm_norm:
            n1 = facsq * (ixx * ixx + ixy * ixy) + DATANORM
            n2 = facsq * (iyy * iyy + ixy * ixy) + DATANORM
        else:
            n1 = n2 = facsq + jnp.zeros_like(ixx)
        arg = (t1 * t1 / n1 + t2 * t2 / n2).sum(1)
        w = mask * (omega_w[:, None, None] * (p.gamma / 3.0)) \
            * grad_pen.derivative(arg)
        c1 = w[:, None] * cw / n1
        c2 = w[:, None] * cw / n2
        b1 = b1 - (c1 * fac * ixx * ixz + c2 * fac * ixy * iyz).sum((0, 1))
        b2 = b2 - (c2 * fac * iyy * iyz + c1 * fac * ixy * ixz).sum((0, 1))
        a11 = a11 + (c1 * facsq * ixx * ixx + c2 * facsq * ixy * ixy).sum((0, 1))
        a12 = a12 + (c1 * facsq * ixx * ixy + c2 * facsq * ixy * iyy).sum((0, 1))
        a22 = a22 + (c2 * facsq * iyy * iyy + c1 * facsq * ixy * ixy).sum((0, 1))

    return a11, a12, a22, b1, b2


# --------------------------------------------------------------------------
# occlusion MRF (binary Potts, red-black ICM)
# --------------------------------------------------------------------------
def occlusion_data_costs(mask, succ, to_ref, p: MultiFrameParams):
    """Per-pixel data costs for labels {0: occluded-in-past, 1: occluded-in-
    future} (variational_aux_mt.cpp:784-858). Returns (e0, e1) [H, W]."""
    color_pen, grad_pen, _ = p.penalties()
    ref = p.ref
    rho_idx = jnp.asarray(
        [max(ref - s - 1, s - ref) for s in range(2 * ref)], jnp.int32)
    rho = jnp.asarray(p.rho, jnp.float32)[rho_idx][:, None, None]
    om = jnp.asarray(p.omega, jnp.float32)[rho_idx][:, None, None]
    hd = p.delta / 3.0
    hg = p.gamma / 3.0

    iz2 = (succ["iz"] ** 2).sum(1)
    gz2 = (succ["ixz"] ** 2 + succ["iyz"] ** 2).sum(1)
    iz2r = (to_ref["iz"] ** 2).sum(1)
    gz2r = (to_ref["ixz"] ** 2 + to_ref["iyz"] ** 2).sum(1)

    term = (rho * hd * mask * color_pen.apply(iz2)
            + rho * hg * mask * grad_pen.apply(gz2)
            + om * hd * mask * color_pen.apply(iz2r)
            + om * hg * mask * grad_pen.apply(gz2r))
    norm_contrib = mask * (2.0 * rho + 2.0 * om)

    s = jnp.arange(2 * ref)[:, None, None]
    future = (s >= ref)
    # label 0 (occluded in the past) is scored with the future terms
    e0 = jnp.where(future, term, 0.0).sum(0)
    n0 = jnp.where(future, norm_contrib, 0.0).sum(0)
    e1 = jnp.where(~future, term, 0.0).sum(0)
    n1 = jnp.where(~future, norm_contrib, 0.0).sum(0)
    n0 = jnp.where(n0 == 0, 1.0, n0)
    n1 = jnp.where(n1 == 0, 1.0, n1)
    e0 = DT_SCALE_GRAPHC * e0 / n0
    e1 = DT_SCALE_GRAPHC * e1 / n1 + p.occlusion_penalty
    return e0, e1


def solve_binary_potts(e0, e1, alpha, iterations: int, init=None):
    """Binary Potts MRF on the 4-connected grid via red-black ICM sweeps.

    The reference solves this exactly with GCO alpha-expansion (one s-t
    mincut for 2 labels); red-black ICM converges to a strong local optimum
    of the same energy with data costs (e0, e1) and pairwise cost
    alpha * [l_p != l_q], and every half-sweep is one parallel array update.

    ICM runs from three starts — the data-cost argmin and the two constant
    labelings — and returns the lowest-energy fixed point: with strong
    coupling a single synchronous-sweep start can land above even a constant
    labeling (measured). The three starts run STACKED on a leading axis
    through one while_loop (identical results to three serial loops: a
    stable start is a fixed point of further sweeps, so running the batch
    until every start settles is a no-op for the ones already settled), so
    the occlusion step pays one loop instead of three.
    Returns labels in {0, 1} as float32.
    """
    h, w = e0.shape
    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    red = ((yy + xx) % 2 == 0)

    # number of neighbors (border pixels have fewer) — static, hoisted out
    # of the sweep loop
    ones = jnp.pad(jnp.ones((h, w), e0.dtype), 1)
    deg = (ones[:-2, 1:-1] + ones[2:, 1:-1]
           + ones[1:-1, :-2] + ones[1:-1, 2:])

    def cnt_ones(l):
        """Sum of 4-neighbor labels, edge-replicated, on [..., H, W]."""
        pad = [(0, 0)] * (l.ndim - 2) + [(1, 1), (1, 1)]
        padded = jnp.pad(l, pad, mode="edge")
        return (padded[..., :-2, 1:-1] + padded[..., 2:, 1:-1]
                + padded[..., 1:-1, :-2] + padded[..., 1:-1, 2:])

    def half(lab, mask):
        cnt1 = cnt_ones(lab)
        c0 = e0 + alpha * cnt1                 # neighbors with label 1 disagree
        c1 = e1 + alpha * (deg - cnt1)
        new = jnp.where(c1 < c0, 1.0, 0.0)
        return jnp.where(mask, new, lab)

    def body(carry):
        lab, it, _ = carry
        new = half(lab, red)
        new = half(new, ~red)
        # a stable red+black sweep is a fixed point of ICM: further sweeps
        # are no-ops, so exiting early is exactly result-preserving
        return new, it + 1, jnp.any(new != lab)

    def cond(carry):
        _, it, changed = carry
        return (it < iterations) & changed

    def run_icm(lab0):
        out, _, _ = jax.lax.while_loop(cond, body, (lab0, jnp.int32(0),
                                                    jnp.bool_(True)))
        return out

    if init is not None:
        return run_icm(init)

    lab = jnp.where(e1 < e0, 1.0, 0.0)
    starts = jnp.stack([lab, jnp.zeros_like(lab), jnp.ones_like(lab)])
    cands = run_icm(starts)

    both = jnp.where(cands > 0.5, e1[None], e0[None]).sum((-2, -1))
    pw = (jnp.abs(cands[..., :, 1:] - cands[..., :, :-1]).sum((-2, -1))
          + jnp.abs(cands[..., 1:, :] - cands[..., :-1, :]).sum((-2, -1)))
    energies = both + alpha * pw
    return cands[jnp.argmin(energies)]


# --------------------------------------------------------------------------
# one pyramid level
# --------------------------------------------------------------------------
def compute_one_level(wx, wy, seq, channel_w, norm_avg, norm_std,
                      p: MultiFrameParams):
    """Alternating discrete/continuous minimization at one level
    (variational_mt.cpp:169-493). Returns (wx, wy, occlusions)."""
    ref = p.ref
    data_norm = float(sum(p.rho[s] + p.omega[s] for s in range(ref)))
    _, _, reg_pen = p.penalties()

    occ0 = jnp.full(wx.shape, -1.0) if (p.one_direction or p.occlusion_reasoning) \
        else jnp.zeros_like(wx)

    dpsis_weight = compute_dpsis_weight_mt(seq[ref], norm_avg, norm_std,
                                           5.0, p.hbit)
    hw = wx.shape[0] * wx.shape[1]

    def gate_masks(mask, occ):
        """Occlusion/direction gating of data-term masks
        (variational_mt.cpp:292-320)."""
        factor = (1.0 + (occ == 0.0)) * data_norm
        backward = (occ >= 0.0) / factor
        forward = (occ <= 0.0) / factor
        s = jnp.arange(2 * ref)[:, None, None]
        gate = jnp.where(s < ref, backward[None], forward[None])
        if p.one_direction:
            gate = jnp.where(s < ref, 0.0, gate)
        return mask * gate

    def derive_state(wxc, wyc):
        return get_derivatives_mt(seq, wxc, wyc, ref)

    def solve_system(uu, vv, du, dv, a11, a12, a22, b1, b2):
        """Smoothness + laplacian + red-black SOR on an assembled system."""
        wh, wv = compute_smoothness_mt(uu, vv, dpsis_weight, p.alpha,
                                       reg_pen, p.smoothing)
        b1 = sub_laplacian(b1, uu, wh, wv)
        b2 = sub_laplacian(b2, vv, wh, wv)
        return sor_coupled_rb(du, dv, a11, a12, a22, b1, b2, wh, wv,
                              iterations=p.niter_solver, omega=p.sor_omega)

    def inner_loop(wx0, wy0, uu, vv, gated, state):
        """Returns (uu, vv, change). With niter_inner == 1 the returned
        change is the du-space increment magnitude max(sum|du|, sum|dv|)/hw,
        which equals the outer's flow-space |new - old| exactly in reals
        (du starts at 0) — the outer loop reuses it instead of re-reducing
        |uu - wx| over the planes."""
        succ, to_ref, _ = state
        du0 = jnp.zeros_like(wx0)
        dv0 = jnp.zeros_like(wy0)

        def cond(c):
            du, dv, uu, vv, it, change = c
            return (it < p.niter_inner) & (change >= p.thres_inner)

        def body(c):
            du, dv, uu, vv, it, _ = c
            a11, a12, a22, b1, b2 = add_data_terms(du, dv, gated, succ,
                                                   to_ref, channel_w, p)
            ndu, ndv = solve_system(uu, vv, du, dv, a11, a12, a22, b1, b2)
            change = jnp.maximum(jnp.abs(ndu - du).sum(),
                                 jnp.abs(ndv - dv).sum()) / hw
            return (ndu, ndv, wx0 + ndu, wy0 + ndv, it + jnp.int32(1),
                    jnp.float32(change))

        du, dv, uu, vv, _, change = jax.lax.while_loop(
            cond, body, (du0, dv0, uu, vv, jnp.int32(0),
                         jnp.float32(jnp.inf)))
        return uu, vv, change

    def outer_loop(wx, wy, occ, state):
        """Derivatives are computed once per *executed* iteration (the
        alternation-top stacks serve iteration 0, matching the reference's
        reuse at variational_mt.cpp:266,289-290)."""

        def cond(c):
            wx, wy, state, it, change = c
            return (it < p.niter_outer) & (change >= p.thres_outer)

        def body(c):
            wx, wy, state, it, _ = c
            gated = gate_masks(state[2], occ)
            uu, vv, change = inner_loop(wx, wy, wx, wy, gated, state)
            if p.niter_inner != 1:
                # multi-increment inner loops: the last increment magnitude
                # is not the cumulative |new - old|; re-reduce over planes
                change = jnp.maximum(jnp.abs(uu - wx).sum(),
                                     jnp.abs(vv - wy).sum()) / hw
            change = jnp.float32(change)
            cont = (it + 1 < p.niter_outer) & (change >= p.thres_outer)
            state = jax.lax.cond(
                cont,
                lambda a: derive_state(a[0], a[1]),
                lambda a: a[2],
                (uu, vv, state))
            return uu, vv, state, it + jnp.int32(1), change

        init = (wx, wy, state, jnp.int32(0), jnp.float32(jnp.inf))
        wx, wy, _, _, change = jax.lax.while_loop(cond, body, init)
        return wx, wy, change

    def alter_cond(carry):
        wx, wy, occ, it, done = carry
        return (it < p.niter_alter) & jnp.logical_not(done)

    def occ_update(args):
        (succ, to_ref, mask), occ = args
        e0, e1 = occlusion_data_costs(mask, succ, to_ref, p)
        lab = solve_binary_potts(e0, e1, p.occlusion_alpha, p.niter_graphc)
        return 2.0 * lab - 1.0

    def alter_body(carry):
        wx, wy, occ, it, _ = carry
        state = derive_state(wx, wy)
        occ_stable = jnp.bool_(True)
        if p.occlusion_reasoning and not p.one_direction:
            new_occ = jax.lax.cond(it > 0, occ_update, lambda a: a[1],
                                   (state, occ))
            occ_stable = (it > 0) & jnp.all(new_occ == occ)
            occ = new_occ
        wx, wy, change = outer_loop(wx, wy, occ, state)
        # fixed-point exit: the reference runs all niter_alter alternations
        # unconditionally, but once the occlusion labels repeat and the
        # continuous solve moves below thres_outer, further alternations
        # reproduce the same state to below tolerance — skipping them is a
        # pure no-op elision.
        done = occ_stable & (change < p.thres_outer)
        return wx, wy, occ, it + jnp.int32(1), done

    wx, wy, occ, _, _ = jax.lax.while_loop(
        alter_cond, alter_body,
        (wx, wy, occ0, jnp.int32(0), jnp.bool_(False)))
    return wx, wy, occ


# --------------------------------------------------------------------------
# full coarse-to-fine driver
# --------------------------------------------------------------------------
def variational_mt(wx, wy, seq, p: MultiFrameParams,
                   channel_w=None, norm_avg=None, norm_std=None):
    """Slow Flow multi-frame minimization over the image pyramid
    (Variational_MT::variational, variational_mt.cpp:526-784).

    seq: [2*ref+1, 3, H, W] normalized window; wx/wy: [H, W] initial flow.
    Returns (wx, wy, occlusions {-1, +1}).
    """
    seq = jnp.asarray(seq, jnp.float32)
    wx = jnp.asarray(wx, jnp.float32)
    wy = jnp.asarray(wy, jnp.float32)
    f, c, h, w = seq.shape
    assert f == 2 * p.ref + 1, (f, p.ref)
    if channel_w is None:
        channel_w = jnp.ones((3, h, w), jnp.float32)
    if norm_avg is None:
        norm_avg = jnp.zeros(3, jnp.float32)
    if norm_std is None:
        norm_std = jnp.ones(3, jnp.float32)

    out = _mt_pipeline_batched(wx[None], wy[None], seq[None],
                               channel_w[None], norm_avg[None],
                               norm_std[None], p=p)
    return tuple(o[0] for o in out)


def _rescale_flow(wx, wy, nh, nw):
    fh = nh / wx.shape[-2]
    fw = nw / wx.shape[-1]
    wx = resize_bilinear(wx, nh, nw) * fw
    wy = resize_bilinear(wy, nh, nw) * fh
    return wx, wy


def _mt_pipeline(wx, wy, seq, channel_w, norm_avg, norm_std,
                 p: MultiFrameParams):
    """Whole coarse-to-fine batched solve as ONE compiled program: pyramid
    construction, per-level alternating minimization, and flow upscaling all
    fuse into a single dispatch instead of one host round trip per op."""
    b, f, c, h, w = seq.shape
    sizes = pyramid_sizes(h, w, p.layers, p.p_scale)
    pyr = build_pyramid(seq, sizes, p.p_scale, sigma0=p.sigma)
    cw_pyr = build_pyramid(channel_w, sizes, p.p_scale) \
        if p.layers > 1 else [channel_w]

    if b == 1 or (p.unroll_jets and b <= 16):
        # each jet solves independently inside the same program: its own
        # convergence chain, no vmap-synchronised while_loops
        def level_fn(wx, wy, seqs, cw, na, ns):
            outs = [compute_one_level(wx[i], wy[i], seqs[i], cw[i],
                                      na[i], ns[i], p=p) for i in range(b)]
            return tuple(jnp.stack(z) for z in zip(*outs))
    else:
        level_fn = jax.vmap(partial(compute_one_level, p=p))

    L = len(sizes)
    if L > 1:
        lh, lw = sizes[-1]
        wx, wy = _rescale_flow(wx, wy, lh, lw)

    occ = None
    for level in range(L - 1, -1, -1):
        if level < L - 1:
            lh, lw = sizes[level]
            wx, wy = _rescale_flow(wx, wy, lh, lw)
        wx, wy, occ = level_fn(
            wx, wy, pyr[level],
            cw_pyr[level] if p.layers > 1 else channel_w,
            norm_avg, norm_std)
    return wx, wy, occ


_mt_pipeline_batched = partial(jax.jit, static_argnames=("p",))(_mt_pipeline)


def _sharded_pipeline(p: MultiFrameParams, mesh, _cache={}):
    """shard_map of the full pipeline over the mesh's `jet` axis: each device
    runs the unrolled per-jet body on its local jets, the data parallelism
    the reference gets from OpenMP-over-jets (slow_flow.cpp:706 +
    variational_mt.cpp:13-14)."""
    from jax.sharding import PartitionSpec as P

    key = (p, mesh)
    if key in _cache:
        return _cache[key]
    spec = P("jet")
    # check_vma=False: the body is per-jet local with no collectives, and
    # its loop carries start from unvarying constants, so the VMA check
    # adds nothing here
    fn = jax.jit(jax.shard_map(
        partial(_mt_pipeline, p=p), mesh=mesh,
        in_specs=(spec,) * 6, out_specs=(spec,) * 3, check_vma=False))
    _cache[key] = fn
    return fn


def variational_mt_sharded(wx, wy, seq, p: MultiFrameParams, mesh,
                           channel_w=None, norm_avg=None, norm_std=None):
    """Multi-device jet-parallel minimization: the batch axis is sharded over
    `mesh`'s `jet` axis via shard_map and each device unrolls its local jets
    (no cross-jet communication exists, so out-shardings are pure data
    parallelism).

    Requires batch % n_jet == 0 and mesh sp extent 1 (spatial sharding goes
    through `parallel.mesh.sharded_jet_step`'s XLA-partitioned path instead).
    """
    seq = jnp.asarray(seq, jnp.float32)
    wx = jnp.asarray(wx, jnp.float32)
    wy = jnp.asarray(wy, jnp.float32)
    b, f, c, h, w = seq.shape
    assert f == 2 * p.ref + 1, (f, p.ref)
    n_jet = mesh.shape["jet"]
    assert b % n_jet == 0, (b, n_jet)
    if channel_w is None:
        channel_w = jnp.ones((b, 3, h, w), jnp.float32)
    if norm_avg is None:
        norm_avg = jnp.zeros((b, 3), jnp.float32)
    if norm_std is None:
        norm_std = jnp.ones((b, 3), jnp.float32)
    # inside the shard the batching decision sees the LOCAL batch b // n_jet
    return _sharded_pipeline(p, mesh)(wx, wy, seq, channel_w,
                                      norm_avg, norm_std)


def variational_mt_batched(wx, wy, seq, p: MultiFrameParams,
                           channel_w=None, norm_avg=None, norm_std=None):
    """Jet-parallel multi-frame minimization: vmap over a batch of windows.

    This replaces the reference's OpenMP-over-jets loop (slow_flow.cpp:706):
    many frame pairs are minimized per device in one dispatch; the batch axis can additionally be sharded across chips (pure
    data parallelism — no cross-jet communication exists).

    wx/wy: [B, H, W]; seq: [B, 2*ref+1, 3, H, W].
    Returns (wx, wy, occlusions) with leading batch dim.
    """
    seq = jnp.asarray(seq, jnp.float32)
    wx = jnp.asarray(wx, jnp.float32)
    wy = jnp.asarray(wy, jnp.float32)
    b, f, c, h, w = seq.shape
    assert f == 2 * p.ref + 1, (f, p.ref)
    if channel_w is None:
        channel_w = jnp.ones((b, 3, h, w), jnp.float32)
    if norm_avg is None:
        norm_avg = jnp.zeros((b, 3), jnp.float32)
    if norm_std is None:
        norm_std = jnp.ones((b, 3), jnp.float32)
    return _mt_pipeline_batched(wx, wy, seq, channel_w, norm_avg, norm_std,
                                p=p)
