"""Dense tracking driver — stage 3 of the pipeline (dense_tracking.cpp:415-1977).

Per final frame pair: load the jet estimations at one or more frame rates,
build trajectory hypotheses (consistent accumulations + EPIC-interpolated),
then alternate between neighbour-proposal propagation, non-maximum
suppression, and multi-label MRF selection (TRW/BP), writing the final
reference flow and occlusion map.

Array redesign highlights:
  - hypothesis sets are fixed-capacity [H, W, K] tensors (masks, not vectors
    of heap objects); all unary energies evaluate in one dispatch
  - FLANN KD-tree proposal sampling becomes seeded stratified offset sampling
    over the consistent-pixel lattice (identical distribution intent,
    reproducible via the cfg `seed`)
  - sequential TRW-S becomes synchronous TRW message passing (tracking.mrf)
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import ParameterList
from ..core.penalty import make_penalty
from .accumulate import accumulate_consistent_batches
from .hypothesis import (
    EnergyParams, adapt_fps, hypothesis_energy, set_occlusions,
    trajectory_distance, UNKNOWN,
)
from .mrf import pairwise_costs, solve_multilabel, BIG


@dataclass
class TrackingConfig:
    """All acc_* knobs (defaults: dense_tracking.cpp:118-166 + cfg)."""

    jets: int
    rates: int
    skip_pixel: int = 1
    consistency_threshold: float = 1.0
    discard_inconsistent: bool = False
    use_jet_occlusions: bool = False
    epic_interpolation: bool = True
    epic_skip: int = 2
    acc_jc: float = 1.0
    acc_bc: float = 0.1
    acc_gc: float = 1.0
    acc_occ: float = 500.0
    acc_beta: float = 10.0
    acc_spatial_occ: float = 10.0
    acc_cv: float = 0.0
    acc_temporal_occ: float = 10.0
    occlusion_threshold: float = 5.0
    occlusion_fb_threshold: float = 5.0
    alternate: int = 5
    approach: int = 0               # 0: TRW, 1: BP
    trws_eps: float = 1e-5
    trws_max_iter: int = 10
    neigh_hyp: int = 5
    neigh_hyp_radius: float = 100.0
    hyp_neigh_tryouts: int = 20
    nn_skip1: int = 2
    nn_skip2: int = 4
    perturb_keep: int = 0
    traj_sim_method: int = 1        # 0 ADJ, 1 ACC, 2 FINAL
    traj_sim_thres: float = 0.1
    penalty_fct_data: int = 1
    penalty_fct_data_eps: float = 0.001
    penalty_fct_reg: int = 1
    penalty_fct_reg_eps: float = 0.001
    seed: int = 0
    capacity: int = 16

    @classmethod
    def from_parameter_list(cls, params: ParameterList, jets: int, rates: int):
        g = params.parameter
        return cls(
            jets=jets, rates=rates,
            skip_pixel=g("acc_skip_pixel", "0", int),
            consistency_threshold=g("acc_consistency_threshold", "1.0", float),
            discard_inconsistent=g("acc_discard_inconsistent", "0", bool),
            use_jet_occlusions=g("acc_occlusion", "0", bool)
            or g("acc_use_jet_occlusions", "0", bool),
            epic_interpolation=g("acc_epic_interpolation", "1", bool),
            epic_skip=int(g("acc_epic_skip", "2", float)),
            acc_jc=g("acc_jet_consistency", "1.0", float),
            acc_bc=g("acc_brightness_constancy", "0.1", float),
            acc_gc=g("acc_gradient_constancy", "1.0", float),
            acc_occ=g("acc_occlusion_penalty", "500.0", float),
            acc_beta=g("acc_beta", "10.0", float),
            acc_spatial_occ=g("acc_spatial_occ", "10.0", float),
            acc_cv=g("acc_cv", "0.0", float),
            acc_temporal_occ=g("acc_temporal_occ", "10.0", float),
            occlusion_threshold=g("acc_occlusion_threshold", "5.0", float),
            occlusion_fb_threshold=g("acc_occlusion_fb_threshold", "5.0", float),
            alternate=g("acc_alternate", "5", int),
            approach=g("acc_approach", "0", int),
            trws_eps=g("acc_trws_eps", "1e-5", float),
            trws_max_iter=g("acc_trws_max_iter", "10", int),
            neigh_hyp=g("acc_neigh_hyp", "5", int),
            neigh_hyp_radius=g("acc_neigh_hyp_radius", "100.0", float),
            hyp_neigh_tryouts=g("acc_hyp_neigh_tryouts", "20", int),
            nn_skip1=g("acc_neigh_skip1", "2", int),
            nn_skip2=g("acc_neigh_skip2", "4", int),
            perturb_keep=g("acc_perturb_keep", "0", int),
            traj_sim_method=g("acc_traj_sim_method", "1", int),
            traj_sim_thres=g("acc_traj_sim_thres", "0.1", float),
            penalty_fct_data=g("acc_penalty_fct_data", "1", int),
            penalty_fct_data_eps=g("acc_penalty_fct_data_eps", "0.001", float),
            penalty_fct_reg=g("acc_penalty_fct_reg", "1", int),
            penalty_fct_reg_eps=g("acc_penalty_fct_reg_eps", "0.001", float),
            seed=g("seed", "0", int),
            capacity=g("acc_capacity", "16", int),
        )

    def energy_params(self) -> EnergyParams:
        return EnergyParams(
            acc_jc=self.acc_jc, acc_bc=self.acc_bc, acc_gc=self.acc_gc,
            acc_occ=self.acc_occ, acc_cv=self.acc_cv,
            acc_temporal_occ=self.acc_temporal_occ,
            skip_pixel=self.skip_pixel)


def jnp_occ(occlusions):
    """Jet occlusion maps -> jnp array or None (acc_occlusion gate)."""
    import jax.numpy as jnp

    if occlusions is None:
        return None
    return jnp.asarray(occlusions)


# --------------------------------------------------------------------------
# device-resident hypothesis bank
# --------------------------------------------------------------------------
# The reference stores per-pixel vectors of heap-allocated `hypothesis`
# objects (dense_tracking.cpp:690-724). Here the bank is a pytree of fixed
# [H, W, K, ...] tensors that lives on-device for the whole alternation:
# insertion, energy sorting, NMS and proposal propagation are all jitted, so
# one alternation costs a handful of dispatches and no bulk host<->device
# transfer of the bank.


def _new_bank(h, w, K, J):
    import jax.numpy as jnp

    return dict(
        flows=jnp.full((h, w, K, J, 2), UNKNOWN, jnp.float32),
        occl=jnp.zeros((h, w, K, J + 1), jnp.int32),
        energy=jnp.full((h, w, K), jnp.inf, jnp.float32),
        valid=jnp.zeros((h, w, K), bool),
        jet_est=jnp.zeros((h, w, K), jnp.int32),
    )


def _bank_insert(bank, flows, occl, energy, jet_est, mask):
    """Insert one hypothesis per pixel into the first free slot.
    flows [h, w, J, 2]; mask [h, w]. Returns (bank, inserted [h, w])."""
    import jax.numpy as jnp

    K = bank["energy"].shape[-1]
    free = ~bank["valid"]
    first_free = jnp.argmax(free, axis=-1)                    # [h, w]
    sel = ((jnp.arange(K) == first_free[..., None])
           & (mask & free.any(-1))[..., None])                # [h, w, K]
    jet = jnp.broadcast_to(jnp.asarray(jet_est, jnp.int32), mask.shape)
    new = dict(
        flows=jnp.where(sel[..., None, None], flows[:, :, None],
                        bank["flows"]),
        occl=jnp.where(sel[..., None], occl[:, :, None], bank["occl"]),
        energy=jnp.where(sel, energy[..., None], bank["energy"]),
        valid=bank["valid"] | sel,
        jet_est=jnp.where(sel, jet[..., None], bank["jet_est"]),
    )
    return new, sel.any(-1)


def _bank_permute(bank, order):
    """Apply a per-pixel slot permutation `order` [h, w, K] to every bank
    field: an exact gather along the slot axis (sentinels pass through)."""
    import jax.numpy as jnp

    def apply(a):
        idx = order.reshape(order.shape + (1,) * (a.ndim - 3))
        return jnp.take_along_axis(
            a, jnp.broadcast_to(idx, order.shape + a.shape[3:]), axis=2)

    return {k: apply(v) for k, v in bank.items()}


def _bank_sort(bank, keep_first=None):
    """Ascending-energy sort per pixel; `keep_first` ([h, w] slot indices)
    is pinned to position 0 first (dense_tracking.cpp:1384-1428)."""
    import jax.numpy as jnp

    K = bank["energy"].shape[-1]
    e = jnp.where(bank["valid"], bank["energy"], jnp.inf)
    if keep_first is not None:
        sel = (jnp.arange(K) == jnp.clip(keep_first, 0, K - 1)[..., None])
        e = jnp.where(sel, -jnp.inf, e)
    order = jnp.argsort(e, axis=-1, stable=True)
    return _bank_permute(bank, order)


def _bank_truncate(bank, n: int):
    import jax.numpy as jnp

    K = bank["energy"].shape[-1]
    keep = jnp.arange(K) < n
    valid = bank["valid"] & keep
    return dict(bank, valid=valid,
                energy=jnp.where(valid, bank["energy"], jnp.inf))


def _bank_nms(bank, method: int, thres: float):
    """Greedy per-pixel non-maximum suppression by trajectory distance
    (dense_tracking.cpp:1585-1637). Assumes slots sorted by priority."""
    import jax.numpy as jnp

    K = bank["energy"].shape[-1]
    d = trajectory_distance(bank["flows"][:, :, :, None],
                            bank["flows"][:, :, None, :], method)
    kept = [bank["valid"][..., 0]]
    for k in range(1, K):
        close = (d[..., k, :k] < thres) & jnp.stack(kept, -1)
        kept.append(bank["valid"][..., k] & ~close.any(-1))
    valid = bank["valid"] & jnp.stack(kept, -1)
    return dict(bank, valid=valid,
                energy=jnp.where(valid, bank["energy"], jnp.inf))


def _initial_evaluator(pen_fct, pen_eps, occ_thr, fb_thr, ep, has_occ,
                       _cache={}):
    """Jitted initial-hypothesis evaluation + insertion, cached at module
    level so repeated final pairs reuse the compiled program."""
    import jax

    key = (pen_fct, pen_eps, occ_thr, fb_thr, ep, has_occ)
    if key in _cache:
        return _cache[key]
    pen_d = make_penalty(pen_fct, pen_eps)

    @jax.jit
    def run(bank, flows, fully, wj, rate, px, py, forward, backward, data,
            ddx, ddy, *extra):
        occ_masks = extra[0] if has_occ else None
        occl = set_occlusions(px, py, flows[:, :, None], forward,
                              backward, occ_thr, fb_thr)[:, :, 0]
        energy = hypothesis_energy(px, py, flows[:, :, None],
                                   occl[:, :, None], forward, data,
                                   ddx, ddy, pen_d, ep,
                                   occ_masks)[:, :, 0] + wj
        # the source rate index rides along so propagation re-applies
        # weight_jet_estimation[jet_est] (dense_tracking.cpp:1244,1553)
        return _bank_insert(bank, flows, occl, energy, rate, fully)[0]

    _cache[key] = run
    return run


# --------------------------------------------------------------------------
# initial hypotheses
# --------------------------------------------------------------------------
def build_initial_hypotheses(bank, cfg: TrackingConfig, rate_flows,
                             forward, backward, occlusions,
                             data, data_dx, data_dy, weight_jet, epic_ctx,
                             timing=None):
    """Hypothesis generation from each jet estimation
    (dense_tracking.cpp:1098-1360). bank is a device bank dict; returns
    (bank, consistent [h, w] np.bool_). `timing` accumulates "warp"
    (accumulation) and "data" (energy evaluation) seconds, mirroring
    dt_warp_time/dt_sum_time (dense_tracking.cpp:305,336)."""
    import time as _time

    import jax
    import jax.numpy as jnp

    occ_masks = jnp_occ(occlusions)
    timing = timing if timing is not None else {}
    timing.setdefault("warp", 0.0)
    timing.setdefault("data", 0.0)

    pen_d = make_penalty(cfg.penalty_fct_data, cfg.penalty_fct_data_eps)
    ep = cfg.energy_params()
    xy_incr = cfg.skip_pixel + 1
    xy_start = int(0.5 * cfg.skip_pixel)
    h, w = bank["energy"].shape[:2]
    px = (jnp.arange(w, dtype=jnp.float32) * xy_incr + xy_start)[None, :, None]
    py = (jnp.arange(h, dtype=jnp.float32) * xy_incr + xy_start)[:, None, None]
    px = jnp.broadcast_to(px, (h, w, 1))
    py = jnp.broadcast_to(py, (h, w, 1))

    forward_j = jnp.asarray(forward)
    backward_j = jnp.asarray(backward)
    data_j = jnp.asarray(data)
    ddx_j = jnp.asarray(data_dx)
    ddy_j = jnp.asarray(data_dy)

    evaluate = _initial_evaluator(
        cfg.penalty_fct_data, cfg.penalty_fct_data_eps,
        cfg.occlusion_threshold, cfg.occlusion_fb_threshold, ep,
        occ_masks is not None)

    def eval_and_insert(bank, flows, fully, wj, rate):
        extra = (occ_masks,) if occ_masks is not None else ()
        return evaluate(bank, flows, fully, wj, jnp.int32(rate), px, py,
                        forward_j, backward_j, data_j, ddx_j, ddy_j, *extra)

    consistent = np.zeros((h, w), bool)
    for r, (r_fwd, r_bwd, r_occ) in enumerate(rate_flows):
        r_jets = r_fwd.shape[0]
        t0 = _time.time()
        acc, tracked = accumulate_consistent_batches(
            r_fwd, r_bwd, r_occ, cfg.consistency_threshold, cfg.skip_pixel,
            cfg.discard_inconsistent)
        fully_j = (tracked == r_jets)
        fully = np.asarray(fully_j)                    # [h, w] bool, tiny
        timing["warp"] += _time.time() - t0

        consistent |= fully

        t0 = _time.time()
        flows = adapt_fps(jnp.moveaxis(acc, 0, 2), cfg.jets)
        bank = eval_and_insert(bank, flows, fully_j, float(weight_jet[r]), r)
        jax.block_until_ready(bank["energy"])
        timing["data"] += _time.time() - t0

        # EPIC-interpolated hypotheses from the consistent matches; isolated
        # consistent speckles are removed first (dense_tracking.cpp:1265)
        if cfg.epic_interpolation and epic_ctx is not None:
            from ..utils.segments import remove_small_segments

            r_cons = fully.astype(np.int32)
            remove_small_segments(r_cons, 0.1, 100)
            epic_flows = _epic_hypotheses(np.asarray(acc), r_cons > 0, cfg,
                                          epic_ctx)
            if epic_flows is not None:
                t0 = _time.time()
                eflows = adapt_fps(jnp.asarray(epic_flows), cfg.jets)
                bank = eval_and_insert(
                    bank, eflows, jnp.ones((h, w), bool),
                    float(weight_jet[r]), r)
                jax.block_until_ready(bank["energy"])
                timing["data"] += _time.time() - t0
    return bank, consistent
def _epic_hypotheses(acc, consistent, cfg: TrackingConfig, epic_ctx):
    """EPIC interpolation of each jet's consistent accumulated flow
    (dense_tracking.cpp:1268-1350). The per-jet interpolations are
    independent, so the geodesic distance transforms run as ONE batched
    device dispatch across all jets (`epic_batched`) instead of the
    reference's serial per-jet loop. Returns [h, w, r_jets, 2] or None."""
    from ..epic import epic_batched

    imlab, edges, epic_params = epic_ctx
    r_jets, h, w = acc.shape[:3]
    xy_incr = cfg.skip_pixel + 1
    skip = cfg.epic_skip
    ys, xs = np.mgrid[int(0.5 * skip):h:skip, int(0.5 * skip):w:skip]
    sel = consistent[ys, xs]
    if sel.sum() < 8:
        return None
    sx = xs[sel]
    sy = ys[sel]

    sal = None
    if epic_params.saliency_th:
        import jax.numpy as jnp

        from ..core.image import saliency as saliency_fn

        sal = np.asarray(saliency_fn(jnp.asarray(imlab), 0.8, 1.0))
    jobs = []
    for j in range(r_jets):
        m = np.stack([
            sx, sy,
            sx + acc[j][sy, sx, 0] / xy_incr,
            sy + acc[j][sy, sx, 1] / xy_incr,
        ], 1).astype(np.float32)
        jobs.append((imlab, m, edges, sal))
    flows = epic_batched(jobs, epic_params)

    out = np.zeros((h, w, r_jets, 2), np.float32)
    for j, flow in enumerate(flows):
        out[:, :, j, 0] = flow[:h, :w, 0] * xy_incr
        out[:, :, j, 1] = flow[:h, :w, 1] * xy_incr
    return out




# --------------------------------------------------------------------------
# neighbour-proposal propagation (device-resident)
# --------------------------------------------------------------------------
def _propagation_kernel(pen_fct, pen_eps, occ_thr, fb_thr, sim_method,
                        sim_thres, ep, has_occ, strides, base_radius,
                        base_want, ntry, group, n_rates, use_consistent,
                        xy_incr, xy_start, batched=False, _cache={}):
    """One jitted program for a full propagation pass: both lattice strides,
    all tryout groups, gathers, and the reference's sequential insertion
    semantics (dense_tracking.cpp:1434-1583). The only inputs that move are
    a PRNG key; the bank never leaves the device.

    With `batched=True` the program is vmapped over a leading final-pair
    axis F on everything except the PRNG key and weight_jet (shared): F
    final pairs advance in ONE dispatch chain, amortizing the per-kernel
    dispatch latency that dominates stage 3 (the reference instead OpenMPs
    whole finals across cores, dense_tracking.cpp:726-727).

    Decoupled insert/evaluate: insertion decisions depend only on source
    validity, the `want` budget, and trajectory-similarity rejection — never
    on the candidate's energy (the reference computes the energy merely to
    store it; dense_tracking.cpp:1544-1575). Candidates are also gathered
    exclusively from slot 0, which insertions never modify (every pixel has
    a valid slot 0, so new hypotheses always land in slots >= 1). The pass
    therefore runs the sequential insertion loop with placeholder energies
    (phase 1, cheap gathers + distances only) and then fills energy +
    occlusions for ALL slots inserted this pass in ONE batched evaluation
    (phase 2) — ~ntry/K fewer addBCGC sampling sweeps than evaluating every
    tryout group, with identical results."""
    import jax
    import jax.numpy as jnp

    key_s = (pen_fct, pen_eps, occ_thr, fb_thr, sim_method, sim_thres, ep,
             has_occ, strides, base_radius, base_want, ntry, group, n_rates,
             use_consistent, xy_incr, xy_start, batched)
    if key_s in _cache:
        return _cache[key_s]
    pen_d = make_penalty(pen_fct, pen_eps)

    def run(bank, key, consistent, forward, backward, data, ddx, ddy,
            weight_jet, *extra):
        occ_masks = extra[0] if has_occ else None
        h, w = bank["energy"].shape[:2]
        J = bank["flows"].shape[3]
        yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        px = (xx * xy_incr + xy_start).astype(jnp.float32)[..., None]
        py = (yy * xy_incr + xy_start).astype(jnp.float32)[..., None]

        valid0 = bank["valid"]                 # pass-start snapshot
        zero_occl = jnp.zeros((h, w, J + 1), jnp.int32)
        zero_energy = jnp.zeros((h, w), jnp.float32)

        for t, stride in enumerate(strides):
            radius = (t + 1) * base_radius / xy_incr
            want = (t + 1) * base_want
            k_ang, k_rad = jax.random.split(jax.random.fold_in(key, t))
            ang = jax.random.uniform(k_ang, (ntry, h, w), jnp.float32,
                                     0.0, 2 * np.pi)
            rad = jnp.sqrt(jax.random.uniform(k_rad, (ntry, h, w),
                                              jnp.float32)) * radius
            sx_all = jnp.clip((xx + rad * jnp.cos(ang)).astype(jnp.int32),
                              0, w - 1)
            sy_all = jnp.clip((yy + rad * jnp.sin(ang)).astype(jnp.int32),
                              0, h - 1)
            sx_all = jnp.clip(((sx_all - 1) // stride) * stride + 1, 0, w - 1)
            sy_all = jnp.clip(((sy_all - 1) // stride) * stride + 1, 0, h - 1)
            # pad to a whole number of groups; the tail candidates are
            # masked out by the global-index check below
            pad_n = (-ntry) % group
            if pad_n:
                sx_all = jnp.concatenate([sx_all, sx_all[:pad_n]], 0)
                sy_all = jnp.concatenate([sy_all, sy_all[:pad_n]], 0)

            def group_body(carry):
                bank, added, g0 = carry
                sxg = jax.lax.dynamic_slice_in_dim(sx_all, g0, group, 0)
                syg = jax.lax.dynamic_slice_in_dim(sy_all, g0, group, 0)
                G = group
                # candidates come from slot 0, which is invariant during
                # the pass (insertions fill free slots >= 1)
                cand_flows = jnp.moveaxis(
                    bank["flows"][syg, sxg, 0], 0, 2)         # [h, w, G, J, 2]
                cand_jet = jnp.moveaxis(
                    bank["jet_est"][syg, sxg, 0], 0, 2)       # [h, w, G]
                src_valid = jnp.moveaxis(
                    bank["valid"][syg, sxg, 0], 0, 2)
                if use_consistent:
                    src_valid = src_valid & jnp.moveaxis(
                        consistent[syg, sxg], 0, 2)

                d_bank = trajectory_distance(cand_flows[:, :, :, None],
                                             bank["flows"][:, :, None],
                                             sim_method)   # [h, w, G, K]
                d_cand = trajectory_distance(cand_flows[:, :, :, None],
                                             cand_flows[:, :, None],
                                             sim_method)   # [h, w, G, G]

                # sequential insertion with similarity rejection; d_bank
                # rows are refreshed per *group* (see the group-size note in
                # the reference port) while in-group candidates check each
                # other through d_cand
                valid_live = bank["valid"]
                inserted_prev = []
                for i in range(G):
                    src_ok = (src_valid[:, :, i]
                              & ((sxg[i] != xx) | (syg[i] != yy))
                              & (added < want)
                              & (g0 + i < ntry))
                    similar = ((d_bank[:, :, i] < sim_thres)
                               & valid_live).any(-1)
                    for j in range(i):
                        similar = similar | (
                            inserted_prev[j]
                            & (d_cand[:, :, i, j] < sim_thres))
                    ins = src_ok & ~similar
                    bank, sel = _bank_insert(
                        bank, cand_flows[:, :, i], zero_occl,
                        zero_energy, cand_jet[:, :, i], ins)
                    valid_live = bank["valid"]
                    inserted_prev.append(ins)
                    added = added + ins.astype(jnp.int32)
                return bank, added, g0 + group

            def group_cond(carry):
                # the reference's tryout-loop break: once every pixel has
                # adopted `want` proposals, further groups cannot insert
                # (dense_tracking.cpp:1580-1582) — skip their evaluation
                _, added, g0 = carry
                return (g0 < ntry) & ~jnp.all(added >= want)

            added0 = jnp.zeros((h, w), jnp.int32)
            bank, _, _ = jax.lax.while_loop(
                group_cond, group_body, (bank, added0, jnp.int32(0)))

        # phase 2: one batched energy/occlusion evaluation over every slot
        # inserted this pass (flows were recorded by phase 1; energies are
        # pure functions of them, so deferring is result-identical)
        inserted = bank["valid"] & ~valid0                    # [h, w, K]
        all_flows = bank["flows"]
        occl_all = set_occlusions(px, py, all_flows, forward, backward,
                                  occ_thr, fb_thr)            # [h, w, K, J+1]
        energy_all = hypothesis_energy(px, py, all_flows, occl_all, forward,
                                       data, ddx, ddy, pen_d, ep, occ_masks)
        wj = (weight_jet[None, None]
              * (bank["jet_est"][..., None]
                 == jnp.arange(n_rates)[None, None, None])).sum(-1)
        energy_all = energy_all + wj
        return dict(
            bank,
            occl=jnp.where(inserted[..., None], occl_all, bank["occl"]),
            energy=jnp.where(inserted, energy_all, bank["energy"]),
        )

    if batched:
        in_axes = ((0, None, 0, 0, 0, 0, 0, 0, None)
                   + ((0,) if has_occ else ()))
        run = jax.jit(jax.vmap(run, in_axes=in_axes))
    else:
        run = jax.jit(run)
    _cache[key_s] = run
    return run


def _selection_kernels(sim_method, sim_thres, beta, spatial_occ, approach,
                       trws_iters, trws_eps, xy_incr, xy_start,
                       batched=False, _cache={}):
    """Jitted NMS + unary/pairwise construction + TRW/BP solve. With
    `batched=True` every kernel is vmapped over a leading final-pair axis."""
    import jax
    import jax.numpy as jnp

    key = (sim_method, sim_thres, beta, spatial_occ, approach, trws_iters,
           trws_eps, xy_incr, xy_start, batched)
    if key in _cache:
        return _cache[key]

    def nms(bank):
        return _bank_nms(bank, sim_method, sim_thres)

    def unary_of(bank):
        return jnp.where(bank["valid"], bank["energy"], BIG)

    def pairwise_of(bank, smooth_weight):
        safe = jnp.where(bank["valid"][..., None, None], bank["flows"], 0.0)
        return pairwise_costs(safe, bank["occl"], smooth_weight, beta,
                              spatial_occ, sim_method, xy_incr, xy_start)

    def solve(unary, cost_r, cost_d):
        return solve_multilabel(unary, cost_r, cost_d, iters=trws_iters,
                                approach=approach, eps=trws_eps)

    def sort_first(bank):
        return _bank_sort(bank)

    def sort_keep(bank, selected, keep_n):
        bank = _bank_sort(bank, keep_first=selected)
        return _bank_truncate(bank, keep_n)

    if batched:
        nms = jax.vmap(nms)
        unary_of = jax.vmap(unary_of)
        pairwise_of = jax.vmap(pairwise_of)
        solve = jax.vmap(solve)
        sort_first = jax.vmap(sort_first)
        sort_keep = jax.vmap(sort_keep, in_axes=(0, 0, None))
    kernels = tuple(jax.jit(f) for f in
                    (nms, unary_of, pairwise_of, solve, sort_first,
                     sort_keep))
    _cache[key] = kernels
    return kernels


def _init_final_state(cfg: TrackingConfig, rate_flows, forward, backward,
                      occlusions, data, data_dx, data_dy, weight_jet,
                      epic_ctx, timing):
    """Initial hypothesis bank for one final pair: per-rate accumulation,
    EPIC interpolation, energies, plus the guaranteed zero-flow outlier.
    Returns (bank, consistent [h, w] bool)."""
    import jax.numpy as jnp

    J = cfg.jets
    xy_incr = cfg.skip_pixel + 1
    oh, ow = data.shape[1:3]
    h = int(np.floor(oh / xy_incr))
    w = int(np.floor(ow / xy_incr))

    bank = _new_bank(h, w, cfg.capacity, J)
    bank, consistent = build_initial_hypotheses(
        bank, cfg, rate_flows, forward, backward, occlusions,
        data, data_dx, data_dy, weight_jet, epic_ctx, timing)

    # guarantee at least one hypothesis everywhere: zero-flow outlier
    zero_flow = jnp.zeros((h, w, J, 2), jnp.float32)
    occl0 = jnp.ones((h, w, J + 1), jnp.int32).at[..., 0].set(0)
    energy0 = jnp.full((h, w), 1e6, jnp.float32)
    bank, _ = _bank_insert(bank, zero_flow, occl0, energy0, 0,
                           ~bank["valid"].any(-1))
    return bank, consistent


def _readback(flows, occl, selected, J, xy_incr):
    """Final flow + occlusion map from the selected slot per pixel: one
    [h, w, ...] gather on device, two small fetches."""
    import jax.numpy as jnp

    idx = selected[..., None]                                   # [h, w, 1]
    final_flow = jnp.take_along_axis(
        flows[:, :, :, J - 1], jnp.broadcast_to(idx[..., None],
                                                selected.shape + (1, 2)),
        axis=2)[:, :, 0] / xy_incr
    occ_any = jnp.take_along_axis(occl.max(-1), idx, axis=2)[..., 0] > 0
    return final_flow, occ_any


def track_final_pair(cfg: TrackingConfig, rate_flows, forward, backward,
                     occlusions, data, data_dx, data_dy, smooth_weight,
                     weight_jet=None, epic_ctx=None, verbose=False):
    """Full alternating optimization for one final frame pair.

    rate_flows: list of (forward [Jr, H, W, 2], backward, occl-or-None) per
    frame rate (index 0 = the reference/min-fps rate).
    forward/backward: the min-fps jet flows [J, H, W, 2].
    data*: [J+1, H, W, 3] normalized images and derivatives.
    smooth_weight: [H, W].
    Returns (flow [h, w, 2], occlusion_map [h, w] uint8, info dict).
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    if weight_jet is None:
        weight_jet = np.arange(cfg.rates, dtype=np.float32)
    J = cfg.jets
    xy_incr = cfg.skip_pixel + 1
    xy_start = int(0.5 * cfg.skip_pixel)
    oh, ow = data.shape[1:3]
    h = int(np.floor(oh / xy_incr))
    w = int(np.floor(ow / xy_incr))

    # per-phase accumulators matching the reference's result.info rows
    # (dense_tracking.cpp:1951-1964); "median" exists in the reference but
    # is never incremented there either (dt_med_time, :235,1371)
    timing = {"warp": 0.0, "median": 0.0, "data": 0.0,
              "unary": 0.0, "pairwise": 0.0, "optimization": 0.0}

    bank, consistent = _init_final_state(
        cfg, rate_flows, forward, backward, occlusions,
        data, data_dx, data_dy, weight_jet, epic_ctx, timing)

    occ_masks = jnp_occ(occlusions)
    ep = cfg.energy_params()
    forward_j = jnp.asarray(forward)
    backward_j = jnp.asarray(backward)
    data_j = jnp.asarray(data)
    ddx_j = jnp.asarray(data_dx)
    ddy_j = jnp.asarray(data_dy)
    weight_jet_j = jnp.asarray(weight_jet, jnp.float32)
    consistent_j = jnp.asarray(consistent)
    smooth_weight_j = jnp.asarray(smooth_weight)
    group = max(1, min(4, cfg.hyp_neigh_tryouts))
    nms_k, unary_of, pairwise_of, solve, sort_first, sort_keep = \
        _selection_kernels(cfg.traj_sim_method, cfg.traj_sim_thres,
                           cfg.acc_beta, cfg.acc_spatial_occ, cfg.approach,
                           cfg.trws_max_iter, cfg.trws_eps, xy_incr,
                           xy_start)

    selected = None
    info = {"variables": [], "factors": [], "timing": timing}
    for p_it in range(cfg.alternate):
        if p_it == 0:
            bank = sort_first(bank)
        else:
            bank = sort_keep(bank, selected, 1 + cfg.perturb_keep)

        propagate = _propagation_kernel(
            cfg.penalty_fct_data, cfg.penalty_fct_data_eps,
            cfg.occlusion_threshold, cfg.occlusion_fb_threshold,
            cfg.traj_sim_method, cfg.traj_sim_thres, ep,
            occ_masks is not None, (cfg.nn_skip1, cfg.nn_skip2),
            cfg.neigh_hyp_radius, cfg.neigh_hyp, cfg.hyp_neigh_tryouts,
            group, len(weight_jet), p_it == 0, xy_incr, xy_start)
        extra = (occ_masks,) if occ_masks is not None else ()
        key = jax.random.PRNGKey(cfg.seed)
        t0 = _time.time()
        bank = propagate(bank, jax.random.fold_in(key, p_it), consistent_j,
                         forward_j, backward_j, data_j, ddx_j, ddy_j,
                         weight_jet_j, *extra)
        bank = nms_k(bank)
        jax.block_until_ready(bank["energy"])
        # candidate-energy evaluation = the reference's dt_sum_time row
        # (dense_tracking.cpp:336,1571)
        timing["data"] += _time.time() - t0

        t0 = _time.time()
        unary = unary_of(bank)
        jax.block_until_ready(unary)
        timing["unary"] += _time.time() - t0

        t0 = _time.time()
        cost_r, cost_d = pairwise_of(bank, smooth_weight_j)
        jax.block_until_ready((cost_r, cost_d))
        timing["pairwise"] += _time.time() - t0

        t0 = _time.time()
        labels, energy, lb = solve(unary, cost_r, cost_d)
        selected = labels
        jax.block_until_ready(labels)
        timing["optimization"] += _time.time() - t0
        info["variables"].append(h * w)
        info["factors"].append(int(2 * h * w - h - w + h * w))
        if verbose:
            print(f"  alternate {p_it}: energy={float(energy):.1f} "
                  f"lower_bound={float(lb):.1f} "
                  f"hyps={int(np.asarray(bank['valid']).sum())}")

    final_flow, occ_any = _readback(bank["flows"], bank["occl"], selected,
                                    J, xy_incr)
    flow_np = np.asarray(final_flow, np.float32)
    occ_map = np.asarray(occ_any).astype(np.uint8) * 255
    return flow_np, occ_map, info


def track_final_pairs_batched(cfg: TrackingConfig, jobs, weight_jet=None,
                              verbose=False, init_workers=0):
    """Alternating optimization for F final frame pairs in ONE batched
    dispatch chain.

    The reference parallelizes stage 3 by OpenMP-ing whole final pairs
    across CPU cores (dense_tracking.cpp:726-727). The array analogue is
    batching: the per-final tensors are identical shapes, so the bank
    pytree gains a leading F axis and every alternation kernel runs
    vmapped — F finals cost one dispatch chain instead of F, amortizing
    the dispatch latency that dominates the (latency-bound) device side.

    jobs: list of dicts with keys rate_flows, forward, backward,
    occlusions, data, data_dx, data_dy, smooth_weight, epic_ctx — the
    same per-final inputs as `track_final_pair`. All jobs must share
    shapes and occlusion availability. The per-final bank initialization
    (host-heavy: accumulation + EPIC interpolation) optionally overlaps
    on `init_workers` threads.

    Returns (flows list of [h, w, 2], occ_maps list of uint8 [h, w], info).
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    if weight_jet is None:
        weight_jet = np.arange(cfg.rates, dtype=np.float32)
    F = len(jobs)
    timing = {"warp": 0.0, "median": 0.0, "data": 0.0,
              "unary": 0.0, "pairwise": 0.0, "optimization": 0.0}
    if F == 1:
        j = jobs[0]
        flow, occ, info = track_final_pair(
            cfg, j["rate_flows"], j["forward"], j["backward"],
            j["occlusions"], j["data"], j["data_dx"], j["data_dy"],
            j["smooth_weight"], weight_jet, j.get("epic_ctx"),
            verbose=verbose)
        return [flow], [occ], info

    has_occ = jobs[0]["occlusions"] is not None
    assert all((j["occlusions"] is not None) == has_occ for j in jobs), \
        "all batched finals must agree on jet-occlusion availability"

    J = cfg.jets
    xy_incr = cfg.skip_pixel + 1
    xy_start = int(0.5 * cfg.skip_pixel)

    def init_one(job):
        t = {}
        bank, consistent = _init_final_state(
            cfg, job["rate_flows"], job["forward"], job["backward"],
            job["occlusions"], job["data"], job["data_dx"], job["data_dy"],
            weight_jet, job.get("epic_ctx"), t)
        return bank, consistent, t

    if init_workers and init_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(init_workers, F)) as ex:
            inits = list(ex.map(init_one, jobs))
    else:
        inits = [init_one(j) for j in jobs]
    for _, _, t in inits:
        for k, v in t.items():
            timing[k] = timing.get(k, 0.0) + v

    # stack the banks and per-final inputs along a leading F axis
    bank = {k: jnp.stack([b[k] for b, _, _ in inits])
            for k in inits[0][0]}
    consistent_j = jnp.stack([jnp.asarray(c) for _, c, _ in inits])
    forward_j = jnp.stack([jnp.asarray(j["forward"]) for j in jobs])
    backward_j = jnp.stack([jnp.asarray(j["backward"]) for j in jobs])
    data_j = jnp.stack([jnp.asarray(j["data"]) for j in jobs])
    ddx_j = jnp.stack([jnp.asarray(j["data_dx"]) for j in jobs])
    ddy_j = jnp.stack([jnp.asarray(j["data_dy"]) for j in jobs])
    smooth_weight_j = jnp.stack(
        [jnp.asarray(j["smooth_weight"]) for j in jobs])
    weight_jet_j = jnp.asarray(weight_jet, jnp.float32)
    extra = ((jnp.stack([jnp_occ(j["occlusions"]) for j in jobs]),)
             if has_occ else ())

    h, w = bank["energy"].shape[1:3]
    ep = cfg.energy_params()
    group = max(1, min(4, cfg.hyp_neigh_tryouts))
    nms_k, unary_of, pairwise_of, solve, sort_first, sort_keep = \
        _selection_kernels(cfg.traj_sim_method, cfg.traj_sim_thres,
                           cfg.acc_beta, cfg.acc_spatial_occ, cfg.approach,
                           cfg.trws_max_iter, cfg.trws_eps, xy_incr,
                           xy_start, batched=True)

    # every final uses the same PRNG stream as a serial run would
    # (track_final_pair seeds PRNGKey(cfg.seed) per final), so batched and
    # serial runs propose identical candidates
    key = jax.random.PRNGKey(cfg.seed)

    selected = None
    info = {"variables": [], "factors": [], "timing": timing}
    for p_it in range(cfg.alternate):
        if p_it == 0:
            bank = sort_first(bank)
        else:
            bank = sort_keep(bank, selected, 1 + cfg.perturb_keep)

        propagate = _propagation_kernel(
            cfg.penalty_fct_data, cfg.penalty_fct_data_eps,
            cfg.occlusion_threshold, cfg.occlusion_fb_threshold,
            cfg.traj_sim_method, cfg.traj_sim_thres, ep,
            has_occ, (cfg.nn_skip1, cfg.nn_skip2),
            cfg.neigh_hyp_radius, cfg.neigh_hyp, cfg.hyp_neigh_tryouts,
            group, len(weight_jet), p_it == 0, xy_incr, xy_start,
            batched=True)
        t0 = _time.time()
        bank = propagate(bank, jax.random.fold_in(key, p_it), consistent_j,
                         forward_j, backward_j, data_j, ddx_j, ddy_j,
                         weight_jet_j, *extra)
        bank = nms_k(bank)
        jax.block_until_ready(bank["energy"])
        timing["data"] += _time.time() - t0

        t0 = _time.time()
        unary = unary_of(bank)
        jax.block_until_ready(unary)
        timing["unary"] += _time.time() - t0

        t0 = _time.time()
        cost_r, cost_d = pairwise_of(bank, smooth_weight_j)
        jax.block_until_ready((cost_r, cost_d))
        timing["pairwise"] += _time.time() - t0

        t0 = _time.time()
        labels, energy, lb = solve(unary, cost_r, cost_d)
        selected = labels
        jax.block_until_ready(labels)
        timing["optimization"] += _time.time() - t0
        info["variables"].append(h * w)
        info["factors"].append(int(2 * h * w - h - w + h * w))
        if verbose:
            print(f"  alternate {p_it} (batch {F}): "
                  f"energy={np.asarray(energy).sum():.1f} "
                  f"lower_bound={np.asarray(lb).sum():.1f}")

    from functools import partial

    readback = jax.jit(jax.vmap(
        partial(_readback, J=J, xy_incr=xy_incr)))
    flow_b, occ_b = readback(bank["flows"], bank["occl"], selected)
    flows_np = np.asarray(flow_b, np.float32)
    occs_np = np.asarray(occ_b)
    return ([flows_np[i] for i in range(F)],
            [occs_np[i].astype(np.uint8) * 255 for i in range(F)],
            info)
