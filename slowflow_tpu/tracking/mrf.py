"""Multi-label grid MRF for trajectory selection (TRW / BP message passing).

The reference hands a general grid MRF (per-pixel label = hypothesis index,
unary = trajectory energy, pairwise = smoothness-weighted trajectory distance
plus occlusion disagreement) to the sequential TRW-S v1.3 library with a BP
alternative (dense_tracking.cpp:1654-1872). The array re-expression runs
*synchronous* min-sum message passing over the 4-connected grid:

  - `approach=0` (TRW): tree-reweighted updates with uniform edge appearance
    probabilities rho = 0.5 (each edge is in half of the row/column chains) —
    the synchronous counterpart of TRW-S; a lower bound is accumulated from
    message normalizations.
  - `approach=1` (BP): plain damped loopy min-sum.

Sequential TRW-S and its synchronous variant share fixpoints on this energy;
parity with the reference is judged at the labeling level (SURVEY.md §7 hard
part 1/3).

All messages live as [H, W, K] tensors; one iteration is a handful of
broadcast min-reductions over [H, W, K, K] — fully parallel on the device.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BIG = 1e9


def _shift(x, dy, dx, fill=0.0):
    pads = [(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))]
    pads += [(0, 0)] * (x.ndim - 2)
    padded = jnp.pad(x, pads, constant_values=fill)
    h, w = x.shape[:2]
    return padded[pads[0][1]:pads[0][1] + h, pads[1][1]:pads[1][1] + w]


@partial(jax.jit, static_argnames=("iters", "approach"))
def solve_multilabel(unary, cost_r, cost_d, iters: int = 10,
                     approach: int = 0, damping: float = 0.5,
                     eps: float = 1e-5):
    """Minimize sum_p unary[p, l_p] + sum_{pq} C_pq[l_p, l_q].

    unary:  [H, W, K] (+BIG for invalid labels)
    cost_r: [H, W, K, K] pairwise to the right neighbour (K_p x K_q)
    cost_d: [H, W, K, K] pairwise to the down neighbour
    Returns (labels [H, W] int32, energy scalar, lower_bound scalar).
    """
    h, w, K = unary.shape
    rho = 0.5 if approach == 0 else 1.0

    # messages arriving at p from each direction
    m_from_l = jnp.zeros((h, w, K))
    m_from_r = jnp.zeros((h, w, K))
    m_from_u = jnp.zeros((h, w, K))
    m_from_d = jnp.zeros((h, w, K))

    cost_l = jnp.swapaxes(_shift(cost_r, 0, -1, fill=0.0), -1, -2)
    cost_u = jnp.swapaxes(_shift(cost_d, -1, 0, fill=0.0), -1, -2)

    def beliefs(msgs):
        m_from_l, m_from_r, m_from_u, m_from_d = msgs
        return unary + rho * (m_from_l + m_from_r + m_from_u + m_from_d)

    def iteration(msgs):
        m_from_l, m_from_r, m_from_u, m_from_d = msgs
        b = beliefs(msgs)

        def send(b_minus, cost):
            # min over sender labels k1 of (b_minus[k1] + cost[k1, k2])
            m = jnp.min(b_minus[..., :, None] + cost, axis=-2)
            return m - jnp.min(m, axis=-1, keepdims=True)

        # message p -> right neighbour: exclude what q sent us
        new_to_r = send(b - rho * m_from_r, cost_r)
        new_to_l = send(b - rho * m_from_l, cost_l)
        new_to_d = send(b - rho * m_from_d, cost_d)
        new_to_u = send(b - rho * m_from_u, cost_u)

        def mix(old, new):
            return damping * old + (1 - damping) * new

        m_from_l = mix(m_from_l, _shift(new_to_r, 0, -1))
        m_from_r = mix(m_from_r, _shift(new_to_l, 0, 1))
        m_from_u = mix(m_from_u, _shift(new_to_d, -1, 0))
        m_from_d = mix(m_from_d, _shift(new_to_u, 1, 0))
        return m_from_l, m_from_r, m_from_u, m_from_d

    def bound(msgs):
        """Chain-decomposition dual (the monotone TRW-S bound contract,
        dense_tracking.cpp:1816-1831 / Kolmogorov PAMI 2006 eq. 13).

        Messages are a reparametrization of the energy for ANY values:
        th_p = theta_p + sum_q m_qp and th_pq = theta_pq - m_qp - m_pq
        leave E(x) unchanged (the effective message here is rho*m — that is
        how beliefs weight them). Splitting every node term equally between
        its row chain and its column chain covers the grid with monotonic
        chains (each edge in exactly one, each node in exactly two); solving
        every chain EXACTLY by min-sum DP and summing the minima is then a
        valid lower bound on the optimum — unlike the previous
        reparametrized-unary-minima proxy, which was not."""
        m_l, m_r, m_u, m_d = msgs
        th = 0.5 * (unary + rho * (m_l + m_r + m_u + m_d))
        e_r = (cost_r[:, :-1]
               - rho * (m_l[:, 1:, None, :] + m_r[:, :-1, :, None]))
        e_d = (cost_d[:-1]
               - rho * (m_u[1:, :, None, :] + m_d[:-1, :, :, None]))

        def chain_step(acc, inp):
            e, t = inp
            return (acc[:, :, None] + e).min(1) + t, None

        # row chains: DP left -> right, vectorized over rows
        acc_r, _ = jax.lax.scan(
            chain_step, th[:, 0],
            (jnp.moveaxis(e_r, 1, 0), jnp.moveaxis(th, 1, 0)[1:]))
        # column chains: DP top -> bottom, vectorized over columns
        acc_d, _ = jax.lax.scan(chain_step, th[0], (e_d, th[1:]))
        return acc_r.min(-1).sum() + acc_d.min(-1).sum()

    msgs0 = (m_from_l, m_from_r, m_from_u, m_from_d)
    if approach == 0:
        # TRW-S stopping semantics (dense_tracking.cpp:660-661 feeding
        # MRFEnergy options): iterate until the lower-bound improvement per
        # iteration falls below acc_trws_eps, capped at acc_trws_max_iter.
        # Synchronous damped updates need one extra guard the sequential
        # library doesn't: the chain dual is piecewise-linear, so it can
        # plateau (delta exactly 0) an iteration or two before the damped
        # messages stop moving — gate on the larger of the bound improvement
        # and the message residual so the loop never exits while the state
        # is still evolving at scale >= eps. The reported bound is the
        # running max of the dual: monotone by construction and valid for
        # any messages (every dual value certifies the optimum from below).
        def w_cond(c):
            msgs, it, best, progress = c
            return (it < iters) & (progress >= eps)

        def w_body(c):
            msgs, it, best, _ = c
            new = iteration(msgs)
            lb = bound(new)
            res = jnp.max(jnp.stack(
                [jnp.max(jnp.abs(n - o)) for n, o in zip(new, msgs)]))
            return (new, it + 1, jnp.maximum(best, lb),
                    jnp.maximum(lb - best, res))

        msgs, _, best_lb, _ = jax.lax.while_loop(
            w_cond, w_body,
            (msgs0, jnp.int32(0), bound(msgs0), jnp.float32(jnp.inf)))
    else:
        # the reference's Minimize_BP runs to m_iterMax regardless of eps
        msgs = jax.lax.fori_loop(0, iters, lambda _, m: iteration(m), msgs0)
        best_lb = bound(msgs)

    b = beliefs(msgs)
    labels = jnp.argmin(b, axis=-1).astype(jnp.int32)

    # energy of the final labeling
    lab1h = jax.nn.one_hot(labels, K)
    e_unary = (unary * lab1h).sum()
    lab_r = _shift(labels[..., None], 0, 1)[..., 0]
    lab_d = _shift(labels[..., None], 1, 0)[..., 0]
    idx_y, idx_x = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    e_r = cost_r[idx_y, idx_x, labels, lab_r]
    e_d = cost_d[idx_y, idx_x, labels, lab_d]
    e_r = jnp.where(idx_x < w - 1, e_r, 0.0).sum()
    e_d = jnp.where(idx_y < h - 1, e_d, 0.0).sum()
    energy = e_unary + e_r + e_d

    return labels, energy, best_lb           # chain-decomposition dual


def pairwise_costs(flows, occl, smooth_weight, beta, spatial_occ, method,
                   xy_incr=1, xy_start=0):
    """Edge cost tensors for solve_multilabel.

    flows [H, W, K, J, 2], occl [H, W, K, J+1], smooth_weight [Ho, Wo] at the
    *original* resolution (sampled at the subsampled grid positions,
    dense_tracking.cpp:1722-1766).
    Returns (cost_r, cost_d) each [H, W, K, K]; invalid entries = BIG.
    """
    from .hypothesis import trajectory_distance

    flows = jnp.asarray(flows)
    occl = jnp.asarray(occl)
    h, w = flows.shape[:2]
    sw = jnp.asarray(smooth_weight)[
        (jnp.arange(h) * xy_incr + xy_start)[:, None],
        (jnp.arange(w) * xy_incr + xy_start)[None, :]]

    def edge_cost(shift_fn, sw_pair):
        fb = shift_fn(flows)
        ob = shift_fn(occl)
        d = trajectory_distance(flows[:, :, :, None], fb[:, :, None], method)
        occ_dis = (occl[:, :, :, None] != ob[:, :, None]).sum(-1)
        return sw_pair[..., None, None] * (beta * d + spatial_occ * occ_dis)

    sw_r = sw + _shift(sw[..., None], 0, 1)[..., 0]
    sw_d = sw + _shift(sw[..., None], 1, 0)[..., 0]
    cost_r = edge_cost(lambda x: _shift(x, 0, 1), sw_r)
    cost_d = edge_cost(lambda x: _shift(x, 1, 0), sw_d)
    return cost_r, cost_d
