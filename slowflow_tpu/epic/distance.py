"""Geodesic distance transform with closest-seed label propagation.

The reference (`weighted_distance_transform`, epic_aux.cpp:92-179) runs four
sequential diagonal sweeps of the eikonal-style update

  t0 = min(t1, t2) + C                      if |t1 - t2| > C
  t0 = (t1 + t2 + sqrt(2 C^2 - (t1-t2)^2))/2  otherwise

with t1 the already-updated vertical neighbour and t2 the horizontal one.
This version iterates a parallel min-plus relaxation: every pixel considers
all four (vertical, horizontal) quadrant pairs — exactly the union of the four
sweep directions — and takes the minimum, with the closest-seed label carried
along. Iterated to a fixpoint (same fixpoint as the sweeps; the reference's
converged field satisfies the identical local consistency condition).

Seed graph construction (`ngh_labels_to_spmat`, epic_aux.cpp:226-283) and the
per-seed Dijkstra run on the host (slowflow_tpu.native).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..native import knn_graph_all

BIG = 1e18  # stands in for +inf (avoids inf-inf NaNs inside the update)


def _shift_with(x, lab, dy, dx):
    """Shift both distance and label; out-of-range gets (BIG, -1)."""
    pad_y = (max(-dy, 0), max(dy, 0))
    pad_x = (max(-dx, 0), max(dx, 0))
    xs = jnp.pad(x, (pad_y, pad_x), constant_values=BIG)
    ls = jnp.pad(lab, (pad_y, pad_x), constant_values=-1)
    h, w = x.shape
    sl = (slice(pad_y[1], pad_y[1] + h), slice(pad_x[1], pad_x[1] + w))
    return xs[sl], ls[sl]


@partial(jax.jit, static_argnames=("max_iter", "check_every"))
def distance_transform(cost, seed_dist, seed_labels, max_iter: int = 256,
                       min_change: float = 1.0, check_every: int = 8):
    """Parallel geodesic DT.

    cost:        [H, W] per-pixel traversal cost
    seed_dist:   [H, W] initial distances (cost at seeds, BIG elsewhere)
    seed_labels: [H, W] int32 initial labels (seed index at seeds, -1 elsewhere)

    Returns (dmap, labels).
    """
    def one_iter(dmap, labels):
        tv_a, lv_a = _shift_with(dmap, labels, -1, 0)  # north
        tv_b, lv_b = _shift_with(dmap, labels, 1, 0)   # south
        th_a, lh_a = _shift_with(dmap, labels, 0, -1)  # west
        th_b, lh_b = _shift_with(dmap, labels, 0, 1)   # east

        # The eikonal update t0(tv, th) is monotone non-decreasing in both
        # arguments (d t0/d tv = (1 - (tv-th)/sqrt(2C^2-(tv-th)^2))/2 >= 0 on
        # the non-degenerate branch since sqrt(...) >= C >= |tv-th|, and the
        # degenerate branch is min+C), so the minimum over the four
        # (vertical, horizontal) quadrant pairs equals ONE update applied to
        # the per-axis minima — 4x fewer quadrant evaluations per iteration.
        tv = jnp.minimum(tv_a, tv_b)
        lv = jnp.where(tv_a < tv_b, lv_a, lv_b)
        th = jnp.minimum(th_a, th_b)
        lh = jnp.where(th_a < th_b, lh_a, lh_b)

        dt12 = jnp.abs(tv - th)
        tmin = jnp.minimum(tv, th)
        lmin = jnp.where(tv < th, lv, lh)
        degenerate = dt12 > cost
        t_quad = jnp.sqrt(jnp.maximum(2 * cost * cost - dt12 * dt12, 0.0))
        t0 = jnp.where(degenerate, tmin + cost, 0.5 * (tv + th + t_quad))
        t0 = jnp.minimum(t0, BIG)
        upd = t0 < dmap
        best_t = jnp.where(upd, t0, dmap)
        best_l = jnp.where(upd, lmin, labels)
        return best_t, best_l

    def block(carry):
        dmap, labels, it, change = carry
        prev = dmap

        def inner(_, c):
            return one_iter(*c)

        dmap, labels = jax.lax.fori_loop(0, check_every, inner, (dmap, labels))
        change = jnp.max(jnp.where(dmap < prev,
                                   jnp.minimum(prev - dmap, 1e9), 0.0))
        return dmap, labels, it + check_every, change

    def cond(carry):
        _, _, it, change = carry
        return (it < max_iter) & (change > 0.0)

    dmap, labels, _, _ = jax.lax.while_loop(
        cond, block, (seed_dist, seed_labels, jnp.int32(0),
                      jnp.float32(jnp.inf)))
    return dmap, labels


def seed_graph(labels: np.ndarray, dmap: np.ndarray, ns: int):
    """Seed-adjacency CSR graph from label borders (ngh_labels_to_spmat).

    Edge weight between labels l0/l1 = min over their border pixels of
    d[p] + d[q]. Returns (indptr, indices, data) of the symmetric CSR.
    """
    labels = np.asarray(labels)
    dmap = np.asarray(dmap, np.float64)
    pairs = []
    costs = []
    # horizontal borders
    l0 = labels[:, 1:]; l1 = labels[:, :-1]
    m = l0 != l1
    if m.any():
        pairs.append(np.stack([l0[m], l1[m]], 1))
        costs.append((dmap[:, 1:][m] + dmap[:, :-1][m]))
    # vertical borders
    l0 = labels[1:, :]; l1 = labels[:-1, :]
    m = l0 != l1
    if m.any():
        pairs.append(np.stack([l0[m], l1[m]], 1))
        costs.append((dmap[1:, :][m] + dmap[:-1, :][m]))

    if not pairs:
        indptr = np.zeros(ns + 1, np.int32)
        return indptr, np.zeros(0, np.int32), np.zeros(0, np.float32)

    pairs = np.concatenate(pairs, 0)
    costs = np.concatenate(costs, 0)
    valid = (pairs >= 0).all(1)
    pairs = pairs[valid]
    costs = costs[valid]
    lo = pairs.min(1).astype(np.int64)
    hi = pairs.max(1).astype(np.int64)
    key = lo * ns + hi
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    cost_s = costs[order]
    uniq_key, start = np.unique(key_s, return_index=True)
    min_cost = np.minimum.reduceat(cost_s, start)
    lo_u = (uniq_key // ns).astype(np.int32)
    hi_u = (uniq_key % ns).astype(np.int32)

    rows = np.concatenate([lo_u, hi_u])
    cols = np.concatenate([hi_u, lo_u])
    vals = np.concatenate([min_cost, min_cost]).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(ns + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, cols.astype(np.int32), vals


def _dt_batched(cost, seed_dist, seed_labels, max_iter: int, _cache={}):
    """vmapped distance transform: one dispatch for a batch of images (the
    convergence check runs until the slowest item settles)."""
    if max_iter not in _cache:
        _cache[max_iter] = jax.jit(
            jax.vmap(partial(distance_transform, max_iter=max_iter)))
    return _cache[max_iter](cost, seed_dist, seed_labels)


def dist_trf_nnfield_batched(seeds_list, cost_list, nn_list,
                             max_iter: int = 256):
    """Batched closest-seeds: B independent (seeds, cost) problems solved by
    ONE device dispatch + ONE fetch (per-jet EPIC inits were paying two
    host round trips per DT).

    Returns a list of (best [ns, nn], dist [ns, nn], labels, dmap) tuples.
    """
    B = len(seeds_list)
    h, w = np.asarray(cost_list[0]).shape
    sd = np.full((B, h, w), BIG, np.float32)
    sl = np.full((B, h, w), -1, np.int32)
    sxs, sys = [], []
    for b, seeds in enumerate(seeds_list):
        cost_b = np.asarray(cost_list[b])
        sx = np.clip(seeds[:, 0].astype(np.int64), 0, w - 1)
        sy = np.clip(seeds[:, 1].astype(np.int64), 0, h - 1)
        # later seeds win on collisions (reference loop order,
        # epic_aux.cpp:304-308)
        sd[b][sy, sx] = cost_b[sy, sx]
        sl[b][sy, sx] = np.arange(len(seeds), dtype=np.int32)
        sxs.append(sx)
        sys.append(sy)

    from ..utils.phases import phase

    with phase("epic.dt_device"):
        cost_stack = jnp.asarray(np.stack([np.asarray(c, np.float32)
                                           for c in cost_list]))
        dmaps, labels = _dt_batched(cost_stack, jnp.asarray(sd),
                                    jnp.asarray(sl), max_iter)
        both = np.asarray(jnp.concatenate(
            [dmaps[:, None], labels.astype(jnp.float32)[:, None]], 1))
    out = []
    for b in range(B):
        dmap = both[b, 0]
        lab = both[b, 1].astype(np.int32)
        ns = len(seeds_list[b])
        with phase("epic.seed_graph"):
            indptr, indices, data = seed_graph(lab, dmap, ns)
        with phase("epic.dijkstra"):
            nnf, dis = knn_graph_all(indptr, indices, data, nn_list[b])
        d_at_seed = dmap[sys[b], sxs[b]]
        lab_at_seed = lab[sys[b], sxs[b]]
        best = nnf[lab_at_seed]
        dist = d_at_seed[:, None] + dis[lab_at_seed]
        out.append((best, dist, lab, dmap))
    return out


def dist_trf_nnfield(seeds: np.ndarray, cost: np.ndarray, nn: int,
                     max_iter: int = 256):
    """Closest seeds by geodesic distance (dist_trf_nnfield_subset,
    epic_aux.cpp:328-375) with queries = the seeds themselves.

    seeds: [ns, 2] int (x, y); cost: [H, W] float32.
    Returns (best [ns, nn], dist [ns, nn], labels [H, W], dmap [H, W]).
    """
    return dist_trf_nnfield_batched([seeds], [cost], [nn], max_iter)[0]
