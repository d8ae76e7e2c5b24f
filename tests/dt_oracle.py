"""Test-only oracle: sequential Gauss-Seidel sweep geodesic distance
transform.

This reproduces the reference's sweep-ordered DT semantics (the four
diagonal raster sweeps with the quasi-eikonal two-neighbour update,
epic_aux.cpp:92-179) so the parallel min-plus fixpoint implementation in
slowflow_tpu/epic/distance.py can be validated against the sequential
algorithm's converged field. It is quarantined here: nothing in the
production package uses it.
"""
import numpy as np

# sweep directions (x-step, y-step), indexed by sweep number % 4 with the
# first sweep being number 1 — visit order (1,1), (1,-1), (-1,-1), (-1,1)
_DIRS = ((-1, 1), (1, 1), (1, -1), (-1, -1))


def _one_sweep(cost, dmap, labels, sx, sy):
    """One raster sweep; returns the largest distance drop."""
    ty, tx = cost.shape
    rows = range(ty) if sy > 0 else range(ty - 1, -1, -1)
    cols = range(tx) if sx > 0 else range(tx - 1, -1, -1)
    first_row = rows[0] if sy > 0 else rows[0]
    first_col = cols[0]
    biggest = 0.0
    for j in rows:
        for x in cols:
            if j == first_row:
                up_d, up_l = np.inf, -1
            else:
                up_d, up_l = dmap[j - sy, x], labels[j - sy, x]
            if x == first_col:
                lf_d, lf_l = np.inf, -1
            else:
                lf_d, lf_l = dmap[j, x - sx], labels[j, x - sx]

            c = cost[j, x]
            gap = abs(up_d - lf_d) if (np.isfinite(up_d)
                                       or np.isfinite(lf_d)) else np.inf
            if gap > c:
                # one-sided update from the nearer causal neighbour
                cand = min(up_d, lf_d) + c
            else:
                # both neighbours inside the characteristic cone
                cand = 0.5 * (up_d + lf_d + np.sqrt(2 * c * c - gap * gap))
            if cand < dmap[j, x]:
                biggest = max(biggest, dmap[j, x] - cand)
                dmap[j, x] = cand
                labels[j, x] = up_l if up_d < lf_d else lf_l
    return biggest


def dt_sweeps_oracle(cost, dmap, labels, max_iter=40, min_change=1.0):
    """Sweep the four diagonal directions until a change-free turn.

    Termination mirrors the reference: at least one full turn (4 sweeps)
    runs; after any sweep whose largest drop exceeds `min_change`, three more
    sweeps are scheduled (capped at `max_iter` total). Returns the updated
    (dmap, labels) copies.
    """
    cost = np.ascontiguousarray(cost, np.float32)
    dmap = np.array(dmap, np.float32, copy=True)
    labels = np.array(labels, np.int32, copy=True)
    sweeps_to_run = 4
    i = 0
    while i < sweeps_to_run:
        i += 1
        sx, sy = _DIRS[i % 4]
        drop = _one_sweep(cost, dmap, labels, sx, sy)
        if drop > min_change:
            sweeps_to_run = min(max_iter, i + 3)
    return dmap, labels
