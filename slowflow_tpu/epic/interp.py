"""Edge-preserving interpolation of correspondences (EpicFlow, L4).

Re-implementation of epic_flow_extended/epic.cpp + the fitting kernels of
epic_aux.cpp. Pipeline (epic.cpp:147-234):
  1. rectify matches into the image area
  2. add constant `euc` to the edge cost map
  3. saliency filter (min-eigenvalue structure tensor threshold)
  4. consistency prefilter: Nadaraya-Watson estimate over pref_nn geodesic
     neighbours, drop matches deviating more than pref_th
  5. geodesic k-NN of every seed (device distance transform + host Dijkstra)
  6. fit Nadaraya-Watson or locally-weighted affine models per seed
     (batched lstsq replacing LAPACK sgels_, epic_aux.cpp:430-472)
  7. apply to all pixels via the closest-seed label map
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.image import saliency as saliency_fn
from .distance import dist_trf_nnfield


@dataclass
class EpicParams:
    """epic_params_t defaults (epic.cpp:127-136)."""

    method: str = "LA"          # "LA" or "NW"
    saliency_th: float = 0.045
    pref_nn: int = 25
    pref_th: float = 5.0
    nn: int = 100
    coef_kernel: float = 0.8
    euc: float = 0.001
    verbose: int = 0

    @classmethod
    def sintel(cls):
        """Preset used throughout the pipeline (slow_flow.cpp:268-272)."""
        return cls(pref_nn=25, nn=160, coef_kernel=1.1)


def fit_nadarayawatson(nnf, dis, vects):
    """Weighted-mean flow per seed (epic_aux.cpp:386-403).
    nnf [ns, k] indices (-1 = invalid), dis [ns, k] kernelized weights."""
    valid = nnf >= 0
    idx = np.where(valid, nnf, 0)
    w = np.where(valid, dis, 0.0)
    v = vects[idx]                       # [ns, k, 2]
    s = w.sum(1, keepdims=True)
    s = np.where(s == 0, 1.0, s)
    return (w[..., None] * v).sum(1) / s


def fit_localaffine(nnf, dis, seeds, vects):
    """Locally-weighted affine model per seed (epic_aux.cpp:430-472).

    For each seed i, solve the weighted least-squares system mapping neighbour
    seed positions to their targets; 4 low-weight stabilizer points around the
    seed guarantee non-degeneracy. Unknowns [a00, a01, tx, a10, a11, ty].
    Returns [ns, 6].

    The weighted normal equations are accumulated as closed-form moments
    (AtA entries = sums of C^2 * {X^2, XY, X, Y^2, Y, 1}; the 4 stabilizer
    rows enter analytically) with float64 einsum reductions over float32
    products. The earlier stacked-row formulation ([ns, k+4, 3] float64
    temporaries) moved ~300 MB per call and dominated the dense-tracking
    EPIC stage on the single-core host; this form is ~20x cheaper and
    identical up to summation order.
    """
    ns, k = nnf.shape
    valid = nnf >= 0
    idx = np.where(valid, nnf, 0)
    coef = np.where(valid, dis, 0.0).astype(np.float32)      # [ns, k]

    sx = seeds[:, 0].astype(np.float32)
    sy = seeds[:, 1].astype(np.float32)
    px = sx[idx]                                             # [ns, k]
    py = sy[idx]
    u = vects[idx][..., 0].astype(np.float32)
    v = vects[idx][..., 1].astype(np.float32)

    # self-neighbour reweighting (epic_aux.cpp:442)
    is_self = idx == np.arange(ns)[:, None]
    coefi = np.where(is_self, 0.01 * coef, 0.0) \
        .sum(1, dtype=np.float64).astype(np.float32)         # [ns]
    coef = np.where(is_self, coef * np.float32(0.96), coef)

    def mom(P, Q):
        """sum_m P*Q per seed, accumulated in float64."""
        return np.einsum("nm,nm->n", P, Q, dtype=np.float64)

    P = coef * coef                                          # [ns, k]
    bx = px + u                                              # row targets
    by = py + v
    Sxx = mom(P, px * px)
    Sxy = mom(P, px * py)
    Sx = mom(P, px)
    Syy = mom(P, py * py)
    Sy = mom(P, py)
    S0 = P.sum(1, dtype=np.float64)
    Bx = np.stack([mom(P, px * bx), mom(P, py * bx), mom(P, bx)], -1)
    By = np.stack([mom(P, px * by), mom(P, py * by), mom(P, by)], -1)

    # stabilizer points at (sx +- 0.1, sy) / (sx, sy +- 0.1), weight coefi,
    # targets = the seed's own vector
    sx64 = sx.astype(np.float64)
    sy64 = sy.astype(np.float64)
    Pi = coefi.astype(np.float64) ** 2
    d2 = 2 * 0.1 * 0.1
    tx = sx64 + vects[:, 0].astype(np.float64)               # stabilizer bx
    ty = sy64 + vects[:, 1].astype(np.float64)
    Sxx += Pi * (4 * sx64 * sx64 + d2)
    Sxy += Pi * 4 * sx64 * sy64
    Sx += Pi * 4 * sx64
    Syy += Pi * (4 * sy64 * sy64 + d2)
    Sy += Pi * 4 * sy64
    S0 += Pi * 4
    Bx += Pi[:, None] * np.stack(
        [4 * sx64 * tx + d2, 4 * sy64 * tx, 4 * tx], -1)
    By += Pi[:, None] * np.stack(
        [4 * sx64 * ty, 4 * sy64 * ty + d2, 4 * ty], -1)

    AtA = np.empty((ns, 3, 3), np.float64)
    AtA[:, 0, 0] = Sxx; AtA[:, 0, 1] = Sxy; AtA[:, 0, 2] = Sx
    AtA[:, 1, 0] = Sxy; AtA[:, 1, 1] = Syy; AtA[:, 1, 2] = Sy
    AtA[:, 2, 0] = Sx;  AtA[:, 2, 1] = Sy;  AtA[:, 2, 2] = S0
    AtA = AtA + 1e-9 * np.eye(3)
    Atbx = Bx
    Atby = By
    try:
        solx = np.linalg.solve(AtA, Atbx[..., None])[..., 0]
        soly = np.linalg.solve(AtA, Atby[..., None])[..., 0]
    except np.linalg.LinAlgError:
        solx = np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                         for a, b in zip(AtA, Atbx)])
        soly = np.stack([np.linalg.lstsq(a, b, rcond=None)[0]
                         for a, b in zip(AtA, Atby)])
    # [a00, a01, tx, a10, a11, ty]
    return np.concatenate([solx, soly], axis=1).astype(np.float32)


def apply_nadarayawatson(seed_vects, labels):
    """Per-pixel flow = flow of closest seed (epic_aux.cpp:410-419)."""
    lab = np.clip(labels, 0, None)
    out = seed_vects[lab]
    out[labels < 0] = 0.0
    return out


def apply_localaffine(affine, labels, h, w):
    """Per-pixel flow from the closest seed's affine model
    (epic_aux.cpp:479-492): u = a00*x + a01*y + tx - x."""
    lab = np.clip(labels, 0, None)
    m = affine[lab]                                          # [H, W, 6]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u = m[..., 0] * xx + m[..., 1] * yy + m[..., 2] - xx
    v = m[..., 3] * xx + m[..., 4] * yy + m[..., 5] - yy
    u[labels < 0] = 0.0
    v[labels < 0] = 0.0
    return np.stack([u, v], axis=-1)


def _kernelize(dis, coef_kernel):
    """exp(-coef*d) + 1e-8 (epic.cpp:190-195); invalid (+inf) -> 0."""
    with np.errstate(over="ignore"):
        k = np.exp(-coef_kernel * np.where(np.isfinite(dis), dis, np.inf))
    return np.where(np.isfinite(dis), k + 1e-8, 0.0)


def epic(imlab, matches, edges, params: EpicParams = EpicParams(),
         max_iter_dt: int = 256, saliency_map=None):
    """Sparse-to-dense interpolation.

    imlab:   [3, H, W] Lab image (rgb_to_lab output)
    matches: [N, 4] (x1, y1, x2, y2)
    edges:   [H, W] edge cost map (modified in the reference; copied here)
    saliency_map: optional precomputed saliency (batched callers compute it
        for all frames in one dispatch instead of one per epic call)
    Returns flow [H, W, 2] float32.
    """
    return epic_batched([(imlab, matches, edges, saliency_map)], params,
                        max_iter_dt)[0]


def epic_batched(jobs, params: EpicParams = EpicParams(),
                 max_iter_dt: int = 256):
    """EPIC interpolation for a batch of independent problems.

    jobs: list of (imlab, matches, edges, saliency_map-or-None). The two
    geodesic distance transforms (consistency prefilter + interpolation
    k-NN) run as ONE batched device dispatch each across the whole batch —
    the jet-group equivalent of the per-jet `epic()` calls the reference
    makes under OpenMP (slow_flow.cpp:819); host fits stay per job.
    Returns a list of flow [H, W, 2] float32 arrays.
    """
    import jax.numpy as jnp

    from ..utils.phases import phase
    from .distance import dist_trf_nnfield_batched

    B = len(jobs)
    state = []
    for imlab, matches, edges, saliency_map in jobs:
        imlab = np.asarray(imlab, np.float32)
        _, h, w = imlab.shape
        matches = np.asarray(matches, np.float32).reshape(-1, 4).copy()
        edges = np.asarray(edges, np.float32).copy()

        # 1. rectify (epic.cpp:15-28)
        matches[:, 0] = np.clip(matches[:, 0], 0, w - 1)
        matches[:, 1] = np.clip(matches[:, 1], 0, h - 1)
        matches[:, 2] = np.clip(matches[:, 2], 0, w - 1)
        matches[:, 3] = np.clip(matches[:, 3], 0, h - 1)

        # 2. edge cost offset
        if params.euc:
            edges = edges + params.euc

        # 3. saliency filter
        if params.saliency_th and len(matches):
            s = np.asarray(saliency_fn(jnp.asarray(imlab), 0.8, 1.0)) \
                if saliency_map is None else np.asarray(saliency_map)
            keep = s[matches[:, 1].astype(int), matches[:, 0].astype(int)] \
                >= params.saliency_th
            matches = matches[keep]
        state.append(dict(matches=matches, edges=edges, hw=(h, w)))

    # 4. consistency prefilter (one batched DT over eligible jobs)
    if params.pref_nn:
        idx = [b for b in range(B) if len(state[b]["matches"]) > 1]
        if idx:
            with phase("epic.prefilter_dt"):
                res = dist_trf_nnfield_batched(
                    [state[b]["matches"][:, :2].astype(np.int32)
                     for b in idx],
                    [state[b]["edges"] for b in idx],
                    [min(params.pref_nn + 1, len(state[b]["matches"]))
                     for b in idx], max_iter_dt)
            with phase("epic.prefilter_fit"):
                for b, (nnf, dis, _, _) in zip(idx, res):
                    m = state[b]["matches"]
                    vects = m[:, 2:4] - m[:, :2]
                    disk = _kernelize(dis, params.coef_kernel)
                    est = fit_nadarayawatson(nnf, disk, vects)
                    keep = ((est - vects) ** 2).sum(1) < params.pref_th ** 2
                    state[b]["matches"] = m[keep]

    # 5. geodesic k-NN for the interpolation (one batched DT)
    flows = [None] * B
    idx = [b for b in range(B) if len(state[b]["matches"])]
    for b in range(B):
        if b not in idx:
            h, w = state[b]["hw"]
            flows[b] = np.zeros((h, w, 2), np.float32)
    if idx:
        with phase("epic.main_dt"):
            res = dist_trf_nnfield_batched(
                [state[b]["matches"][:, :2].astype(np.int32) for b in idx],
                [state[b]["edges"] for b in idx],
                [min(params.nn, len(state[b]["matches"])) for b in idx],
                max_iter_dt)
        for b, (nnf, dis, labels, _) in zip(idx, res):
            m = state[b]["matches"]
            h, w = state[b]["hw"]
            seeds = m[:, :2].astype(np.int32)
            vects = m[:, 2:4] - m[:, :2]
            with phase("epic.kernelize"):
                disk = _kernelize(dis, params.coef_kernel)

            # 6-7. fit + apply
            if params.method.upper() == "LA":
                with phase("epic.fit_la"):
                    affine = fit_localaffine(nnf, disk,
                                             seeds.astype(np.float32),
                                             vects)
                with phase("epic.apply_la"):
                    flow = apply_localaffine(affine, labels, h, w)
            elif params.method.upper() == "NW":
                sv = fit_nadarayawatson(nnf, disk, vects)
                flow = apply_nadarayawatson(sv.astype(np.float32), labels)
            else:
                raise ValueError(
                    f"unknown interpolation method {params.method}")
            flows[b] = flow.astype(np.float32)
    return flows
