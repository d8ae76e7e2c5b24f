"""Regenerate the golden numerical snapshots in tests/golden/.

Run from the repo root with the CPU test env (the same env the tests use):

    ./run_tests.sh --collect-only -q >/dev/null  # warm nothing; or simply:
    JAX_PLATFORMS=cpu python tests/golden/make_goldens.py

Goldens pin the numerics of the hot paths (multi-frame solve, EPIC
interpolation, distance transform, MRF selection, accumulation) against
refactors in later rounds. Tolerances in test_golden.py absorb benign
fusion-order drift; re-run this script ONLY for an intentional numerical
change, and say so in the commit message.
"""
import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp

from slowflow_tpu.variational import MultiFrameParams, variational_mt
from slowflow_tpu.epic.distance import distance_transform
from slowflow_tpu.epic.interp import EpicParams, epic
from slowflow_tpu.tracking.mrf import solve_multilabel
from slowflow_tpu.tracking.accumulate import accumulate_flow


def window(h, w, dx, dy, S, seed=11):
    ref = S - 1
    rng = np.random.default_rng(seed)
    base = rng.random((h + 40, w + 40)).astype(np.float32) * 255
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    frames = []
    for s in range(-ref, ref + 1):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        xs = np.clip(xx + 20 - s * dx, 0, w + 39)
        ys = np.clip(yy + 20 - s * dy, 0, h + 39)
        x0 = np.floor(xs).astype(int); y0 = np.floor(ys).astype(int)
        fx = xs - x0; fy = ys - y0
        x1 = np.clip(x0 + 1, 0, w + 39); y1 = np.clip(y0 + 1, 0, h + 39)
        im = (base[y0, x0] * (1 - fx) * (1 - fy) + base[y0, x1] * fx * (1 - fy)
              + base[y1, x0] * (1 - fx) * fy + base[y1, x1] * fx * fy)
        frames.append(np.repeat(im[None], 3, axis=0))
    return np.stack(frames).astype(np.float32)


def golden_variational():
    h, w, S = 40, 48, 3
    seq = window(h, w, 1.2, -0.6, S)
    p = MultiFrameParams(S=S, rho=(1.0, 1.0), omega=(0.0, 2.0), layers=2,
                         p_scale=0.7, niter_alter=2, niter_outer=4,
                         niter_solver=20, occlusion_reasoning=True,
                         smoothing=1)
    wx, wy, occ = variational_mt(jnp.zeros((h, w)), jnp.zeros((h, w)), seq, p)
    return {"vmt_wx": np.asarray(wx), "vmt_wy": np.asarray(wy),
            "vmt_occ": np.asarray(occ)}


def golden_distance_transform():
    rng = np.random.default_rng(4)
    h, w = 40, 44
    cost = rng.random((h, w)).astype(np.float32) + 0.05
    seed_dist = np.full((h, w), 1e9, np.float32)
    seed_labels = np.full((h, w), -1, np.int32)
    idx = 0
    for y in range(0, h, 9):
        for x in range(0, w, 11):
            seed_dist[y, x] = cost[y, x]
            seed_labels[y, x] = idx
            idx += 1
    dist, labels = distance_transform(jnp.asarray(cost),
                                      jnp.asarray(seed_dist),
                                      jnp.asarray(seed_labels))
    return {"dt_dist": np.asarray(dist), "dt_labels": np.asarray(labels)}


def golden_epic():
    from slowflow_tpu.core.image import rgb_to_lab
    rng = np.random.default_rng(5)
    h, w = 48, 56
    img = np.zeros((3, h, w), np.float32)
    img[0] = np.linspace(0, 255, w)[None, :]
    img[1] = np.linspace(0, 255, h)[:, None]
    img[2] = 128.0
    imlab = np.asarray(rgb_to_lab(jnp.asarray(img)))
    edges = np.zeros((h, w), np.float32)
    edges[:, w // 2] = 1.0          # vertical motion boundary
    n = 60
    mx = rng.integers(2, w - 2, n).astype(np.float32)
    my = rng.integers(2, h - 2, n).astype(np.float32)
    u = np.where(mx < w // 2, 2.0, -1.0).astype(np.float32)
    v = np.where(mx < w // 2, 0.5, 1.0).astype(np.float32)
    matches = np.stack([mx, my, mx + u, my + v], 1)
    p = EpicParams(pref_nn=10, nn=20, coef_kernel=0.8)
    flow = epic(imlab, matches, edges, p)
    return {"epic_flow": np.asarray(flow)}


def golden_mrf():
    rng = np.random.default_rng(6)
    h, w, K = 16, 18, 4
    unary = rng.random((h, w, K)).astype(np.float32) * 3
    cost_r = np.broadcast_to(
        0.7 * (1 - np.eye(K, dtype=np.float32)), (h, w, K, K)).copy()
    cost_d = cost_r.copy()
    out = {}
    for name, approach in (("mrf_labels", 0), ("mrf_labels_bp", 1)):
        labels, energy, lb = solve_multilabel(
            jnp.asarray(unary), jnp.asarray(cost_r), jnp.asarray(cost_d),
            iters=20, approach=approach)
        out[name] = np.asarray(labels)
        out[name + "_energy"] = np.float32(energy)
    return out


def golden_accumulate():
    rng = np.random.default_rng(7)
    h, w, n = 24, 28, 4
    flows = (rng.normal(size=(n, h, w, 2)).astype(np.float32) * 0.2
             + np.array([1.0, 0.5], np.float32))
    occ = np.zeros((n, h, w), np.uint8)
    occ[2, 4:8, 4:8] = 1
    acc = accumulate_flow(flows, occ)
    return {"acc_flow": np.asarray(acc)}


def main():
    out = {}
    for fn in (golden_variational, golden_distance_transform, golden_epic,
               golden_mrf, golden_accumulate):
        out.update(fn())
        print(f"{fn.__name__}: ok")
    path = pathlib.Path(__file__).parent / "goldens.npz"
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
