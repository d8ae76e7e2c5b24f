"""Standalone EpicFlow CLI (epic_flow_extended/epicflow.cpp).

Usage:
    python -m slowflow_tpu.cli.epicflow image1 image2 edges matches out.flo
        [-nw] [-p N] [-n N] [-k F] [-i N] [-a F] [-g F] [-d F] [-s F]
        [-sintel | -kitti | -middlebury]

`edges` is a binary float32 H*W cost file (or "auto" to use the built-in
detector); `matches` is a DeepMatching-style text file (or "auto" for the
built-in grid matcher).
"""
from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np

from ..core.image import rgb_to_lab
from ..epic import EpicParams, epic
from ..epic.edges import detect_edges
from ..epic.matching import grid_matches
from ..io import read_edges, read_matches, write_flo
from ..io.images import read_image
from ..variational import TwoFrameParams, variational_twoframe
from ..utils.compile_cache import enable_compile_cache


def usage():
    print(__doc__)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    if len(argv) < 5:
        usage()
        return 1

    im1 = read_image(argv[0])
    im2 = read_image(argv[1])
    if im1.ndim == 2:
        im1 = np.repeat(im1[..., None], 3, -1)
    if im2.ndim == 2:
        im2 = np.repeat(im2[..., None], 3, -1)
    im1 = np.moveaxis(im1, -1, 0).astype(np.float32)
    im2 = np.moveaxis(im2, -1, 0).astype(np.float32)
    h, w = im1.shape[1:]

    epic_params = EpicParams()
    flow_params = TwoFrameParams()
    i = 5
    while i < len(argv):
        a = argv[i]; i += 1
        def nxt():
            nonlocal i
            v = argv[i]; i += 1
            return v
        if a in ("-h", "-help"):
            usage()
        elif a == "-nw":
            epic_params.method = "NW"
        elif a in ("-p", "-prefnn"):
            epic_params.pref_nn = int(nxt())
        elif a in ("-n", "-nn"):
            epic_params.nn = int(nxt())
        elif a == "-k":
            epic_params.coef_kernel = float(nxt())
        elif a in ("-i", "-iter"):
            flow_params = TwoFrameParams(
                **{**flow_params.__dict__, "niter_outer": int(nxt())})
        elif a in ("-a", "-alpha"):
            flow_params = TwoFrameParams(
                **{**flow_params.__dict__, "alpha": float(nxt())})
        elif a in ("-g", "-gamma"):
            flow_params = TwoFrameParams(
                **{**flow_params.__dict__, "gamma": float(nxt())})
        elif a in ("-d", "-delta"):
            flow_params = TwoFrameParams(
                **{**flow_params.__dict__, "delta": float(nxt())})
        elif a in ("-s", "-sigma"):
            flow_params = TwoFrameParams(
                **{**flow_params.__dict__, "sigma": float(nxt())})
        elif a == "-sintel":
            epic_params = EpicParams.sintel()
            flow_params = TwoFrameParams.sintel()
        elif a == "-kitti":
            epic_params = EpicParams.sintel()
            flow_params = TwoFrameParams.kitti()
        elif a == "-middlebury":
            epic_params = EpicParams(pref_nn=15, nn=65, coef_kernel=0.2)
            flow_params = TwoFrameParams.middlebury()
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            usage()
            return 1

    if argv[2] == "auto":
        edges = np.asarray(detect_edges(jnp.asarray(im1)))
    else:
        edges = read_edges(argv[2], w, h)
    if argv[3] == "auto":
        matches = grid_matches(im1, im2)
    else:
        matches = read_matches(argv[3])

    imlab = np.asarray(rgb_to_lab(jnp.asarray(im1)))
    flow = epic(imlab, matches, edges, epic_params)
    wx, wy = variational_twoframe(
        jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]),
        jnp.asarray(im1), jnp.asarray(im2), flow_params)
    write_flo(argv[4], np.stack([np.asarray(wx), np.asarray(wy)], -1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
