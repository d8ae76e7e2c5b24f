"""Generate the reference-parity fixture: a synthetic image pair with an
exact affine ground-truth flow, SED-format edges, DeepMatching-format
matches, and the REAL reference binary's `.flo` outputs.

The reference `epicflow` binary (epic_flow_extended/epicflow.cpp:39-140) is
buildable with only libpng/libjpeg/LAPACK: its Makefile needs none of
GCO/TRWS/OpenCV/MATLAB. This script copies those sources out-of-tree,
builds the binary, runs it on the fixture inputs (LA and NW interpolators,
-sintel preset), and stores the resulting flows as golden files. The
checked-in outputs let tests/test_parity_reference.py assert true parity
(<0.1 px mean EPE per BASELINE.md's north star) without needing the
reference tree or a compiler at test time.

Regenerate deliberately only:
    python tests/parity/make_parity_fixture.py
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
REFERENCE = Path("/root/reference/epic_flow_extended")
BUILD = Path(tempfile.gettempdir()) / "epicflow_oracle_build"

H, W = 96, 128
PAD = 24

# affine warp w(x) = A x + t about the image center: slight rotation+scale
# plus translation; displacements stay within a few pixels.
THETA = 0.02
SCALE = 1.01
TX, TY = 2.0, -1.25


def affine():
    c, s = np.cos(THETA) * SCALE, np.sin(THETA) * SCALE
    A = np.array([[c, -s], [s, c]], np.float64)
    center = np.array([(W - 1) / 2, (H - 1) / 2])
    t = center - A @ center + np.array([TX, TY])
    return A, t


def gt_flow():
    A, t = affine()
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    pts = np.stack([xx, yy], -1)
    warped = pts @ A.T + t
    return (warped - pts).astype(np.float32)


def make_pair():
    rng = np.random.default_rng(11)
    base = rng.random((H + 2 * PAD, W + 2 * PAD, 3)) * 255
    k = np.ones(5) / 5
    for _ in range(2):
        for ax in (0, 1):
            base = np.apply_along_axis(
                lambda r: np.convolve(r, k, "same"), ax, base)
    base = (base - base.min()) / (base.max() - base.min()) * 255

    def sample(xs, ys):
        xs = xs + PAD
        ys = ys + PAD
        x0 = np.floor(xs).astype(int)
        y0 = np.floor(ys).astype(int)
        fx = (xs - x0)[..., None]
        fy = (ys - y0)[..., None]
        return (base[y0, x0] * (1 - fx) * (1 - fy)
                + base[y0, x0 + 1] * fx * (1 - fy)
                + base[y0 + 1, x0] * (1 - fx) * fy
                + base[y0 + 1, x0 + 1] * fx * fy)

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    im1 = sample(xx, yy)
    A, t = affine()
    Ainv = np.linalg.inv(A)
    pts = np.stack([xx, yy], -1)
    src = (pts - t) @ Ainv.T
    im2 = sample(src[..., 0], src[..., 1])
    return np.round(im1).astype(np.uint8), np.round(im2).astype(np.uint8)


def make_edges(im1):
    g = im1.astype(np.float32).mean(-1)
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    gx[:, 1:-1] = 0.5 * (g[:, 2:] - g[:, :-2])
    gy[1:-1] = 0.5 * (g[2:] - g[:-2])
    e = np.hypot(gx, gy)
    return (e / (e.max() + 1e-9)).astype(np.float32)


def make_matches(flow):
    lines = []
    for y in range(4, H - 4, 8):
        for x in range(4, W - 4, 8):
            u, v = flow[y, x]
            x2, y2 = x + u, y + v
            if 0 <= x2 <= W - 1 and 0 <= y2 <= H - 1:
                lines.append(f"{x} {y} {x2:.4f} {y2:.4f} 1.0 100")
    return "\n".join(lines) + "\n"


def build_oracle():
    if (BUILD / "epicflow").exists():
        return BUILD / "epicflow"
    if BUILD.exists():
        shutil.rmtree(BUILD)
    shutil.copytree(REFERENCE, BUILD)
    # epicflow needs none of the multi-frame (OpenCV/ParameterList) sources
    for f in ("variational_mt.cpp", "variational_aux_mt.cpp",
              "variational_mt.h", "variational_aux_mt.h"):
        (BUILD / f).unlink(missing_ok=True)
    mk = (BUILD / "Makefile").read_text()
    mk = mk.replace("-L/usr/lib64/atlas/ -llapack",
                    "-l:liblapack.so.3 -l:libblas.so.3")
    (BUILD / "Makefile").write_text(mk)
    # epic_aux.cpp uses sqrtf without including math.h
    aux = (BUILD / "epic_aux.cpp").read_text()
    if "#include <math.h>" not in aux:
        aux = aux.replace("#include <string.h>",
                          "#include <string.h>\n#include <math.h>", 1)
        (BUILD / "epic_aux.cpp").write_text(aux)
    subprocess.run(["make", "-j4", "epicflow"], cwd=BUILD, check=True,
                   capture_output=True)
    return BUILD / "epicflow"


def main():
    sys.path.insert(0, str(REPO))
    from slowflow_tpu.io.images import write_image

    im1, im2 = make_pair()
    flow = gt_flow()
    write_image(HERE / "im1.png", im1)
    write_image(HERE / "im2.png", im2)
    make_edges(im1).tofile(HERE / "edges.dat")
    (HERE / "matches.txt").write_text(make_matches(flow))
    np.save(HERE / "gt_flow.npy", flow)

    binary = build_oracle()
    for name, extra in (("ref_la_sintel.flo", ["-sintel"]),
                        ("ref_nw_sintel.flo", ["-nw", "-sintel"])):
        subprocess.run(
            [str(binary), str(HERE / "im1.png"), str(HERE / "im2.png"),
             str(HERE / "edges.dat"), str(HERE / "matches.txt"),
             str(HERE / name)] + extra,
            check=True, capture_output=True)
        print("wrote", name)

    from slowflow_tpu.io import read_flo
    for name in ("ref_la_sintel.flo", "ref_nw_sintel.flo"):
        f = read_flo(HERE / name)
        err = np.hypot(*(f - flow).transpose(2, 0, 1)).mean()
        print(f"{name}: reference-vs-GT mean EPE = {err:.4f} px")


if __name__ == "__main__":
    main()
