"""adaptiveFR CLI — stage 1: flow-magnitude quantile for adaptive frame rates.

Mirrors the reference binary's contract (adaptiveFR.cpp):

    python -m slowflow_tpu.cli.adaptive_fr -path P -folder F [-format FMT]
        [-scale S] [-skip K] [-samples N] [-step M] [-start F0] [-quantil Q]
        [-raw] [-overwrite] [-sintel] [-subframes] [-threads N] [-append FILE]

Samples N low-resolution two-frame EpicFlow estimates across the sequence,
computes the q-quantile of the flow magnitude distribution (normalized back to
the recorded resolution and frame rate), and writes `quantil.dat` +
`results.info` into the sequence folder for slow_flow to pick up.

Array redesign: samples are independent — the low-res two-frame estimations run
as one batched (vmap) dispatch instead of the reference's OpenMP folder loop.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..config import ParameterList
from ..core.image import rgb_to_lab
from ..epic import EpicParams, epic
from ..epic.edges import detect_edges
from ..epic.matching import grid_matches
from ..io import read_flo, write_flo, read_edges, read_matches
from ..utils.colorwheel import flow_color_img
from ..io.images import write_image
from ..variational import TwoFrameParams, variational_twoframe
from .common import frame_path, load_frame
from ..utils.compile_cache import enable_compile_cache


def estimate_pair(im1: np.ndarray, im2: np.ndarray,
                  epic_params: EpicParams, flow_params: TwoFrameParams,
                  edges: np.ndarray | None = None,
                  matches: np.ndarray | None = None) -> np.ndarray:
    """One low-res EpicFlow estimate: matches -> epic -> variational.
    im1/im2 are [3, H, W] 8-bit-range. Returns flow [H, W, 2]."""
    import jax.numpy as jnp

    if edges is None:
        edges = np.asarray(detect_edges(jnp.asarray(im1)))
    if matches is None:
        matches = grid_matches(im1, im2)
    imlab = np.asarray(rgb_to_lab(jnp.asarray(im1)))
    init = epic(imlab, matches, edges, epic_params)
    wx, wy = variational_twoframe(
        jnp.asarray(init[..., 0]), jnp.asarray(init[..., 1]),
        jnp.asarray(im1), jnp.asarray(im2), flow_params)
    return np.stack([np.asarray(wx), np.asarray(wy)], -1)


def quantile_of_magnitudes(flows, q):
    """q-quantile with the reference's index convention
    (adaptiveFR.cpp:644-668)."""
    mags = np.concatenate([np.hypot(f[..., 0], f[..., 1]).ravel()
                           for f in flows])
    mags.sort()
    np_idx = q * mags.size - 1
    if np_idx < mags.size - 1 and np_idx % 2.0 == 0:
        quantil = 0.5 * (mags[int(np_idx)] + mags[int(np_idx) + 1])
    else:
        quantil = mags[int(np.ceil(np_idx))]
    return float(quantil), float(mags[-1])


def run_folder(path, folder, fmt="%07i.tif", scale=0.25, skip=2, samples=40,
               sample_step=10, start=0, q=0.90, raw=False, sintel=False,
               subframes=False, overwrite=False, append="") -> float:
    params = ParameterList()
    params.insert("verbose", "0", True)
    params.insert("scale", "1.0", True)
    if raw:
        params.insert("raw", "1", True)
        params.insert("raw_demosaicing", "2", True)
    params.file = os.path.join(path, folder) + "/"
    params.Jets = 1

    seq_path = params.file
    output = os.path.join(seq_path, "adaptiveFR") + "/"
    os.makedirs(output, exist_ok=True)
    os.makedirs(output + "tmp/", exist_ok=True)
    os.makedirs(output + "sequence/", exist_ok=True)

    fmt_flow = os.path.splitext(fmt)[0]
    if sintel and not subframes:
        start = start * 1000
    params.sequence_start = start
    red_loc = params.split_parameter("raw_red_loc", "1,0")

    # sintel epic-flow presets (adaptiveFR.cpp:291-302)
    epic_params = EpicParams.sintel()
    flow_params = TwoFrameParams.sintel()

    t_all = time.time()

    # ------------------------------------------------------- gather samples
    records = []            # (seq_start, flo_file, imgs-or-None)
    seq_start = start
    for it in range(samples):
        if it > 0:
            seq_start += params.Jets * sample_step
        params.sequence_start = seq_start

        if not sintel:
            flo_file = os.path.join(output, fmt_flow % seq_start + ".flo")
        else:
            flo_file = os.path.join(output, fmt_flow % (seq_start // 1000,
                                                        seq_start % 1000)
                                    + ".flo")

        imgs = None
        if overwrite or not os.path.exists(flo_file):
            # read the two frames (8-bit working range, adaptiveFR.cpp:453)
            imgs = []
            for f in range(2):
                p = frame_path(seq_path, fmt, seq_start, f * skip, sintel)
                if not os.path.exists(p):
                    print(f"Could not find {p}!", file=sys.stderr)
                    imgs = None
                    break
                img = load_frame(p, params, scale, red_loc)
                if img.max() > 255.0:
                    img = img / 255.0   # 16-bit -> 8-bit (adaptiveFR.cpp:453)
                imgs.append(np.clip(img, 0, 255))
            if imgs is None:
                continue
        records.append((seq_start, flo_file, imgs))

    # ------------------------------------------- batched estimation (1 pass)
    # EPIC inits run per sample on the host (ingesting SED/DeepMatching
    # files when present); the N variational refinements are ONE vmapped
    # device dispatch — the replacement for OpenMP-over-folders
    # (adaptiveFR.cpp:245).
    todo = [r for r in records if r[2] is not None]
    t_est = time.time()
    refined = {}
    if todo:
        import jax
        import jax.numpy as jnp

        from ..epic import epic_batched
        from ..epic.matching import grid_matches_batched
        from ..variational.twoframe import variational_twoframe_batched

        # per-sample Lab + edges in one batched dispatch each
        im1s = np.stack([r[2][0] for r in todo])
        lab_all = np.asarray(jax.jit(jax.vmap(rgb_to_lab))(
            jnp.asarray(im1s, jnp.float32)))
        edges_all = np.asarray(jax.jit(jax.vmap(detect_edges))(
            jnp.asarray(im1s, jnp.float32)))

        jobs = []
        match_missing = []
        matches_by_i = {}
        for i, (seq_start_i, _, imgs) in enumerate(todo):
            match_f = (output
                       + f"tmp/matches_{seq_start_i}_{seq_start_i + skip}.dat")
            if os.path.exists(match_f):
                matches_by_i[i] = read_matches(match_f)
            else:
                match_missing.append(i)
        if match_missing:
            res = grid_matches_batched(
                np.stack([todo[i][2][0] for i in match_missing]),
                np.stack([todo[i][2][1] for i in match_missing]))
            for i, m in zip(match_missing, res):
                matches_by_i[i] = m
        for i, (seq_start_i, _, imgs) in enumerate(todo):
            edges_f = output + f"tmp/edges_{seq_start_i}.dat"
            edges = read_edges(edges_f, imgs[0].shape[2], imgs[0].shape[1]) \
                if os.path.exists(edges_f) else edges_all[i]
            jobs.append((lab_all[i], matches_by_i[i], edges, None))
        inits = epic_batched(jobs, epic_params)

        wx0 = jnp.asarray(np.stack([i[..., 0] for i in inits]))
        wy0 = jnp.asarray(np.stack([i[..., 1] for i in inits]))
        im1 = jnp.asarray(np.stack([r[2][0] for r in todo]))
        im2 = jnp.asarray(np.stack([r[2][1] for r in todo]))
        wx, wy = variational_twoframe_batched(wx0, wy0, im1, im2, flow_params)
        wx = np.asarray(wx)
        wy = np.asarray(wy)
        for i, (seq_start_i, flo_file, _) in enumerate(todo):
            refined[seq_start_i] = np.stack([wx[i], wy[i]], -1)
    t_est = time.time() - t_est

    # ----------------------------------------------------- outputs + quantile
    flows = []
    results = ["frame\ttime\n\n"]
    per_sample = t_est / max(1, len(todo))
    for seq_start_i, flo_file, imgs in records:
        if seq_start_i in refined:
            flow = refined[seq_start_i]
            write_flo(flo_file, flow)
            results.append(f"{seq_start_i}\t{per_sample:.1f}\n")
        else:
            flow = read_flo(flo_file)
            results.append(f"{seq_start_i}\t0.0\n")
        write_image(output + f"tmp/frame_{seq_start_i}.png",
                    flow_color_img(flow[..., 0], flow[..., 1]))

        # un-scale flow to recorded resolution / frame rate (adaptiveFR.cpp:612)
        flows.append(flow / (scale * skip))

    if not flows:
        print(f"{folder}: no samples estimated", file=sys.stderr)
        return -1.0

    quantil, maxq = quantile_of_magnitudes(flows, q)
    print(f"Quantil: {quantil}")

    with open(output + "results.info", "w") as fh:
        fh.write("Adaptive Frame rate\n\n")
        fh.write(f"samples\t{len(flows)}\n")
        fh.write(f"sample_step\t{sample_step}\n")
        fh.write(f"skip\t{skip}\n")
        fh.write(f"{q} quantil\t{quantil}\n")
        fh.write(f"max\t{maxq}\n")

    target = append if append else os.path.join(seq_path, "quantil.dat")
    mode = "a" if append else "w"
    with open(target, mode) as fh:
        fh.write(f"{quantil}\n{maxq}\n")
    print(f"(took {time.time() - t_all:.1f}s)")
    return quantil


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    opts = dict(path="", folder="", fmt="%07i.tif", scale=0.25, skip=2,
                samples=40, sample_step=10, start=0, q=0.90, raw=False,
                sintel=False, subframes=False, overwrite=False, append="")
    i = 0
    while i < len(argv):
        a = argv[i]; i += 1
        if a in ("-h", "-help"):
            print(__doc__)
            return 0
        elif a == "-path":
            opts["path"] = argv[i]; i += 1
        elif a == "-folder":
            opts["folder"] = argv[i]; i += 1
        elif a == "-format":
            opts["fmt"] = argv[i]; i += 1
        elif a == "-scale":
            opts["scale"] = float(argv[i]); i += 1
        elif a == "-skip":
            opts["skip"] = max(1, int(argv[i])); i += 1
        elif a == "-samples":
            opts["samples"] = int(argv[i]); i += 1
        elif a == "-step":
            opts["sample_step"] = int(argv[i]); i += 1
        elif a == "-start":
            opts["start"] = int(argv[i]); i += 1
        elif a == "-quantil":
            opts["q"] = float(argv[i]); i += 1
        elif a == "-raw":
            opts["raw"] = True
        elif a == "-sintel":
            opts["sintel"] = True
        elif a == "-subframes":
            opts["subframes"] = True
        elif a == "-overwrite":
            opts["overwrite"] = True
        elif a == "-append":
            opts["append"] = argv[i]; i += 1
        elif a == "-threads":
            opts["threads"] = int(argv[i]); i += 1
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            print(__doc__)
            return 1

    path = opts.pop("path")
    folder = opts.pop("folder")
    folders = []
    if not folder:
        folders = sorted(d for d in os.listdir(path)
                         if os.path.isdir(os.path.join(path, d))
                         and not d.startswith("."))
    elif os.path.isdir(os.path.join(path, folder)):
        folders = [folder]
    else:
        with open(folder) as fh:
            folders = [ln.strip() for ln in fh
                       if os.path.isdir(os.path.join(path, ln.strip()))]

    # sequence folders are independent; the reference OpenMPs over them
    # (adaptiveFR.cpp:245). Here a thread pool overlaps each folder's host
    # I/O with the others' device dispatches (per-folder sample estimation
    # is already ONE vmapped device dispatch). Output order is preserved.
    threads = max(1, opts.pop("threads", 1))
    if threads > 1 and len(folders) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(threads, len(folders))) as ex:
            qvs = list(ex.map(lambda f: run_folder(path, f, **opts),
                              folders))
    else:
        qvs = [run_folder(path, f, **opts) for f in folders]
    overview = [f"{f}\t{opts['q']} quantil\t{qv}\n"
                for f, qv in zip(folders, qvs)]

    with open(os.path.join(path, "results.info"), "w") as fh:
        fh.write("Adaptive Frame rate\n\n")
        fh.write(f"samples\t{opts['samples']}\n")
        fh.write(f"sample_step\t{opts['sample_step']}\n")
        fh.write(f"skip\t{opts['skip']}\n\n")
        fh.writelines(overview)
    print("Done!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
