"""dense_tracking CLI — stage 3: trajectory tracking to final reference flow.

Mirrors the reference binary's contract (dense_tracking.cpp):

    python -m slowflow_tpu.cli.dense_tracking <cfg> [-select N] [-resume]
        [-output PATH] [-threads N] [-batch_finals N]

Reads the jet estimations listed under `jet_estimation` (deriving each rate's
`slow_flow_S` / `jet_fps` from its `config.cfg` snapshot when not given),
computes Jets = jet_fps[min] / (ref_fps * steps), and for each final frame
pair runs the alternating hypothesis-tracking optimization, writing
`frame_%i.flo`, `occlusions/frame_%i.pbm`, a flow visualization, and
`result.info` timing/factor statistics.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..config import ParameterList, Verbosity
from ..io import read_flo, write_flo, write_pbm
from ..io.images import read_pbm, write_image
from ..utils.colorwheel import flow_color_img
from ..core.image import normalize_sequence, rgb_to_lab, resize_bilinear
from ..core.conv import DERIV_5PT, conv_horiz, conv_vert
from ..epic import EpicParams
from ..epic.edges import detect_edges
from ..tracking.driver import TrackingConfig, track_final_pairs_batched
from .common import frame_path, load_frame, unique_output_dir
from ..utils.compile_cache import enable_compile_cache


def _resize_flow_np(flow, nh, nw):
    import jax.numpy as jnp

    fh = nh / flow.shape[0]
    fw = nw / flow.shape[1]
    if (fh, fw) == (1.0, 1.0):
        return flow
    out = resize_bilinear(jnp.asarray(np.moveaxis(flow, -1, 0)), nh, nw)
    return np.moveaxis(np.asarray(out), 0, -1) * fw  # reference scales by one
    # isotropic `rescale` factor (dense_tracking.cpp:1142-1146)


def smoothness_weight(img, avg, std, hbit):
    """computeSmoothnessWeight (dense_tracking.cpp:367-406)."""
    import jax.numpy as jnp

    scale = 65535.0 if hbit else 255.0
    im = jnp.asarray(img)
    lum = (0.299 * (im[0] * std[0] + avg[0])
           + 0.587 * (im[1] * std[1] + avg[1])
           + 0.114 * (im[2] * std[2] + avg[2])) / scale
    lx = conv_horiz(lum, DERIV_5PT)
    ly = conv_vert(lum, DERIV_5PT)
    return np.asarray(0.5 * jnp.exp(-5.0 * jnp.sqrt(lx * lx + ly * ly)))


def run(cfg_path: str, select=-1, resume=False, output=None, threads=None,
        batch_finals=None):
    params = ParameterList()
    params.insert("verbose", "0", True)
    params.read(cfg_path)
    if output:
        params.output = output

    max_fps = params.parameter("max_fps", "0", int)
    sintel = params.parameter("sintel", "0", bool)
    subframes = params.parameter("subframes", "0", bool)
    ref_fps_F = params.parameter("ref_fps_F", "1", int)
    rates = len(params.jet_estimation)
    if rates == 0:
        print("No Jet estimation specified!", file=sys.stderr)
        return -1
    params.jet_estimation = [p if p.endswith("/") else p + "/"
                             for p in params.jet_estimation]
    min_fps_idx = params.parameter("acc_min_fps", "0", int)

    # derive jet_S / jet_fps from each estimation's config.cfg
    # (dense_tracking.cpp:501-561)
    if len(params.jet_S) != rates:
        params.jet_S = []
        for est in params.jet_estimation:
            sub = ParameterList(os.path.join(est, "config.cfg"))
            params.jet_S.append(sub.parameter("slow_flow_S", type=int))
    if len(params.jet_fps) != rates:
        params.jet_fps = []
        for est in params.jet_estimation:
            sub = ParameterList(os.path.join(est, "config.cfg"))
            params.jet_fps.append(sub.parameter("jet_fps", type=int))

    steps = params.jet_S[min_fps_idx] - 1
    jets = int(params.jet_fps[min_fps_idx]
               / (params.parameter("ref_fps", type=float) * steps))
    params.Jets = jets
    skip = int(max_fps / params.jet_fps[min_fps_idx]) if max_fps else 1

    params.output = unique_output_dir(params.output, resume, True)
    acc_folder = params.output
    for sub in ("", "occlusions/", "gt_occlusions/", "tmp/", "sequence/"):
        os.makedirs(acc_folder + sub, exist_ok=True)

    with open(acc_folder + "config.cfg", "w") as fh:
        fh.write("# Slow Flow Accumulation\n")
        fh.write(params.cfg_string(all_exps=True))

    weight_jet = np.array(
        [params.jet_weight[i] if i < len(params.jet_weight) else float(i)
         for i in range(rates)], np.float32)

    cfg = TrackingConfig.from_parameter_list(params, jets, rates)

    if sintel and not subframes:
        params.sequence_start *= 1000

    seq_dir, fmt = os.path.split(params.file)
    seq_dir += "/"
    flow_format = params.parameter("flow_format", "frame_%i", str)
    flow_format = os.path.splitext(flow_format)[0]

    selected_end = ref_fps_F if select < 0 else select + 1
    selected = 0 if select < 0 else select

    scale = params.parameter("scale", "1.0", float)
    red_loc = params.split_parameter("raw_red_loc", "0,0")
    grayscale = params.parameter("grayscale", "0", bool)
    timing = dict(warp=0.0, median=0.0, data=0.0,
                  unary=0.0, pairwise=0.0, optimization=0.0)

    stats = {"variables": [], "factors": []}

    from ..utils.phases import phase, report as phase_report

    def prepare(start_jet):
        """Host-side context for one final pair: frame I/O, normalization,
        derivative stacks, jet-estimation ingestion, EPIC context. Runs on
        prefetch threads so final k+1's I/O overlaps final k's device
        alternation (the reference instead OpenMPs whole finals across
        cores, dense_tracking.cpp:726-727). Returns a job dict or None."""
        tp = ParameterList(clone=params)
        tp.sequence_start = params.sequence_start + start_jet * jets * steps * skip

        final_file = os.path.join(
            acc_folder, (flow_format % tp.sequence_start) + ".flo"
            if not sintel else
            ("s" + flow_format % (tp.sequence_start, 0)) + ".flo")
        if os.path.exists(final_file):
            print(f"Flow file {final_file} already exists!")
            return None

        # ------------------------------------------ read the image sequence
        data = []
        ok = True
        with phase("dt.read_frames"):
            for f in range(jets + 1):
                p = frame_path(seq_dir, fmt, tp.sequence_start,
                               f * steps * skip, sintel)
                if not os.path.exists(p):
                    print(f"{p} does not exist!", file=sys.stderr)
                    ok = False
                    break
                img = load_frame(p, tp, scale, red_loc)
                if grayscale:
                    lum = 0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2]
                    img = np.repeat(lum[None], 3, 0)
                data.append(img)
        if not ok:
            return None
        stack = np.stack(data)                       # [J+1, 3, H, W]
        oh, ow = stack.shape[2:]

        with phase("dt.normalize"):
            stack, avg, std = normalize_sequence(stack)

        import jax.numpy as jnp
        with phase("dt.derivs"):
            dx = np.asarray(conv_horiz(jnp.asarray(stack), DERIV_5PT))
            dy = np.asarray(conv_vert(jnp.asarray(stack), DERIV_5PT))
            # [J+1, H, W, 3] layout for the gather-heavy tracking kernels
            data_hw = np.moveaxis(stack, 1, -1)
            dx_hw = np.moveaxis(dx, 1, -1)
            dy_hw = np.moveaxis(dy, 1, -1)

        with phase("dt.smooth_weight"):
            sw = smoothness_weight(stack[0], avg, std,
                                   tp.parameter("16bit", "0", bool))

        # ------------------------------------------ per-rate jet estimations
        rate_flows = []
        forward = backward = None
        occl_min = None
        ok = True
        for r in range(rates):
            r_steps = params.jet_S[r] - 1
            ratio = params.jet_fps[r] / params.jet_fps[min_fps_idx]
            r_jets = int(ratio * jets)
            r_skip = int(max_fps / params.jet_fps[r]) if max_fps else 1

            fwd, bwd = [], []
            with phase("dt.read_jet_flows"):
                for f in range(r_jets):
                    base = tp.sequence_start + f * r_steps * r_skip
                    f_file = os.path.join(params.jet_estimation[r],
                                          (flow_format % base) + ".flo")
                    b_file = os.path.join(
                        params.jet_estimation[r],
                        (flow_format % (base + r_steps * r_skip))
                        + "_back.flo")
                    if not (os.path.exists(f_file)
                            and os.path.exists(b_file)):
                        print(f"{f_file} or backward does not exist!",
                              file=sys.stderr)
                        ok = False
                        break
                    ff = _resize_flow_np(read_flo(f_file), oh, ow)
                    bb = _resize_flow_np(read_flo(b_file), oh, ow)
                    fwd.append(ff)
                    bwd.append(bb)
            if not ok:
                break
            fwd = np.stack(fwd)
            bwd = np.stack(bwd)

            occ = None
            if cfg.use_jet_occlusions:
                occs = []
                for f in range(r_jets):
                    base = tp.sequence_start + f * r_steps * r_skip
                    seq_f = os.path.join(params.jet_estimation[r],
                                         f"occlusion/frame_{base}.pbm")
                    if not os.path.exists(seq_f):
                        occs = None
                        break
                    o = read_pbm(seq_f)
                    if o.shape != (oh, ow):
                        o = np.asarray(resize_bilinear(
                            jnp.asarray(o[None], jnp.float32), oh, ow))[0]
                        o = (o > 127).astype(np.uint8) * 255
                    occs.append(255 - o)   # invert (dense_tracking.cpp:1189)
                occ = np.stack(occs) if occs else None

            rate_flows.append((fwd, bwd, occ))
            if r == min_fps_idx:
                forward, backward = fwd, bwd
                occl_min = occ
        if not ok or forward is None:
            return None

        # ---------------------------------------- oracle GT ingestion
        # acc_oracle loads GT flow + occlusions and snapshots the occlusion
        # maps (dense_tracking.cpp:985-1077); in the released reference this
        # data is diagnostic only and never enters the optimization.
        if tp.parameter("acc_oracle", "0", bool):
            gt_frames = jets * skip
            if tp.file_gt:
                for f in range(gt_frames):
                    pth = frame_path("", tp.file_gt, tp.sequence_start, f,
                                     sintel)
                    if os.path.exists(pth):
                        g = read_flo(pth)
                        _ = _resize_flow_np(g, oh, ow)
            for occ_fmt in tp.occlusions_list[:1]:
                for f in range(gt_frames):
                    pth = frame_path("", occ_fmt, tp.sequence_start, f, sintel)
                    if not os.path.exists(pth):
                        print(f"Error reading {pth}!", file=sys.stderr)
                        continue
                    occ_img = read_pbm(pth)
                    write_image(acc_folder + "gt_occlusions/"
                                f"occ_{tp.sequence_start + f:05d}.png",
                                occ_img)

        # EPIC context on the (subsampled) reference image
        epic_ctx = None
        if cfg.epic_interpolation:
            with phase("dt.epic_ctx"):
                img_scale = 1.0 / (cfg.skip_pixel + 1)
                ref8 = np.clip(data[0] / 255.0, 0, 255) \
                    if tp.parameter("16bit", "0", bool) else data[0]
                if img_scale != 1.0:
                    nh = int(oh * img_scale)
                    nw = int(ow * img_scale)
                    ref8 = np.asarray(resize_bilinear(jnp.asarray(ref8),
                                                      nh, nw))
                edges = np.asarray(detect_edges(jnp.asarray(ref8)))
                imlab = np.asarray(rgb_to_lab(jnp.asarray(ref8)))
                epic_ctx = (imlab, edges, EpicParams.sintel())

        return dict(start_jet=start_jet, final_file=final_file,
                    sequence_start=tp.sequence_start,
                    rate_flows=rate_flows, forward=forward,
                    backward=backward, occlusions=occl_min,
                    data=data_hw, data_dx=dx_hw, data_dy=dy_hw,
                    smooth_weight=sw, epic_ctx=epic_ctx)

    verbose = params.verbosity(Verbosity.VER_CMD)
    n_threads = max(1, threads or 1)
    # -threads N drives the host prefetch pool only; batching finals onto a
    # leading device axis is opt-in (-batch_finals N): it measured slower
    # on the CPU (0.83x), and on the card it is not measured yet
    batch_n = max(1, batch_finals or 1)

    def flush(jobs):
        # a batch must agree on jet-occlusion availability; split when a
        # final's occlusion maps are missing (prepare leaves occ = None)
        with_occ = [j for j in jobs if j["occlusions"] is not None]
        without = [j for j in jobs if j["occlusions"] is None]
        if with_occ and without:
            flush(with_occ)
            flush(without)
            return
        t0 = time.time()
        with phase("dt.track"):
            flows, occs, info = track_final_pairs_batched(
                cfg, jobs, weight_jet, verbose=verbose,
                init_workers=n_threads)
        for job, flow, occ_map in zip(jobs, flows, occs):
            stats["variables"].extend(info.get("variables", []))
            stats["factors"].extend(info.get("factors", []))
            with phase("dt.write_outputs"):
                write_flo(job["final_file"], flow)
                write_pbm(acc_folder
                          + f"occlusions/frame_{job['sequence_start']}.pbm",
                          occ_map)
                vis = flow_color_img(flow[..., 0], flow[..., 1])
                write_image(
                    os.path.splitext(job["final_file"])[0] + "_vis.png",
                    vis)
        for k, v in info.get("timing", {}).items():
            timing[k] = timing.get(k, 0.0) + v
        wall = time.time() - t0
        for job in jobs:
            print(f"Final pair {job['start_jet']} done "
                  f"({wall / len(jobs):.1f}s) -> {job['final_file']}")

    # prefetch window: final k+1's I/O + EPIC context load on worker
    # threads while final k's batch runs its device alternation
    ids = list(range(selected, selected_end))
    pending = []
    if n_threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        window = batch_n + n_threads
        with ThreadPoolExecutor(n_threads) as ex:
            futs = {i: ex.submit(prepare, i) for i in ids[:window]}
            for n, i in enumerate(ids):
                nxt = n + window
                if nxt < len(ids):
                    futs[ids[nxt]] = ex.submit(prepare, ids[nxt])
                job = futs.pop(i).result()
                if job is None:
                    continue
                pending.append(job)
                if len(pending) >= batch_n:
                    flush(pending)
                    pending = []
            if pending:
                flush(pending)
    else:
        for i in ids:
            job = prepare(i)
            if job is None:
                continue
            flush([job])

    # phase breakdown in the reference's exact row format
    # (dense_tracking.cpp:1951-1964); the per-alternation Variables/Factors
    # streams are tab-prefixed per entry like numVariablesStream/
    # factorsStream (:1868-1869)
    with open(acc_folder + "result.info", "w") as fh:
        fh.write("# Discrete optimization file\n\n")
        fh.write(f"Warping took {timing['warp']:g}s.\n")
        fh.write(f"Median took {timing['median']:g}s.\n")
        fh.write(f"Data term computation took {timing['data']:g}s.\n")
        fh.write(f"Adding unary potentials took {timing['unary']:g}s.\n")
        fh.write(f"Adding pairwise potentials took {timing['pairwise']:g}s.\n")
        fh.write(f"Run discrete optimization took "
                 f"{timing['optimization']:g}s.\n\n")
        fh.write("Discrete Optimization:\n")
        fh.write("\tVariables:"
                 + "".join(f"\t{v}" for v in stats["variables"]) + "\n")
        fh.write("\tFactors:"
                 + "".join(f"\t{f}" for f in stats["factors"]) + "\n\n")
    phase_report()
    print("Done!")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    if not argv:
        print(__doc__)
        return -1
    cfg_path = argv[0]
    if not os.path.exists(cfg_path):
        print(f"using parameters {cfg_path}: not found", file=sys.stderr)
        return -1
    kw = {}
    i = 1
    while i < len(argv):
        a = argv[i]; i += 1
        if a == "-select":
            kw["select"] = int(argv[i]); i += 1
        elif a == "-resume":
            kw["resume"] = True
        elif a == "-output":
            kw["output"] = argv[i]; i += 1
        elif a == "-threads":
            kw["threads"] = int(argv[i]); i += 1
        elif a == "-batch_finals":
            kw["batch_finals"] = int(argv[i]); i += 1
        elif a in ("-h", "-help"):
            print(__doc__)
            return 0
        else:
            print(f"unknown argument {a}", file=sys.stderr)
            return 1
    return run(cfg_path, **kw)


if __name__ == "__main__":
    sys.exit(main())
