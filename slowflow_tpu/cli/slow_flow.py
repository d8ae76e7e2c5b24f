"""slow_flow CLI — stage 2: per-jet multi-frame flow estimation.

Mirrors the reference binary's contract (slow_flow.cpp):

    python -m slowflow_tpu.cli.slow_flow <cfg> [-overwrite] [-resume]
        [-deep_settings S] [-threads N] [-fr K] [-jet J] [-batch B]

Reads `adaptiveFR.dat` (tuning table) and `<sequence>/quantil.dat` (stage-1
output), derives the adaptive high/low frame rates, then for each jet runs the
EPIC-initialized (or coarse-to-fine) multi-frame variational minimization
forward and backward, writing Middlebury `.flo` files, occlusion `.pbm` maps,
flow visualizations, and a `config.cfg` snapshot including the sequence
normalization statistics.

Array redesign: the OpenMP-over-jets loop becomes a batched `vmap` dispatch
(`-batch B` jets per device call; see variational_mt_batched). The EPIC
initialization is pipelined off the jet critical path: per-frame Lab/
saliency/edge maps are computed for the whole window in single batched
dispatches, grid matching runs one dispatch per jet group, and the remaining
host-side interpolation work runs on a prefetch thread (`-threads N` sizes
it) that races ahead while the device minimizes the previous group.
"""
from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

from ..config import ParameterList, Verbosity
from ..io import write_flo, read_edges, read_matches, write_pbm
from ..io.images import write_image
from ..utils.colorwheel import flow_color_img
from ..utils.demosaic import raw_weighting
from ..variational.multiframe import MultiFrameParams, variational_mt_batched
from ..core.image import normalize_sequence, rgb_to_lab, resize_bilinear
from ..epic import EpicParams, epic
from ..epic.edges import detect_edges
from ..epic.matching import grid_matches_batched
from .common import frame_path, load_frame, unique_output_dir
from ..utils.compile_cache import enable_compile_cache


def set_default(params: ParameterList) -> None:
    """Default parameters (slow_flow.cpp:64-128)."""
    defaults = {
        "verbose": "0", "threads": "1",
        "16bit": "1", "raw": "1", "raw_weight": "1", "raw_demosaicing": "1",
        "raw_red_loc": "1,0",
        "Jets": "1", "adaptive": "1", "max_fps": "200", "ref_fps": "20",
        "scale": "1.0", "sigma": "0.0", "deep_matching": "1", "dm_scale": "1.0",
        "slow_flow_method": "symmetric", "slow_flow_S": "2",
        "slow_flow_dataterm": "1", "slow_flow_smoothing": "1",
        "slow_flow_alpha": "4.0", "slow_flow_gamma": "6.0",
        "slow_flow_delta": "1.0",
        "slow_flow_rho_0": "1", "slow_flow_rho_1": "1",
        "slow_flow_omega_0": "0", "slow_flow_omega_1": "2",
        "slow_flow_layers": "1", "slow_flow_p_scale": "0.9",
        "slow_flow_niter_alter": "10", "slow_flow_niter_graphc": "10",
        "slow_flow_niter_outer": "10", "slow_flow_thres_outer": "1e-5",
        "slow_flow_niter_inner": "1", "slow_flow_thres_inner": "1e-5",
        "slow_flow_niter_solver": "30", "slow_flow_sor_omega": "1.9",
        "slow_flow_occlusion_reasoning": "1", "slow_flow_occlusion_penalty": "0.1",
        "slow_flow_occlusion_alpha": "0.1", "slow_flow_output_occlusions": "1",
        "slow_flow_robust_color": "1", "slow_flow_robust_color_eps": "0.001",
        "slow_flow_robust_color_truncation": "0.5",
        "slow_flow_robust_reg": "1", "slow_flow_robust_reg_eps": "0.001",
        "slow_flow_robust_reg_truncation": "0.5",
    }
    for k, v in defaults.items():
        params.insert(k, v, overwrite=True)


def read_adaptive_table(search_dirs):
    """adaptiveFR.dat tuning table (slow_flow.cpp:283-304)."""
    hfr_quantil, lfr_rate = 2.0, 4
    found = False
    for d in search_dirs:
        p = os.path.join(d, "adaptiveFR.dat")
        if os.path.exists(p):
            for line in open(p):
                parts = line.strip().split("\t")
                if len(parts) < 2:
                    continue
                if parts[0] == "opt_hfr_quantil":
                    hfr_quantil = float(parts[1])
                elif parts[0] == "opt_lfr_rate":
                    lfr_rate = int(float(parts[1]))
            found = True
            break
    return hfr_quantil, lfr_rate, found


def compute_rates(quantil, hfr_quantil, lfr_rate_mult, keyframes, steps):
    """Adaptive high/low frame-rate derivation (slow_flow.cpp:322-351)."""
    if keyframes == 0:
        hfr_rate = max(1.0, round(hfr_quantil / quantil))
        lfr_rate = hfr_rate * lfr_rate_mult
        lfr_rate = hfr_rate * lfr_rate
        m = round(lfr_rate / hfr_rate)
        lfr_rate = hfr_rate * m
        return int(hfr_rate), int(lfr_rate)
    hfr_rate = int(max(1.0, round(hfr_quantil / quantil)))
    while hfr_rate < keyframes and keyframes % (hfr_rate * steps) != 0:
        hfr_rate += 1
    lfr_rate = min(keyframes, hfr_rate * lfr_rate_mult)
    while ((lfr_rate * steps < keyframes
            and (keyframes % (lfr_rate * steps) != 0
                 or (keyframes % (lfr_rate * steps) == 0
                     and (lfr_rate * steps) % (hfr_rate * steps) != 0)))
           or (lfr_rate * steps >= keyframes
               and (lfr_rate * steps) % (hfr_rate * steps) != 0)):
        lfr_rate += 1
    lfr_rate = min(keyframes // steps, lfr_rate)
    return hfr_rate, lfr_rate


def _epic_post(flow, target_hw, steps):
    """Rescale an EPIC flow to the working resolution and divide by `steps`
    (slow_flow.cpp:800-843)."""
    import jax.numpy as jnp

    h, w = target_hw
    fh, fw = h / flow.shape[0], w / flow.shape[1]
    if (fh, fw) != (1.0, 1.0):
        f = resize_bilinear(jnp.asarray(np.moveaxis(flow, -1, 0)), h, w)
        flow = np.moveaxis(np.asarray(f), 0, -1)
    wx = flow[..., 0] * fw / steps
    wy = flow[..., 1] * fh / steps
    return wx.astype(np.float32), wy.astype(np.float32)


def run(cfg_path: str, overwrite=False, resume=False, deep_settings="",
        selected_fr=-1, selected_jet=-1, threads=None, batch=1,
        max_flow_scale=3.0) -> int:
    params = ParameterList()
    set_default(params)
    params.read(cfg_path)

    enable_dm = params.parameter("deep_matching", type=bool)
    scale = params.parameter("scale", "1.0", float)
    start = params.sequence_start
    steps = params.parameter("slow_flow_S", type=int) - 1
    ref = steps
    max_fps = params.parameter("max_fps", "1", int)
    sintel = params.parameter("sintel", "0", bool)
    subframes = params.parameter("subframes", "0", bool)

    seq_dir, fmt = os.path.split(params.file)
    params.file = seq_dir + "/"
    params.insert("format", fmt, True)
    fmt_flow = os.path.splitext(fmt)[0]

    if sintel and not subframes:
        start *= 1000
    params.sequence_start = start

    params.output = unique_output_dir(params.output, resume, overwrite)

    epic_params = EpicParams.sintel()

    # ------------------------------------------------- adaptive frame rates
    hfr_quantil, lfr_rate_mult, have_table = read_adaptive_table(
        [os.path.dirname(os.path.abspath(cfg_path)), os.getcwd(),
         os.path.dirname(os.path.dirname(os.path.dirname(
             os.path.abspath(__file__))))])
    adaptive = have_table and params.parameter("adaptive", "0", bool)

    max_flow = 50.0
    if params.exists("max_flow"):
        max_flow = max(5.0, params.parameter("max_flow", type=float))
    quantil = 1.0
    orig_max_flow = 0.0
    hfr_rate, lfr_rate = 1, 4
    qf = os.path.join(seq_dir, "quantil.dat")
    if not params.exists("max_flow") and os.path.exists(qf):
        lines = [ln.strip() for ln in open(qf) if ln.strip()]
        quantil = float(lines[0])
        orig_max_flow = max_flow_scale * (
            float(lines[1]) if len(lines) > 1 else quantil)
        if adaptive:
            keyframes = int(params.parameter("max_fps", type=float)
                            // params.parameter("ref_fps", type=float))
            hfr_rate, lfr_rate = compute_rates(
                quantil, hfr_quantil, lfr_rate_mult, keyframes, steps)
            print(f"hfr_rate {hfr_rate}\nlfr_rate {lfr_rate}")
        else:
            skip = max_fps // max(1, params.parameter(
                "jet_fps", str(max_fps), int))
            max_flow = max(5.0, orig_max_flow * scale * ref * skip)
    else:
        adaptive = False

    start_fr, end_fr = 0, (1 + int(adaptive))
    if selected_fr >= 0:
        start_fr, end_fr = selected_fr, selected_fr + 1

    for ad_fr in range(start_fr, end_fr):
        cfg = ParameterList(clone=params)
        if adaptive:
            rate = hfr_rate if ad_fr == 0 else lfr_rate
            cfg.output = os.path.join(
                cfg.output, "high_fr" if ad_fr == 0 else "low_fr") + "/"
            cfg.insert("jet_fps", str(max_fps // rate), True)
            skip = rate
            max_flow_j = max(5.0, orig_max_flow * scale * ref * rate)
        else:
            jet_fps = cfg.parameter("jet_fps", str(max_fps), int)
            skip = int(max_fps / jet_fps)
            max_flow_j = max_flow

        dm_scale = params.parameter("dm_scale", "1.0", float)
        if enable_dm and max_flow_j > 150:
            dm_scale *= 0.5
            max_flow_j = max(5.0, 0.5 * max_flow_j)

        _run_one_rate(cfg, fmt, fmt_flow, start, steps, ref, skip, scale,
                      dm_scale, sintel, enable_dm, epic_params, resume,
                      selected_jet, batch, max_flow_j, threads)
    print("Done!")
    return 0


def _stage_window_8bit(frames8_stack):
    """Stage the 8-bit EPIC-init window to the device ONCE.

    Returns a device array the matcher/preprocessor slice on-device —
    the per-group host->device staging this replaces was re-uploading the
    same frames for every jet group. uint8 when the values are exactly
    representable (8-bit PNG sources at scale 1), f32 otherwise (16-bit
    inputs, resampled frames) — a 4x cut of the one-time staging cost in
    the common case."""
    import jax.numpy as jnp

    arr = np.asarray(frames8_stack, np.float32)
    exact_u8 = (arr.min() >= 0.0 and arr.max() <= 255.0
                and not np.any(arr != np.floor(arr)))
    if exact_u8:
        return jnp.asarray(arr.astype(np.uint8))
    return jnp.asarray(arr)


def _preprocess_frames(frames8_dev, chunk=48):
    """Lab + saliency + edge maps for every window frame in one batched
    dispatch each (replaces one rgb_to_lab/saliency/SED invocation per jet:
    slow_flow.cpp:747-757 + epic.cpp:166-174).

    frames8_dev: device-resident [F, 3, H, W] stack (uint8 or f32, see
    _stage_window_8bit) — chunks are sliced on-device, no per-chunk host
    upload. Frames are processed in fixed-size chunks (padded, so one
    compiled program serves them all): at teaser scale the window is 455
    frames and a whole-stack dispatch peaks >20 GB of HLO temps in the
    edge-detector convolutions."""
    import jax
    import jax.numpy as jnp

    from ..core.image import saliency as saliency_fn

    @jax.jit
    def go(stack):
        stack = stack.astype(jnp.float32)
        lab = jax.vmap(rgb_to_lab)(stack)
        sal = jax.vmap(lambda l: saliency_fn(l, 0.8, 1.0))(lab)
        edges = jax.vmap(detect_edges)(stack)
        return lab, sal, edges

    n = frames8_dev.shape[0]
    if n <= chunk:
        lab, sal, edges = go(frames8_dev)
        return np.asarray(lab), np.asarray(sal), np.asarray(edges)

    labs, sals, edgs = [], [], []
    for s in range(0, n, chunk):
        piece = frames8_dev[s:s + chunk]
        keep = piece.shape[0]
        if keep < chunk:
            piece = jnp.concatenate(
                [piece, jnp.repeat(piece[-1:], chunk - keep, axis=0)], 0)
        lab, sal, edges = go(piece)
        labs.append(np.asarray(lab)[:keep])
        sals.append(np.asarray(sal)[:keep])
        edgs.append(np.asarray(edges)[:keep])
    return (np.concatenate(labs, 0), np.concatenate(sals, 0),
            np.concatenate(edgs, 0))


def _run_one_rate(cfg, fmt, fmt_flow, start, steps, ref, skip, scale, dm_scale,
                  sintel, enable_dm, epic_params, resume, selected_jet, batch,
                  max_flow_j=50.0, threads=None):
    import jax.numpy as jnp

    jets = cfg.Jets
    frames = 1 + (jets + 2) * steps

    start_j, end_j = 0, jets
    start_f, end_f = 0, frames
    if resume and selected_jet >= 0:
        start_f = selected_jet * steps
        end_f = min(frames, 1 + (selected_jet + 3) * steps)
        start_j = selected_jet
        end_j = min(jets, selected_jet + 1)

    os.makedirs(cfg.output, exist_ok=True)
    os.makedirs(cfg.output + "sequence/", exist_ok=True)
    os.makedirs(cfg.output + "tmp/", exist_ok=True)
    if cfg.parameter("slow_flow_occlusion_reasoning", "0", bool):
        os.makedirs(cfg.output + "occlusion/", exist_ok=True)

    red_loc = cfg.split_parameter("raw_red_loc", "0,0")

    from ..utils.phases import phase as _phase_rd

    # ------------------------------------------------------ read the window
    seq = {}
    for f in range(start_f, end_f):
        path = frame_path(cfg.file, fmt, start, (f - ref) * skip, sintel)
        print(f"Reading {path}...")
        with _phase_rd("sf.read_frames"):
            seq[f] = load_frame(path, cfg, scale, red_loc)
        if cfg.verbosity(Verbosity.WRITE_FILES):
            out = frame_path(cfg.output + "sequence/", "frame_%i.png",
                             start, (f - ref) * skip, False)
            write_image(out, np.moveaxis(seq[f], 0, -1),
                        bit16=cfg.parameter("16bit", "0", bool))
    h, w = seq[start_f].shape[1:]

    channel_w = np.ones((3, h, w), np.float32)
    if cfg.exists("raw") and cfg.parameter("raw", "0", bool):
        channel_w = raw_weighting(h, w, red_loc[0], red_loc[1],
                                  cfg.parameter("raw_weight", "1.0", float))

    # ------------------------------------------------- ground truth (gt/)
    # file_gt .flo fields are rescaled and snapshotted for later comparison
    # (slow_flow.cpp:604-670); EPE against them lands in results.info.
    gt = {}
    if cfg.file_gt:
        os.makedirs(cfg.output + "gt/", exist_ok=True)
        from ..io import read_flo as _read_flo
        from ..core.image import resize_bilinear as _resize
        import jax.numpy as _jnp
        for j in range(start_j, end_j):
            path = frame_path("", cfg.file_gt, start, j * steps, sintel)
            if not os.path.exists(path):
                continue
            g = _read_flo(path)
            if scale != 1:
                nh, nw = int(g.shape[0] * scale), int(g.shape[1] * scale)
                g = np.moveaxis(np.asarray(_resize(
                    _jnp.asarray(np.moveaxis(g, -1, 0)), nh, nw)), 0, -1) * scale
            gt[j] = g
            write_flo(cfg.output + f"gt/flow_{cfg.sequence_start + j * steps:05d}.flo", g)
            write_image(cfg.output + f"gt/flow_{cfg.sequence_start + j * steps:05d}.png",
                        flow_color_img(g[..., 0], g[..., 1]))

    # 8-bit copies for EPIC init before normalization; 16-bit input scales by
    # 1/255 with saturation like the reference's convertTo (slow_flow.cpp:578)
    norm16 = cfg.parameter("16bit", "0", bool)
    seq8 = {f: (np.clip(img / 255.0, 0, 255) if norm16 else img)
            for f, img in seq.items()}

    # normalize intensities; record stats in the config snapshot
    stack = np.stack([seq[f] for f in range(start_f, end_f)])
    stack, avg, std = normalize_sequence(stack)
    for i, f in enumerate(range(start_f, end_f)):
        seq[f] = stack[i]
    for c in range(3):
        cfg.insert(f"slow_flow_img_norm_avg_{c + 1}", repr(float(avg[c])), True)
        cfg.insert(f"slow_flow_img_norm_std_{c + 1}", repr(float(std[c])), True)

    with open(cfg.output + "config.cfg", "w") as fh:
        fh.write("# SlowFlow variational estimation\n")
        fh.write(cfg.cfg_string())

    p = MultiFrameParams.from_parameter_list(cfg)
    norm_avg = np.asarray(avg, np.float32)
    norm_std = np.asarray(std, np.float32)

    results = ["frame\ttime\n"]

    # per-frame Lab/saliency/edges for the whole window, batched; the 8-bit
    # window is staged to the device ONCE (uint8 when exactly representable)
    # and the matcher/preprocessor slice it on-device
    pre = {}
    seq8_dev = None
    if enable_dm:
        order = list(range(start_f, end_f))
        with _phase_rd("sf.stage_window8"):
            seq8_dev = _stage_window_8bit(np.stack([seq8[f] for f in order]))
        with _phase_rd("sf.preprocess_frames"):
            lab_all, sal_all, edges_all = _preprocess_frames(seq8_dev)
        pre = {f: i for i, f in enumerate(order)}

    # The normalized frame stack is staged to the device ONCE; per-batch jet
    # windows are gathered on-device (consecutive windows share all but
    # `steps` frames, so host->HBM traffic would otherwise be ~F/steps x).
    # When the 8-bit EPIC window was staged as exact uint8 (same raw values:
    # norm16 off), normalize ON-DEVICE from that copy instead of uploading
    # the f32 stack again — stats stay the host-f64 values recorded in
    # config.cfg; the per-pixel (x - avg)/std runs in f32 (<= 1 ulp from
    # the host path, far inside the 0.1 px budget).
    with _phase_rd("sf.stage_solve_window"):
        if (enable_dm and not norm16 and seq8_dev.dtype == np.uint8):
            import jax as _jax

            std_np = np.asarray(std)
            std_safe = np.where(std_np > 0, std_np, 1.0)

            @_jax.jit
            def _dev_normalize(u8, avg_, std_, use_):
                x = u8.astype(jnp.float32)
                norm = (x - avg_[None, :, None, None]) \
                    / std_[None, :, None, None]
                # std == 0 channels stay RAW (normalize_sequence skips
                # them entirely, avg subtraction included)
                return jnp.where(use_[None, :, None, None], norm, x)

            seq_dev = _dev_normalize(seq8_dev,
                                     jnp.asarray(avg, jnp.float32),
                                     jnp.asarray(std_safe, jnp.float32),
                                     jnp.asarray(std_np > 0))
        else:
            seq_dev = jnp.asarray(stack)

    def jet_window_idx(j, backward=False):
        """Window frame indices (into seq_dev) around jet j (forward) or the
        reversed window for the backward pass (slow_flow.cpp:716-724)."""
        f0 = j * steps
        idx = list(range(f0, f0 + 2 * ref + 1))
        if backward:
            idx = list(reversed([i + steps for i in idx]))
        return [i - start_f for i in idx]

    # per-frame Lab/saliency/edges for the whole window, batched (only when
    # the EPIC init will actually run)
    pre = {}
    if enable_dm:
        order = list(range(start_f, end_f))
        with _phase_rd("sf.stage_window8"):
            seq8_dev = _stage_window_8bit(np.stack([seq8[f] for f in order]))
        with _phase_rd("sf.preprocess_frames"):
            lab_all, sal_all, edges_all = _preprocess_frames(seq8_dev)
        pre = {f: i for i, f in enumerate(order)}

    def _jet_frames(j, backward):
        a = j * steps + ref
        b = j * steps + 2 * ref
        if backward:
            a, b = b, a
        return a, b

    def _match_file(a, b):
        return (cfg.output + f"tmp/matches_{cfg.sequence_start + (a - ref) * skip}"
                f"_{cfg.sequence_start + (b - ref) * skip}.dat")

    def group_matches(group, backward):
        """Matches for every jet in a group: ingested DeepMatching files when
        present, otherwise ONE batched grid-match dispatch for the rest."""
        pairs = [_jet_frames(j, backward) for j in group]
        out = {}
        missing = []
        for j, (a, b) in zip(group, pairs):
            mf = _match_file(a, b)
            if os.path.exists(mf):
                out[j] = read_matches(mf)
            else:
                missing.append((j, a, b))
        if missing:
            radius = int(min(64, max(8, math.ceil(max_flow_j))))
            # slice the once-staged device window — no per-group host upload
            ia = jnp.asarray([pre[a] for _, a, _ in missing])
            ib = jnp.asarray([pre[b] for _, _, b in missing])
            res = grid_matches_batched(seq8_dev[ia], seq8_dev[ib],
                                       radius=radius)
            for (j, _, _), m in zip(missing, res):
                out[j] = m
        return out

    def epic_jobs(group, backward, matches):
        """EPIC jobs for a jet group from the precomputed per-frame maps;
        SED edge files are ingested from tmp/ when present."""
        jobs = []
        for j in group:
            a, _ = _jet_frames(j, backward)
            edges_f = (cfg.output
                       + f"tmp/edges_{cfg.sequence_start + (a - ref) * skip}.dat")
            edges = read_edges(edges_f, w, h) if os.path.exists(edges_f) \
                else edges_all[pre[a]]
            jobs.append((lab_all[pre[a]], matches[j], edges,
                         sal_all[pre[a]]))
        return jobs

    # ------------------------------------------------------- per-jet batches
    def output_name(j, backward):
        off = (j * steps + (steps if backward else 0)) * skip
        suffix = "_back" if backward else ""
        if not sintel:
            name = (fmt_flow % (start + off)) + suffix + ".flo"
        else:
            name = (fmt_flow % (start + off, 0)) + suffix + ".flo"
        return os.path.join(cfg.output, name)

    from concurrent.futures import ThreadPoolExecutor

    from ..utils.phases import phase, report as phase_report

    def compute_inits(group, backward):
        """Host+small-device part of the EPIC init for one jet group; runs on
        the prefetch thread so it overlaps the previous group's device solve
        (the reference hides this cost inside OpenMP-over-jets,
        slow_flow.cpp:706). The group's matches and both geodesic DTs are
        single batched dispatches."""
        from ..epic import epic_batched

        with phase("sf.matches"):
            matches = group_matches(group, backward)
        with phase("sf.epic"):
            flows = epic_batched(epic_jobs(group, backward, matches),
                                 epic_params)
        with phase("sf.epic_post"):
            inits = [_epic_post(f, (h, w), steps) for f in flows]
        return (np.stack([ini[0] for ini in inits]),
                np.stack([ini[1] for ini in inits]))

    tasks = []
    for backward in (False, True):
        pending = []
        for j in range(start_j, end_j):
            out_file = output_name(j, backward)
            if resume and os.path.exists(out_file):
                print(f"{'Backward' if backward else 'Forward'} flow for jet "
                      f"{j} already exists!")
                continue
            pending.append(j)
        for i in range(0, len(pending), max(1, batch)):
            tasks.append((backward, pending[i:i + max(1, batch)]))

    executor = ThreadPoolExecutor(max_workers=max(1, threads or 2)) \
        if enable_dm else None
    init_futs = [executor.submit(compute_inits, group, backward)
                 for backward, group in tasks] if enable_dm else None

    try:
        for ti, (backward, group) in enumerate(tasks):
            t0 = time.time()
            with phase("sf.window_gather"):
                windows = seq_dev[jnp.asarray(
                    [jet_window_idx(j, backward) for j in group])]
            if enable_dm:
                with phase("sf.init_wait"):
                    wx0, wy0 = init_futs[ti].result()
            else:
                wx0 = np.zeros((len(group), h, w), np.float32)
                wy0 = np.zeros((len(group), h, w), np.float32)

            pb = p
            if backward and cfg.exists("method") \
                    and cfg.parameter("method") == "forward":
                pb = MultiFrameParams(**{**p.__dict__, "one_direction": True})

            cw = np.broadcast_to(channel_w, (len(group), 3, h, w))
            na = np.broadcast_to(norm_avg, (len(group), 3))
            ns = np.broadcast_to(norm_std, (len(group), 3))

            # several devices: shard the jet batch across them via
            # shard_map — pure DP over the jet axis (the replacement for
            # SSE x OpenMP-over-jets, slow_flow.cpp:706 +
            # variational_mt.cpp:13-14)
            import jax
            args = (wx0, wy0, windows, cw, na, ns)
            n_dev = len(jax.devices())
            with phase("sf.solve"):
                if n_dev > 1 and len(group) % n_dev == 0:
                    from ..parallel.mesh import make_mesh, shard_jet_batch
                    from ..variational.multiframe import \
                        variational_mt_sharded
                    mesh = make_mesh(n_jet=n_dev, n_sp=1)
                    args = shard_jet_batch(mesh, *args)
                    wx0s, wy0s, windows_s, cws, nas, nss = args
                    wx, wy, occ = variational_mt_sharded(
                        wx0s, wy0s, windows_s, pb, mesh, cws, nas, nss)
                else:
                    wx, wy, occ = variational_mt_batched(
                        wx0, wy0, windows, pb, cw, na, ns)
                wx = np.asarray(wx) * steps
                wy = np.asarray(wy) * steps
                occ = np.asarray(occ)
            dt = time.time() - t0

            for k, j in enumerate(group):
                out_file = output_name(j, backward)
                with phase("sf.write_flo"):
                    write_flo(out_file, np.stack([wx[k], wy[k]], -1))
                if not backward and j in gt:
                    from ..utils.metrics import compute_epe
                    epe = compute_epe(np.stack([wx[k], wy[k]], -1), gt[j])
                    results.append(f"# jet {j} EPE vs gt: {epe:.4f}\n")
                if not backward:
                    # occlusion map + visualization (forward pass only,
                    # slow_flow.cpp:891-925)
                    if p.occlusion_reasoning and cfg.parameter(
                            "slow_flow_output_occlusions", "0", bool):
                        occ_img = ((occ[k] + 1.0) * 0.5 * 255).astype(np.uint8)
                        write_pbm(cfg.output + "occlusion/"
                                  f"frame_{start + j * steps * skip}.pbm",
                                  occ_img)
                    with phase("sf.vis_png"):
                        vis = flow_color_img(wx[k], wy[k])
                        write_image(
                            cfg.output
                            + f"frame_{start + j * steps * skip}.png", vis)
                results.append(f"{j * steps * skip}\t {dt / len(group):.1f}\n")
                print(f"{'Backward' if backward else 'Forward'} flow jet {j} "
                      f"finished! ({dt / len(group):.1f} s)")
    finally:
        if executor is not None:
            executor.shutdown(wait=False, cancel_futures=True)

    with open(cfg.output + "results.info", "w") as fh:
        fh.write("SlowFlow variational estimation\n\n")
        fh.writelines(results)
        times = [float(r.split("\t")[1]) for r in results[1:]
                 if "\t" in r and not r.startswith("#")]
        if times:
            fh.write(f"\n\navg\t{sum(times) / len(times):.1f}s\n")
    phase_report()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    if not argv:
        print(__doc__)
        return 1
    cfg_path = argv[0]
    if not os.path.exists(cfg_path):
        print(f"Couldn't find {cfg_path}!", file=sys.stderr)
        return -1
    kw = {}
    i = 1
    while i < len(argv):
        a = argv[i]; i += 1
        if a == "-overwrite":
            kw["overwrite"] = True
        elif a == "-resume":
            kw["resume"] = True
        elif a == "-deep_settings":
            kw["deep_settings"] = argv[i]; i += 1
        elif a == "-threads":
            kw["threads"] = int(argv[i]); i += 1
        elif a == "-fr":
            kw["selected_fr"] = int(argv[i]); i += 1
        elif a == "-jet":
            kw["selected_jet"] = int(argv[i]); i += 1
            kw["resume"] = True
        elif a == "-batch":
            kw["batch"] = int(argv[i]); i += 1
        elif a in ("-h", "-help"):
            print(__doc__)
            return 0
        else:
            print(f"unknown argument {a}", file=sys.stderr)
    return run(cfg_path, **kw)


if __name__ == "__main__":
    sys.exit(main())
