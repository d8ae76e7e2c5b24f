"""Smoke run of the three-stage Slow Flow pipeline on one GPU.

Drives the main path once through the entry points a user calls, at the
cfg-default deployment (cfgs/slow_flow.cfg at its 480x270 working
resolution: S=3, 5 layers, 10 alternations x 10 outer x 30 SOR iterations,
occlusion reasoning and EPIC initialisation on; stage 3 with EPIC
hypotheses, Jets=5 per final, K=16), on the seeded two-layer scene of
tools/scene.py. Phases, each printing one JSON line:

  device    the JAX device and the card's name and power limit; no GPU ->
            exit 2 with no result
  route     the jitted b=4 480x270 solve holds no Pallas call and no
            Pallas/Mosaic/Triton custom call
  warp      gather warp vs a NumPy four-corner reference on the card, and
            the S=3 window warp's time
  bank      stage-3 bank permutation and readback vs NumPy take_along_axis,
            and the permutation's time
  level     one full-config pyramid level on the GPU vs the CPU: one
            linearisation step to rounding, the whole level with the
            occlusion labels held to 1e-2 px on 99 % of pixels, and with
            them free to the same accuracy against the true flow
  pipeline  adaptive_fr -> slow_flow -> dense_tracking, with stage wall
            times, compile time and the flow-recovery gates

The last line is {"ok": true, "device": {...}}. Any failed check raises, so
the script exits non-zero with no `ok` line.

`--four` runs only the four-card path: 8 stage-2 jets sharded over 4 cards
with variational_mt_sharded, compared with the per-card program on one card
(bitwise) and with the 8-jet one-card program (same accuracy).

Usage: python chip_smoke.py [--four]
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "tools"))      # scene.py, bench_pipeline.py
H, W = 270, 480
BATCH = 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what) -> None:
    """A failed check raises (kept under `python -O`, unlike assert)."""
    if not ok:
        raise SmokeFailure(what)


def full_params():
    """cfgs/slow_flow.cfg stage-2 settings (the pipeline cell's cfg)."""
    from slowflow_tpu.variational.multiframe import MultiFrameParams

    return MultiFrameParams(S=3, alpha=4.0, gamma=6.0, delta=1.0,
                            rho=(1.0, 1.0), omega=(0.0, 2.0), layers=5,
                            p_scale=0.9, niter_alter=10, niter_outer=10,
                            niter_inner=1, niter_solver=30,
                            occlusion_reasoning=True, smoothing=1)


def scene(*args, **kwargs):
    """The seeded two-layer scene of tools/scene.py: [f, 3, h, w], 0-255."""
    from scene import moving_sequence

    return moving_sequence(*args, **kwargs)


def scene_window(h, w, f=5, seed=0):
    """Normalised [f, 3, h, w] window of the two-layer scene."""
    from slowflow_tpu.core.image import normalize_sequence

    seq, avg, std = normalize_sequence(scene(f, h, w, 1.5, -0.8, seed=seed))
    return seq, np.asarray(avg, np.float32), np.asarray(std, np.float32)


def solve_args(b, h, w, seed=0):
    """(wx, wy, seq, channel_w, norm_avg, norm_std) for a b-jet batch."""
    wins = [scene_window(h, w, seed=seed + i) for i in range(b)]
    seq = np.stack([s for s, _, _ in wins])
    z = np.zeros((b, h, w), np.float32)
    return (z, z.copy(), seq, np.ones((b, 3, h, w), np.float32),
            np.stack([a for _, a, _ in wins]),
            np.stack([s for _, _, s in wins]))


def scene_epe(u, v):
    """Median end-point error of one jet's flow against the scene's truth
    at the window's middle frame: (background interior, foreground disc)."""
    h, w = u.shape
    yy, xx = np.mgrid[0:h, 0:w]
    fg = ((yy - h // 2) ** 2 + (xx - w // 2) ** 2) < (min(h, w) // 6) ** 2
    inner = np.zeros((h, w), bool)
    inner[12:-12, 12:-12] = True
    e = np.hypot(u - np.where(fg, -1.5, 1.5), v + 0.8)
    return float(np.median(e[inner & ~fg])), float(np.median(e[fg]))


# ------------------------------------------------------------------- route
_KERNEL_CALL = re.compile(r"pallas|mosaic|triton|tpu", re.I)


def _primitives(jaxpr, seen=None):
    """Names of every primitive in a (closed) jaxpr, sub-jaxprs included."""
    from jax.extend import core as jcore

    seen = set() if seen is None else seen
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in jaxpr.eqns:
        seen.add(eqn.primitive.name)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(sub, (jcore.Jaxpr, jcore.ClosedJaxpr)):
                    _primitives(sub, seen)
    return seen


def pallas_primitives(jaxpr) -> list[str]:
    """Pallas primitives in a traced program (compiled or interpreted)."""
    return sorted(p for p in _primitives(jaxpr) if "pallas" in p)


def kernel_custom_calls(hlo_text: str) -> list[str]:
    """Custom-call targets of a lowering that come from a hand-written
    kernel (a Pallas kernel compiled for a device lowers to one)."""
    targets = set(re.findall(r"custom_call\s*@([\w.$]+)", hlo_text))
    return sorted(t for t in targets if _KERNEL_CALL.search(t))


def route_violations(traced) -> list[str]:
    return (pallas_primitives(traced.jaxpr)
            + kernel_custom_calls(traced.lower().as_text()))


def phase_route(p, b=BATCH, h=H, w=W):
    import jax

    from slowflow_tpu.variational.multiframe import _mt_pipeline_batched

    f = 2 * p.ref + 1
    args = [jax.ShapeDtypeStruct(s, np.float32) for s in
            ((b, h, w), (b, h, w), (b, f, 3, h, w), (b, 3, h, w), (b, 3),
             (b, 3))]
    t0 = time.perf_counter()
    traced = _mt_pipeline_batched.trace(*args, p=p)
    bad = route_violations(traced)
    emit("route", batch=b, height=h, width=w, kernel_calls=bad,
         trace_lower_s=time.perf_counter() - t0)
    check(not bad, f"kernel calls on the solve path: {bad}")


# -------------------------------------------------------------------- warp
def warp_reference(src, wx, wy, factor):
    """Four-corner bilinear warp in float64 with the reference's per-corner
    clamping and inside mask (variational_aux_mt.cpp:722-756)."""
    h, w = src.shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    x = xx + factor * wx.astype(np.float64)
    y = yy + factor * wy.astype(np.float64)
    x0, y0 = np.floor(x), np.floor(y)
    dx, dy = x - x0, y - y0
    xa = np.clip(x0.astype(int), 0, w - 1)
    xb = np.clip(x0.astype(int) + 1, 0, w - 1)
    ya = np.clip(y0.astype(int), 0, h - 1)
    yb = np.clip(y0.astype(int) + 1, 0, h - 1)
    s = src.astype(np.float64)
    out = ((1 - dy) * ((1 - dx) * s[..., ya, xa] + dx * s[..., ya, xb])
           + dy * ((1 - dx) * s[..., yb, xa] + dx * s[..., yb, xb]))
    mask = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return out, mask


def _time_ms(fn, *args, calls=20, trials=5):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / calls)
    return best * 1e3


def phase_warp(h=H, w=W, ref=2):
    """Gather warp on the card vs the float64 reference, and the time of
    the S=3 window warp."""
    import jax
    import jax.numpy as jnp

    from slowflow_tpu.core.warp import warp_bilinear
    from slowflow_tpu.variational.multiframe import warp_window_frames

    rng = np.random.default_rng(5)
    src = scene(1, h, w, 0.0, 0.0)[0].astype(np.float32)
    # multiples of 1/256 below 64 px: every sample coordinate is exact in
    # f32, so the comparison sees the gather and its weights and not the
    # f32 rounding of x + f*u (which the reference shares)
    yy, xx = np.mgrid[0:h, 0:w]
    wx = np.round((6 * np.sin(yy / 23) + rng.uniform(-2, 2, (h, w))) * 256) / 256
    wy = np.round((-4 * np.cos(xx / 37) + rng.uniform(-2, 2, (h, w))) * 256) / 256
    wx[:, :8] = -40.0                # a band of samples far outside
    wx = wx.astype(np.float32)
    wy = wy.astype(np.float32)
    warp = jax.jit(warp_bilinear, static_argnames="factor")
    worst, mask_ok = 0.0, True
    for factor in (-2.0, -1.0, 1.0, 2.0):
        got, m = warp(jnp.asarray(src), jnp.asarray(wx), jnp.asarray(wy),
                      factor=factor)
        want, wm = warp_reference(src, wx, wy, factor)
        worst = max(worst, float(np.abs(np.asarray(got) - want).max()))
        mask_ok &= bool(np.array_equal(np.asarray(m) > 0.5, wm))

    seq = jnp.asarray(np.stack(
        [scene(1, h, w, 0.0, 0.0, seed=s)[0]
         for s in range(2 * ref + 1)]).astype(np.float32))
    fx = jnp.asarray(1.5 + 0.3 * np.sin(yy / 40), jnp.float32)
    fy = jnp.asarray(-0.8 + 0.2 * np.cos(xx / 50), jnp.float32)
    gather = jax.jit(lambda s, u, v: warp_window_frames(s, u, v, ref)[0])
    emit("warp", height=h, width=w, max_abs_err=worst, masks_equal=mask_ok,
         bound=1e-3, window_frames=2 * ref + 1,
         gather_ms=_time_ms(gather, seq, fx, fy))
    check(worst <= 1e-3 and mask_ok, (worst, mask_ok))


# -------------------------------------------------------------------- bank
def phase_bank(h=H // 2, w=W // 2, K=16, J=5):
    """Stage-3 bank permutation and readback on the card vs NumPy."""
    import jax
    import jax.numpy as jnp

    from slowflow_tpu.tracking.driver import _bank_permute, _readback

    rng = np.random.default_rng(7)
    valid = rng.random((h, w, K)) < 0.7
    energy = rng.normal(0, 50, (h, w, K)).astype(np.float32)
    energy[~valid] = np.inf
    energy[0, 0, 0] = -np.inf
    bank = dict(flows=rng.normal(0, 30, (h, w, K, J, 2)).astype(np.float32),
                occl=rng.integers(0, 2, (h, w, K, J + 1)).astype(np.int32),
                energy=energy, valid=valid,
                jet_est=rng.integers(0, 3, (h, w, K)).astype(np.int32))
    order = np.argsort(rng.random((h, w, K)), axis=-1).astype(np.int32)
    got = jax.jit(_bank_permute)({k: jnp.asarray(v) for k, v in bank.items()},
                                 jnp.asarray(order))
    exact = True
    for k, a in bank.items():
        idx = order.reshape(order.shape + (1,) * (a.ndim - 3))
        exact &= bool(np.array_equal(np.asarray(got[k]),
                                     np.take_along_axis(a, idx, axis=2)))
    sel = rng.integers(0, K, (h, w)).astype(np.int32)
    flow, occ = jax.jit(partial(_readback, J=J, xy_incr=2.0))(
        jnp.asarray(bank["flows"]), jnp.asarray(bank["occl"]),
        jnp.asarray(sel))
    want_flow = np.take_along_axis(bank["flows"][:, :, :, J - 1],
                                   sel[..., None, None], axis=2)[:, :, 0] / 2.0
    want_occ = np.take_along_axis(bank["occl"].max(-1), sel[..., None],
                                  axis=2)[..., 0] > 0
    exact &= bool(np.array_equal(np.asarray(flow), want_flow))
    exact &= bool(np.array_equal(np.asarray(occ), want_occ))
    emit("bank", height=h, width=w, K=K, jets=J, exact=exact,
         take_along_axis_ms=_time_ms(
             jax.jit(_bank_permute),
             {k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(order)))
    check(exact, "bank permute/readback differ from take_along_axis")


# ------------------------------------------------------------------- level
def fixed_label_level(wx, wy, seq, channel_w, norm_avg, norm_std, labels, p):
    """compute_one_level with every occlusion update returning `labels`
    ({0, 1}, as the Potts solve does) instead of solving for them."""
    from unittest import mock

    from slowflow_tpu.variational import multiframe

    with mock.patch.object(multiframe, "solve_binary_potts",
                           lambda *a, **k: labels):
        return multiframe.compute_one_level(wx, wy, seq, channel_w, norm_avg,
                                            norm_std, p=p)


def phase_level(p, h=H, w=W):
    """One full-config pyramid level: the same program on the GPU and on
    the host CPU, in this process, from zero flow on the scene window.

    One linearisation step (derivatives, assembly, 30 SOR sweeps) agrees to
    float rounding, the sums running in another order: max |dflow| <= 1e-5
    px. Over the whole level that rounding is amplified twice. The
    occlusion labels are a discrete choice and about 1 % of them flip. With
    the labels held at the CPU's, what remains is the solve's own
    sensitivity: on the motion boundary the near-L1 data penalty
    (Charbonnier, eps 1e-3) makes the IRLS system ill-conditioned, and a
    few pixels there move by up to ~2 px; the CPU alone does the same under
    a 3e-7 relative perturbation of its input. So the pointwise bound,
    1e-2 px, holds for 99 % of pixels with the labels held (and the mean
    within 1e-3 px), and with the labels free each backend reaches the same
    accuracy: median end-point error against the scene's true flow within
    1e-2 px of the other's."""
    import dataclasses

    import jax

    from slowflow_tpu.variational.multiframe import compute_one_level

    seq, avg, std = scene_window(h, w)
    z = np.zeros((h, w), np.float32)
    args = (z, z, seq, np.ones((3, h, w), np.float32), avg, std)

    def run(fn, *extra):
        fn = jax.jit(fn)
        out = {}
        for name, dev in (("cpu", jax.devices("cpu")[0]),
                          ("gpu", jax.devices()[0])):
            placed = [jax.device_put(a, dev) for a in args + extra]
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(*placed))
            out[name] = [np.asarray(o) for o in res]
            out[name + "_s"] = time.perf_counter() - t0
        d = np.maximum(np.abs(out["gpu"][0] - out["cpu"][0]),
                       np.abs(out["gpu"][1] - out["cpu"][1]))
        return out, d

    _, d_step = run(partial(compute_one_level, p=dataclasses.replace(
        p, niter_alter=1, niter_outer=1)))
    full, d = run(partial(compute_one_level, p=p))
    g, c = full["gpu"], full["cpu"]
    labels = ((c[2] + 1.0) / 2.0).astype(np.float32)
    _, d_fixed = run(partial(fixed_label_level, p=p), labels)
    epes = {f"epe_{r}_{b}": e for b, o in (("gpu", g), ("cpu", c))
            for r, e in zip(("bg", "fg"), scene_epe(o[0], o[1]))}
    emit("level", height=h, width=w,
         step_max_abs_dflow_px=float(d_step.max()), step_bound_px=1e-5,
         max_abs_dflow_px=float(d.max()), mean_abs_dflow_px=float(d.mean()),
         p99_abs_dflow_px=float(np.percentile(d, 99)),
         occ_label_disagreement=float((g[2] != c[2]).mean()),
         fixed_labels_max_abs_dflow_px=float(d_fixed.max()),
         fixed_labels_mean_abs_dflow_px=float(d_fixed.mean()),
         fixed_labels_p99_abs_dflow_px=float(np.percentile(d_fixed, 99)),
         **epes, gpu_first_call_s=full["gpu_s"],
         cpu_first_call_s=full["cpu_s"])
    check(np.isfinite(g[0]).all() and np.isfinite(g[1]).all(),
          "non-finite flow on the GPU")
    check(d_step.max() <= 1e-5, float(d_step.max()))
    check(np.percentile(d_fixed, 99) <= 1e-2 and d_fixed.mean() <= 1e-3,
          (float(np.percentile(d_fixed, 99)), float(d_fixed.mean())))
    for r in ("bg", "fg"):
        check(abs(epes[f"epe_{r}_gpu"] - epes[f"epe_{r}_cpu"]) <= 1e-2, epes)


# ---------------------------------------------------------------- pipeline
def phase_pipeline(jets=10, finals=2, batch=BATCH):
    """The three CLIs on the seeded scene. Gates on the recovered flow vs
    the scene's ground truth: stage 2 within 0.1 px (the BASELINE.json
    budget), stage 3 within 0.15 px in final-grid units. The stage-2 error
    (~0.09 px) is the cfg's 10 occlusion/flow alternations stopping before
    they settle, which they do or not by the whole-window intensity
    normalisation, i.e. by the jet count; it is the same on the host CPU
    (0.0927 px there, 0.0928 px on the GPU for a 2-jet run), and with 15
    alternations it falls to ~0.003 px. Stage 3 chains five such jets."""
    from bench_pipeline import run_pipeline

    with tempfile.TemporaryDirectory() as tmp:
        res = run_pipeline(Path(tmp) / "run", jets=jets, finals=finals,
                           batch=batch)
    emit("pipeline", **res)
    check(res["sf_flow_err_px"] < 0.1, res["sf_flow_err_px"])
    check(res["dt_flow_err_px"] < 0.15, res["dt_flow_err_px"])


# -------------------------------------------------------------- four cards
def compare_jets(got, want):
    """Differences between two solves of the solve_args(b) jets: pointwise,
    and in per-jet median end-point error against the scene's truth."""
    got = [np.asarray(o) for o in got]
    want = [np.asarray(o) for o in want]
    d = np.maximum(np.abs(got[0] - want[0]), np.abs(got[1] - want[1]))
    gaps = [max(abs(x - y) for x, y in zip(scene_epe(got[0][i], got[1][i]),
                                          scene_epe(want[0][i], want[1][i])))
            for i in range(len(d))]
    return dict(bitwise_equal=all(np.array_equal(x, y)
                                  for x, y in zip(got, want)),
                max_abs_dflow_px=float(d.max()),
                mean_abs_dflow_px=float(d.mean()),
                p99_abs_dflow_px=float(np.percentile(d, 99)),
                occ_label_disagreement=float((got[2] != want[2]).mean()),
                max_epe_gap_px=float(max(gaps)))


def phase_four(p, b=8, h=H, w=W, n=4):
    """Stage-2 jets sharded over n cards with variational_mt_sharded
    (b // n per card, the path the slow_flow CLI takes with several
    devices), compared on card 0 with

    - the per-card program itself, b // n jets per call: the same
      arithmetic in another place, so bitwise equal (or within 1e-5 px);
    - variational_mt_batched on all b jets, the program a one-card user
      runs. It matched the per-card program bitwise on a one-card host, but
      not on the four-card host where it was compiled while another program
      ran (max 3.2 px, 0.3 % of occlusion labels, the amplification the
      level phase shows), so it is held to accuracy: per jet, the median
      end-point error against the scene's truth within 1e-2 px.

    The three run one after the other."""
    import jax

    from slowflow_tpu.parallel.mesh import make_mesh, shard_jet_batch
    from slowflow_tpu.variational.multiframe import (
        variational_mt_batched, variational_mt_sharded)

    devs = jax.devices()
    check(len(devs) >= n, f"--four needs {n} devices, found {len(devs)}")
    args = solve_args(b, h, w)
    mesh = make_mesh(n_jet=n, n_sp=1, devices=devs[:n])
    wx, wy, seq, cw, na, ns = shard_jet_batch(mesh, *args)
    one = [jax.device_put(a, devs[0]) for a in args]
    local = b // n

    def timed(fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, time.perf_counter() - t0

    def per_card():
        outs = [variational_mt_batched(*[a[i:i + local] for a in one[:3]], p,
                                       *[a[i:i + local] for a in one[3:]])
                for i in range(0, b, local)]
        return [np.concatenate([np.asarray(o[k]) for o in outs])
                for k in range(3)]

    sharded, t_sharded = timed(lambda: variational_mt_sharded(
        wx, wy, seq, p, mesh, cw, na, ns))
    homes = {s.device.id for s in sharded[0].addressable_shards}
    per_card_out, t_per_card = timed(per_card)
    one_card_out, t_one_card = timed(lambda: variational_mt_batched(
        *one[:3], p, *one[3:]))
    vs_per_card = compare_jets(sharded, per_card_out)
    vs_one_card = compare_jets(sharded, one_card_out)
    emit("four", batch=b, height=h, width=w, devices=n,
         shard_devices=sorted(homes), vs_per_card_program=vs_per_card,
         vs_one_card_program=vs_one_card, sharded_first_call_s=t_sharded,
         per_card_first_calls_s=t_per_card,
         one_card_first_call_s=t_one_card)
    check(len(homes) == n, homes)
    check(vs_per_card["bitwise_equal"]
          or vs_per_card["max_abs_dflow_px"] <= 1e-5, vs_per_card)
    check(vs_one_card["max_epe_gap_px"] <= 1e-2, vs_one_card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded solve check")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2

    from slowflow_tpu.utils.compile_cache import enable_compile_cache
    from slowflow_tpu.utils.device import card_name_and_power, device_info

    cache = enable_compile_cache()
    device = device_info()
    card = card_name_and_power()
    print(card, flush=True)
    emit("device", **device, card=card, compile_cache=cache)

    p = full_params()
    if args.four:
        phase_four(p)
    else:
        phase_route(p)
        phase_warp()
        phase_bank()
        phase_level(p)
        phase_pipeline()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
