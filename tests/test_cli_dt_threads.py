"""dense_tracking CLI with -threads N (host prefetch pool) and
-batch_finals N (opt-in leading-F-axis batching, not implied by -threads):
both must
produce the same outputs as the serial path (reference analogue: OpenMP over
start_jet, dense_tracking.cpp:726-727)."""
import os
import textwrap

import numpy as np
import pytest

from slowflow_tpu.io import read_flo, write_flo
from slowflow_tpu.io.images import read_pbm, write_image

U, V = 0.8, -0.4
H, W = 36, 44
FINALS = 3
JETS = 2          # jet_fps 40 / (ref_fps 20 * steps 1)
N_FRAMES = FINALS * JETS + 1


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dt_threads")
    seq = tmp / "seq"
    est = tmp / "est"
    seq.mkdir()
    est.mkdir()

    rng = np.random.default_rng(11)
    pad = 24
    base = rng.random((H + 2 * pad, W + 2 * pad, 3)) * 255
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda r: np.convolve(r, k, "same"), ax, base)
    base = (base - base.min()) / (base.max() - base.min()) * 255

    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(N_FRAMES):
        xs = xx + pad - f * U
        ys = yy + pad - f * V
        x0 = np.floor(xs).astype(int)
        y0 = np.floor(ys).astype(int)
        fx = (xs - x0)[..., None]
        fy = (ys - y0)[..., None]
        img = (base[y0, x0] * (1 - fx) * (1 - fy)
               + base[y0, x0 + 1] * fx * (1 - fy)
               + base[y0 + 1, x0] * (1 - fx) * fy
               + base[y0 + 1, x0 + 1] * fx * fy)
        write_image(seq / f"frame_{f:03d}.png", img)

    # per-jet flow estimations with slight noise (what slow_flow would emit)
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = U
    flow[..., 1] = V
    for f in range(N_FRAMES - 1):
        n = rng.normal(0, 0.02, flow.shape).astype(np.float32)
        write_flo(est / f"frame_{f:03d}.flo", flow + n)
        write_flo(est / f"frame_{f + 1:03d}_back.flo", -flow + n)
    (est / "config.cfg").write_text(
        "# snapshot\nslow_flow_S\t2\njet_fps\t40\n")
    return tmp, seq, est


def _cfg(tmp, seq, est, out):
    cfg = tmp / f"{os.path.basename(out)}.cfg"
    cfg.write_text(textwrap.dedent(f"""\
    file\t{seq}/frame_%03i.png
    jet_estimation\t{est}/
    flow_format\tframe_%03i
    output\t{tmp}/{out}
    start\t0
    max_fps\t40
    ref_fps\t20
    ref_fps_F\t{FINALS}
    16bit\t0
    raw\t0
    scale\t1.0
    acc_skip_pixel\t0
    acc_occlusion\t0
    acc_epic_interpolation\t1
    acc_epic_skip\t2
    acc_alternate\t2
    acc_trws_max_iter\t5
    acc_neigh_hyp\t2
    acc_hyp_neigh_tryouts\t4
    acc_capacity\t8
    seed\t5
    """))
    return cfg


def test_threads_matches_serial(dataset):
    from slowflow_tpu.cli.dense_tracking import main

    tmp, seq, est = dataset
    assert main([str(_cfg(tmp, seq, est, "serial"))]) == 0
    assert main([str(_cfg(tmp, seq, est, "threaded")), "-threads", "2",
                "-batch_finals", "2"]) == 0

    for k in range(FINALS):
        n = k * JETS
        f_s = tmp / "serial" / f"frame_{n:03d}.flo"
        f_t = tmp / "threaded" / f"frame_{n:03d}.flo"
        assert f_s.exists() and f_t.exists(), (k, f_s, f_t)
        flow_s = read_flo(f_s)
        flow_t = read_flo(f_t)
        np.testing.assert_allclose(flow_t, flow_s, atol=1e-4)
        occ_s = read_pbm(tmp / "serial" / "occlusions" / f"frame_{n}.pbm")
        occ_t = read_pbm(tmp / "threaded" / "occlusions" / f"frame_{n}.pbm")
        np.testing.assert_array_equal(occ_t, occ_s)
        # accuracy: final flow = Jets * (U, V)
        inner = (slice(8, -8), slice(8, -8))
        err = np.hypot(flow_t[inner][..., 0] - JETS * U,
                       flow_t[inner][..., 1] - JETS * V)
        assert err.mean() < 0.6, (k, err.mean())

    # result.info aggregates one Variables/Factors entry per alternation
    # per final in both modes
    info_s = (tmp / "serial" / "result.info").read_text()
    info_t = (tmp / "threaded" / "result.info").read_text()
    row = [ln for ln in info_s.splitlines() if ln.startswith("\tVariables:")]
    row_t = [ln for ln in info_t.splitlines() if ln.startswith("\tVariables:")]
    assert len(row[0].split("\t")) == len(row_t[0].split("\t"))


def test_threads_resume_skips(dataset):
    from slowflow_tpu.cli.dense_tracking import main

    tmp, seq, est = dataset
    # second threaded run against the existing output must skip every final
    rc = main([str(_cfg(tmp, seq, est, "threaded")), "-threads", "2",
               "-batch_finals", "2",
               "-output", str(tmp / "threaded"), "-resume"])
    assert rc == 0
