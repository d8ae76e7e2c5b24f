"""Batched final-pair tracking must match the serial path.

The batched stage-3 path (track_final_pairs_batched) replaces the
reference's OpenMP-over-finals (dense_tracking.cpp:726-727) with a leading
F axis over vmapped alternation kernels. Every final seeds the same PRNG
stream a serial run would, so batched == serial up to float reassociation.
"""
import numpy as np

from slowflow_tpu.tracking.driver import (
    TrackingConfig, track_final_pair, track_final_pairs_batched)


def _job(u, v, seed, J=3, h=24, w=28):
    rng = np.random.default_rng(seed)
    fwd = np.zeros((J, h, w, 2), np.float32)
    fwd[..., 0] = u
    fwd[..., 1] = v
    fwd += rng.normal(0, 0.05, fwd.shape).astype(np.float32)
    bwd = (-fwd).astype(np.float32)
    base = rng.random((h, w)).astype(np.float32) * 255
    data = np.stack([base] * (J + 1))[..., None].repeat(3, -1)
    return dict(rate_flows=[(fwd, bwd, None)], forward=fwd, backward=bwd,
                occlusions=None, data=data,
                data_dx=np.zeros_like(data), data_dy=np.zeros_like(data),
                smooth_weight=np.full((h, w), 0.5, np.float32),
                epic_ctx=None)


CFG = TrackingConfig(
    jets=3, rates=1, skip_pixel=1, alternate=2, epic_interpolation=False,
    neigh_hyp=2, hyp_neigh_tryouts=4, trws_max_iter=5, capacity=8,
    acc_bc=0.0, acc_gc=0.0, seed=3)


def test_batched_matches_serial():
    jobs = [_job(1.0, 0.5, 0), _job(-0.7, 0.3, 1), _job(0.2, -0.9, 2)]
    wj = np.zeros(1, np.float32)

    serial = [track_final_pair(CFG, j["rate_flows"], j["forward"],
                               j["backward"], None, j["data"], j["data_dx"],
                               j["data_dy"], j["smooth_weight"], wj, None)
              for j in jobs]
    flows_b, occs_b, info = track_final_pairs_batched(CFG, jobs, wj)

    assert len(flows_b) == len(jobs)
    for (flow_s, occ_s, _), flow_b, occ_b in zip(serial, flows_b, occs_b):
        np.testing.assert_allclose(flow_b, flow_s, atol=1e-4)
        np.testing.assert_array_equal(occ_b, occ_s)
    # timing rows present for the CLI's result.info aggregation
    assert set(info["timing"]) >= {"warp", "data", "unary", "pairwise",
                                   "optimization"}
    assert len(info["variables"]) == CFG.alternate


def test_batched_single_job_falls_back():
    jobs = [_job(1.0, 0.5, 0)]
    wj = np.zeros(1, np.float32)
    flow_s, occ_s, _ = track_final_pair(
        CFG, jobs[0]["rate_flows"], jobs[0]["forward"], jobs[0]["backward"],
        None, jobs[0]["data"], jobs[0]["data_dx"], jobs[0]["data_dy"],
        jobs[0]["smooth_weight"], wj, None)
    flows_b, occs_b, _ = track_final_pairs_batched(CFG, jobs, wj)
    np.testing.assert_array_equal(flows_b[0], flow_s)
    np.testing.assert_array_equal(occs_b[0], occ_s)


def test_batched_threaded_init_matches():
    jobs = [_job(1.0, 0.5, 0), _job(-0.7, 0.3, 1)]
    wj = np.zeros(1, np.float32)
    f1, o1, _ = track_final_pairs_batched(CFG, jobs, wj, init_workers=0)
    f2, o2, _ = track_final_pairs_batched(CFG, jobs, wj, init_workers=2)
    for a, b in zip(f1, f2):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(a, b)


def _job_multirate(u, v, seed, J=3, h=24, w=28):
    """Two frame rates (2x jets on rate 1) + jet occlusion maps."""
    rng = np.random.default_rng(seed)

    def rate(jets, scale):
        fwd = np.zeros((jets, h, w, 2), np.float32)
        fwd[..., 0] = u * scale
        fwd[..., 1] = v * scale
        fwd += rng.normal(0, 0.05, fwd.shape).astype(np.float32)
        occ = np.zeros((jets, h, w), np.uint8)
        occ[:, : h // 8] = 255
        return fwd, (-fwd).astype(np.float32), occ

    f0, b0, o0 = rate(J, 1.0)
    f1, b1, o1 = rate(2 * J, 0.5)
    base = rng.random((h, w)).astype(np.float32) * 255
    data = np.stack([base] * (J + 1))[..., None].repeat(3, -1)
    return dict(rate_flows=[(f0, b0, o0), (f1, b1, o1)], forward=f0,
                backward=b0, occlusions=o0, data=data,
                data_dx=np.zeros_like(data), data_dy=np.zeros_like(data),
                smooth_weight=np.full((h, w), 0.5, np.float32),
                epic_ctx=None)


def test_batched_multirate_with_occlusions_matches_serial():
    cfg = TrackingConfig(
        jets=3, rates=2, skip_pixel=1, alternate=2, epic_interpolation=False,
        use_jet_occlusions=True, neigh_hyp=2, hyp_neigh_tryouts=4,
        trws_max_iter=5, capacity=8, acc_bc=0.0, acc_gc=0.0, seed=7)
    jobs = [_job_multirate(1.0, 0.5, 0), _job_multirate(-0.6, 0.4, 1)]
    wj = np.array([0.0, 1.0], np.float32)

    serial = [track_final_pair(cfg, j["rate_flows"], j["forward"],
                               j["backward"], j["occlusions"], j["data"],
                               j["data_dx"], j["data_dy"],
                               j["smooth_weight"], wj, None)
              for j in jobs]
    flows_b, occs_b, _ = track_final_pairs_batched(cfg, jobs, wj)
    for (flow_s, occ_s, _), flow_b, occ_b in zip(serial, flows_b, occs_b):
        np.testing.assert_allclose(flow_b, flow_s, atol=1e-4)
        np.testing.assert_array_equal(occ_b, occ_s)
