"""Mode coverage for the multi-frame energy: forward-only windows
(slow_flow_method forward -> one_direction) and the three smoothing schemes
(slow_flow_smoothing 0/1/2, variational_aux_mt.cpp:18-127)."""
import numpy as np
import jax.numpy as jnp
import pytest

from slowflow_tpu.variational import MultiFrameParams, variational_mt
from slowflow_tpu.variational.multiframe import compute_smoothness_mt
from slowflow_tpu.core.penalty import make_penalty


def _window(h, w, dx, dy, S, seed=3):
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


def test_one_direction_forward_window():
    """one_direction drops the past terms and still recovers the motion
    (variational_mt.cpp:92-93, 345-352)."""
    h, w, S = 36, 40, 3
    dx, dy = 0.8, -0.4
    seq = _window(h, w, dx, dy, S)
    p = MultiFrameParams(S=S, rho=(1.0, 1.0), omega=(0.0, 2.0),
                         layers=1, niter_alter=1, niter_outer=6,
                         occlusion_reasoning=False, one_direction=True)
    wx, wy, occ = variational_mt(jnp.zeros((h, w)), jnp.zeros((h, w)), seq, p)
    inner = (slice(8, -8), slice(8, -8))
    err = np.hypot(np.asarray(wx)[inner] - dx, np.asarray(wy)[inner] - dy)
    assert np.mean(err) < 0.35, np.mean(err)
    # occlusions init to "past" everywhere in forward mode
    assert (np.asarray(occ) == -1.0).all()


@pytest.mark.parametrize("method", [0, 1, 2])
def test_smoothing_methods(method):
    rng = np.random.default_rng(0)
    h, w = 12, 14
    uu = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
    vv = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
    dpsis = jnp.full((h, w), 0.5)
    pen = make_penalty(1, 0.001)
    wh, wv = compute_smoothness_mt(uu, vv, dpsis, 4.0, pen, method)
    wh = np.asarray(wh); wv = np.asarray(wv)
    assert (wh >= 0).all() and (wv >= 0).all()
    assert (wh[:, -1] == 0).all() and (wv[-1, :] == 0).all()
    if method == 2:
        # shared weight for both directions (interior)
        np.testing.assert_allclose(wh[:-1, :-1], wv[:-1, :-1])
    # smooth flow -> larger weights than rough flow
    wh_flat, _ = compute_smoothness_mt(uu * 0, vv * 0, dpsis, 4.0, pen, method)
    assert np.asarray(wh_flat)[:-1, :-1].mean() > wh[:-1, :-1].mean()


@pytest.mark.parametrize("method", [0, 2])
def test_multiframe_smoothing_variants_run(method):
    h, w, S = 32, 36, 2
    seq = _window(h, w, 1.0, 0.5, S)
    p = MultiFrameParams(S=S, rho=(1.0,), omega=(1.0,), layers=1,
                         niter_alter=1, niter_outer=4,
                         occlusion_reasoning=False, smoothing=method)
    wx, wy, _ = variational_mt(jnp.zeros((h, w)), jnp.zeros((h, w)), seq, p)
    inner = (slice(8, -8), slice(8, -8))
    err = np.hypot(np.asarray(wx)[inner] - 1.0, np.asarray(wy)[inner] - 0.5)
    assert np.mean(err) < 0.4, np.mean(err)


def test_batch_path_equivalence():
    """The two multi-jet batch routes must agree: the per-jet unroll
    (unroll_jets=True, the default) and jax.vmap over the batch
    (unroll_jets=False, the route under sharding). Same arithmetic per jet;
    vmap batches each convergence while_loop with masked per-jet semantics,
    so agreement is at float-reassociation level."""
    import dataclasses
    from slowflow_tpu.variational.multiframe import variational_mt_batched

    h, w, S, b = 32, 36, 2, 2
    seq = np.stack([_window(h, w, 1.0, 0.5, S, seed=7 + i) for i in range(b)])
    p = MultiFrameParams(S=S, rho=(1.0,), omega=(1.0,), layers=2,
                         p_scale=0.7, niter_alter=2, niter_outer=3,
                         occlusion_reasoning=True)
    z = jnp.zeros((b, h, w))
    wx_u, wy_u, occ_u = variational_mt_batched(z, z, seq, p)
    p_v = dataclasses.replace(p, unroll_jets=False)
    wx_v, wy_v, occ_v = variational_mt_batched(z, z, seq, p_v)
    np.testing.assert_allclose(np.asarray(wx_u), np.asarray(wx_v), atol=1e-5)
    np.testing.assert_allclose(np.asarray(wy_u), np.asarray(wy_v), atol=1e-5)
    assert (np.asarray(occ_u) != np.asarray(occ_v)).mean() < 0.01


def _potts_energy(lab, e0, e1, alpha):
    lab = lab.astype(bool)
    e = np.where(lab, e1, e0).sum()
    e += alpha * (lab[:, 1:] != lab[:, :-1]).sum()
    e += alpha * (lab[1:, :] != lab[:-1, :]).sum()
    return float(e)


def test_icm_potts_vs_global_optimum():
    """The reference solves the binary occlusion MRF exactly (one graph-cut,
    variational_aux_mt.cpp:758-887); red-black ICM must land at (or within a
    hair of) the same global energy in the data-dominated regime the solver
    runs in (occlusion_alpha = 0.1 vs O(1) data costs)."""
    from itertools import product
    from slowflow_tpu.variational.multiframe import solve_binary_potts

    rng = np.random.default_rng(0)
    h, w = 4, 4
    worst = 0.0
    for trial in range(20):
        e0 = rng.random((h, w)).astype(np.float32)
        e1 = rng.random((h, w)).astype(np.float32)
        alpha = 0.1
        lab = np.asarray(solve_binary_potts(jnp.asarray(e0), jnp.asarray(e1),
                                            alpha, 10))
        e_icm = _potts_energy(lab, e0, e1, alpha)
        best = min(_potts_energy(np.array(bits, np.float32).reshape(h, w),
                                 e0, e1, alpha)
                   for bits in product((0, 1), repeat=h * w))
        assert e_icm >= best - 1e-4
        worst = max(worst, (e_icm - best) / abs(best))
    # ICM lands within 2% of the global optimum in this regime
    assert worst < 0.02, worst


def test_icm_potts_smooth_regime_quality():
    """With strong smoothness the local optimum may differ from global; it
    must still not be worse than both trivial labelings (all-0 / all-1)."""
    from slowflow_tpu.variational.multiframe import solve_binary_potts

    rng = np.random.default_rng(1)
    h, w = 24, 28
    e0 = rng.random((h, w)).astype(np.float32)
    e1 = rng.random((h, w)).astype(np.float32)
    alpha = 2.0
    lab = np.asarray(solve_binary_potts(jnp.asarray(e0), jnp.asarray(e1),
                                        alpha, 20))
    e_icm = _potts_energy(lab, e0, e1, alpha)
    e_all0 = _potts_energy(np.zeros((h, w)), e0, e1, alpha)
    e_all1 = _potts_energy(np.ones((h, w)), e0, e1, alpha)
    assert e_icm <= min(e_all0, e_all1) + 1e-4
