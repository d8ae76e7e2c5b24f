import numpy as np
import jax.numpy as jnp
import pytest

from slowflow_tpu.core import (
    DERIV_5PT, DERIV_3PT, conv_horiz, conv_vert, gaussian_kernel,
    warp_bilinear, rgb_to_lab, saliency, make_penalty,
    sor_coupled_rb, sor_coupled_reference,
)
from slowflow_tpu.core.image import normalize_sequence, pyramid_sizes


# ------------------------------------------------------------------ convs
def _conv_ref(src, coeffs, axis):
    """Naive clamp-boundary correlation oracle."""
    src = np.asarray(src, np.float64)
    order = (len(coeffs) - 1) // 2
    out = np.zeros_like(src)
    n = src.shape[axis]
    for k, c in enumerate(coeffs):
        idx = np.clip(np.arange(n) + (k - order), 0, n - 1)
        out += c * np.take(src, idx, axis=axis)
    return out


def test_deriv_coeff_values():
    np.testing.assert_allclose(DERIV_5PT, [1 / 12, -8 / 12, 0, 8 / 12, -1 / 12])
    np.testing.assert_allclose(DERIV_3PT, [-0.5, 0, 0.5])


def test_deriv_is_positive_gradient():
    """On a ramp f(x) = 2x the 5-tap filter must return +2."""
    x = np.tile(2.0 * np.arange(16, dtype=np.float32), (4, 1))
    out = np.asarray(conv_horiz(jnp.asarray(x), DERIV_5PT))
    np.testing.assert_allclose(out[:, 2:-2], 2.0, atol=1e-5)


def test_conv_matches_oracle(rng):
    x = rng.random((5, 9)).astype(np.float32)
    for coeffs in (DERIV_5PT, DERIV_3PT, gaussian_kernel(1.1)):
        got_h = np.asarray(conv_horiz(jnp.asarray(x), coeffs))
        np.testing.assert_allclose(got_h, _conv_ref(x, coeffs, 1), atol=1e-5)
        got_v = np.asarray(conv_vert(jnp.asarray(x), coeffs))
        np.testing.assert_allclose(got_v, _conv_ref(x, coeffs, 0), atol=1e-5)


def test_gaussian_kernel_matches_reference():
    # image.c:310-348: order = floor(3*sigma)+1, normalized
    k = gaussian_kernel(1.0)
    assert len(k) == 2 * 4 + 1
    np.testing.assert_allclose(k.sum(), 1.0, atol=1e-6)
    assert k[4] == k.max()


# ------------------------------------------------------------------ warp
def test_warp_identity(rng):
    src = rng.random((3, 6, 8)).astype(np.float32)
    z = jnp.zeros((6, 8), jnp.float32)
    out, mask = warp_bilinear(jnp.asarray(src), z, z)
    np.testing.assert_allclose(np.asarray(out), src, atol=5e-5)
    np.testing.assert_array_equal(np.asarray(mask), 1.0)


def test_warp_integer_shift(rng):
    src = rng.random((1, 5, 7)).astype(np.float32)
    wx = jnp.full((5, 7), 1.0)
    wy = jnp.zeros((5, 7))
    out, mask = warp_bilinear(jnp.asarray(src), wx, wy)
    np.testing.assert_allclose(np.asarray(out)[0, :, :-1], src[0, :, 1:], atol=5e-5)
    m = np.asarray(mask)
    assert m[:, :-1].all() and (m[:, -1] == 0).all()


def test_warp_subpixel():
    src = jnp.asarray(np.arange(8, dtype=np.float32).reshape(1, 1, 8))
    wx = jnp.full((1, 8), 0.5)
    wy = jnp.zeros((1, 8))
    out, _ = warp_bilinear(src, wx, wy)
    np.testing.assert_allclose(np.asarray(out)[0, 0, :-1],
                               np.arange(7) + 0.5, atol=1e-6)


def test_warp_factor():
    src = jnp.asarray(np.arange(8, dtype=np.float32).reshape(1, 1, 8))
    wx = jnp.full((1, 8), 0.5)
    wy = jnp.zeros((1, 8))
    out, _ = warp_bilinear(src, wx, wy, factor=2.0)
    np.testing.assert_allclose(np.asarray(out)[0, 0, :-2],
                               np.arange(6) + 1.0, atol=1e-6)


# ------------------------------------------------------------------ lab
def test_rgb_to_lab_reference_values():
    """Compare with the reference scalar formula (image.c:694-726)."""
    def scalar_lab(r, g, b):
        r, g, b = r / 255.0, g / 255.0, b / 255.0
        T = 0.008856
        X = 0.412453 * r + 0.357580 * g + 0.180423 * b
        Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
        Z = 0.019334 * r + 0.119193 * g + 0.950227 * b
        X /= 0.950456
        Z /= 1.088754
        Y3 = Y ** (1 / 3)
        fX = X ** (1 / 3) if X > T else 7.787 * X + 16 / 116
        fY = Y3 if Y > T else 7.787 * Y + 16 / 116
        fZ = Z ** (1 / 3) if Z > T else 7.787 * Z + 16 / 116
        L = 116 * Y3 - 16 if Y > T else 903.3 * Y
        A = 500 * (fX - fY)
        B = 200 * (fY - fZ)
        c = np.exp(-1.5 * ((L / 100) ** 2 - 0.6) ** 2)
        return L, A * c, B * c

    rgb = np.array([[200.0, 30.0, 90.0], [5.0, 5.0, 5.0], [255.0, 255.0, 255.0]])
    im = rgb.T.reshape(3, 1, 3).astype(np.float32)  # [3, H=1, W=3]
    lab = np.asarray(rgb_to_lab(jnp.asarray(im)))
    for i, (r, g, b) in enumerate(rgb):
        L, A, B = scalar_lab(r, g, b)
        np.testing.assert_allclose(lab[:, 0, i], [L, A, B], rtol=2e-4, atol=2e-3)


def test_saliency_flat_is_zero():
    im = jnp.full((3, 16, 16), 100.0)
    s = np.asarray(saliency(im))
    np.testing.assert_allclose(s, 0.0, atol=1e-3)


def test_saliency_corner_positive():
    im = np.zeros((3, 20, 20), np.float32)
    im[:, 10:, 10:] = 200.0
    s = np.asarray(saliency(jnp.asarray(im)))
    assert s[10, 10] > s[2, 2] + 1.0  # corner has 2D structure


# ------------------------------------------------------------------ penalties
def test_penalties_match_formulas():
    s = np.array([0.0, 0.01, 1.0, 4.0])
    eps = 0.001
    p = make_penalty(1, eps)
    np.testing.assert_allclose(np.asarray(p.apply(s)), np.sqrt(s + eps * eps), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p.derivative(s)),
                               1 / (2 * np.sqrt(s + eps * eps)), rtol=1e-6)
    p = make_penalty(2, 0.05)
    np.testing.assert_allclose(np.asarray(p.apply(s)),
                               np.log(1 + 0.5 * s / 0.0025), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(p.derivative(s)),
                               1 / (2 * 0.0025 + s), rtol=1e-6)
    p = make_penalty(3, eps, 0.5)
    d = np.asarray(p.derivative(s))
    assert d[3] == 0.0 and d[1] > 0
    p = make_penalty(4, 0.05)
    np.testing.assert_allclose(np.asarray(p.apply(s)), s / (s + 1) ** 2, rtol=1e-6)
    p = make_penalty(0)
    np.testing.assert_allclose(np.asarray(p.derivative(s)), 1.0)


# ------------------------------------------------------------------ solver
def _random_spd_system(rng, h, w):
    a11 = rng.random((h, w)).astype(np.float32) + 1.0
    a22 = rng.random((h, w)).astype(np.float32) + 1.0
    a12 = (rng.random((h, w)).astype(np.float32) - 0.5) * 0.3
    b1 = rng.normal(size=(h, w)).astype(np.float32)
    b2 = rng.normal(size=(h, w)).astype(np.float32)
    wh = rng.random((h, w)).astype(np.float32) * 0.5
    wv = rng.random((h, w)).astype(np.float32) * 0.5
    wh[:, -1] = 0
    wv[-1, :] = 0
    return a11, a12, a22, b1, b2, wh, wv


def test_sor_converges_to_reference_fixpoint(rng):
    """Red-black and sequential SOR must agree at convergence."""
    h, w = 10, 12
    sys = _random_spd_system(rng, h, w)
    du0 = np.zeros((h, w), np.float32)
    dv0 = np.zeros((h, w), np.float32)
    ref_du, ref_dv = sor_coupled_reference(du0, dv0, *sys, iterations=400, omega=1.9)
    got_du, got_dv = sor_coupled_rb(
        jnp.asarray(du0), jnp.asarray(dv0), *[jnp.asarray(a) for a in sys],
        iterations=400, omega=1.9)
    np.testing.assert_allclose(np.asarray(got_du), ref_du, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got_dv), ref_dv, atol=1e-3)


def test_sor_solves_linear_system(rng):
    """The converged solution must satisfy the coupled linear system."""
    h, w = 8, 8
    a11, a12, a22, b1, b2, wh, wv = _random_spd_system(rng, h, w)
    du, dv = sor_coupled_rb(
        jnp.zeros((h, w)), jnp.zeros((h, w)),
        *[jnp.asarray(a) for a in (a11, a12, a22, b1, b2, wh, wv)],
        iterations=600, omega=1.9)
    du = np.asarray(du); dv = np.asarray(dv)
    # residual check at interior pixels
    for j in range(1, h - 1):
        for i in range(1, w - 1):
            sw = wv[j - 1, i] + wh[j, i - 1] + wv[j, i] + wh[j, i]
            nb_u = (wv[j - 1, i] * du[j - 1, i] + wh[j, i - 1] * du[j, i - 1]
                    + wv[j, i] * du[j + 1, i] + wh[j, i] * du[j, i + 1])
            nb_v = (wv[j - 1, i] * dv[j - 1, i] + wh[j, i - 1] * dv[j, i - 1]
                    + wv[j, i] * dv[j + 1, i] + wh[j, i] * dv[j, i + 1])
            r1 = (a11[j, i] + sw) * du[j, i] + a12[j, i] * dv[j, i] - (b1[j, i] + nb_u)
            r2 = a12[j, i] * du[j, i] + (a22[j, i] + sw) * dv[j, i] - (b2[j, i] + nb_v)
            assert abs(r1) < 1e-3 and abs(r2) < 1e-3


# ------------------------------------------------------------------ misc
def test_normalize_sequence():
    rng = np.random.default_rng(1)
    seq = rng.random((4, 3, 8, 8)).astype(np.float32) * 100 + 20
    out, avg, std = normalize_sequence(seq)
    for c in range(3):
        vals = out[:, c]
        assert abs(vals.mean()) < 1.0
        np.testing.assert_allclose(vals.std(), 255.0, rtol=0.05)


def test_pyramid_sizes():
    sizes = pyramid_sizes(100, 200, 5, 0.9)
    assert sizes[0] == (100, 200)
    assert len(sizes) == 5
    assert sizes[1] == (90, 180)
    assert sizes[2] == (81, 162)
    # tiny image stops early
    assert len(pyramid_sizes(6, 6, 5, 0.5)) < 5


def _warp_numpy(src, wx, wy, factor=1.0):
    """Four-corner bilinear oracle with the reference's per-corner clamping
    and inside mask (variational_aux_mt.cpp:722-756). Sample coordinates are
    formed in float32 like the reference's; the interpolation runs in
    float64."""
    src = np.asarray(src, np.float64)
    h, w = src.shape[-2:]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.float32(factor)
    x = (xx + f * np.asarray(wx, np.float32)).astype(np.float64)
    y = (yy + f * np.asarray(wy, np.float32)).astype(np.float64)
    x0 = np.floor(x)
    y0 = np.floor(y)
    dx, dy = x - x0, y - y0
    xa = np.clip(x0.astype(int), 0, w - 1)
    xb = np.clip(x0.astype(int) + 1, 0, w - 1)
    ya = np.clip(y0.astype(int), 0, h - 1)
    yb = np.clip(y0.astype(int) + 1, 0, h - 1)
    out = ((1 - dy) * ((1 - dx) * src[..., ya, xa] + dx * src[..., ya, xb])
           + dy * ((1 - dx) * src[..., yb, xa] + dx * src[..., yb, xb]))
    mask = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return out, mask.astype(np.float32)


def test_warp_banded_matches_full(rng):
    """Large smooth flows (the field the windowed one-hot warp was checked
    on): the gather warp must equal the full four-corner NumPy warp."""
    h, w = 160, 280
    src = rng.random((3, h, w)).astype(np.float32) * 255
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    wx = 30.0 + 8 * np.sin(yy / 30) + 4 * np.cos(xx / 50)
    wy = -18.0 + 6 * np.cos(xx / 40)
    got, mask = warp_bilinear(jnp.asarray(src), jnp.asarray(wx),
                              jnp.asarray(wy))
    want, want_mask = _warp_numpy(src, wx, wy)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(mask), want_mask)


@pytest.mark.parametrize("case", ["interior", "borders", "out_of_range",
                                  "factor"])
def test_warp_gather_matches_numpy(rng, case):
    """Gather warp vs the NumPy four-corner oracle on 0-255 images: within
    f32 rounding (1e-3), masks equal."""
    h, w = 23, 31
    src = rng.random((3, h, w)).astype(np.float32) * 255
    factor = 1.0
    if case == "interior":
        wx = rng.uniform(-1.5, 1.5, (h, w))
        wy = rng.uniform(-1.5, 1.5, (h, w))
    elif case == "borders":
        # push every sample onto or just past the frame edges
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        wx = np.where(xx < w / 2, -xx - 0.25, (w - 1) - xx + 0.25)
        wy = np.where(yy < h / 2, -yy, (h - 1) - yy)
    elif case == "out_of_range":
        wx = rng.uniform(-3 * w, 3 * w, (h, w))
        wy = rng.uniform(-3 * h, 3 * h, (h, w))
    else:
        wx = rng.uniform(-2, 2, (h, w))
        wy = rng.uniform(-2, 2, (h, w))
        factor = -2.5
    wx = wx.astype(np.float32)
    wy = wy.astype(np.float32)
    got, mask = warp_bilinear(jnp.asarray(src), jnp.asarray(wx),
                              jnp.asarray(wy), factor=factor)
    want, want_mask = _warp_numpy(src, wx, wy, factor)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(mask), want_mask)
    if case == "out_of_range":
        assert want_mask.mean() < 0.5       # most samples fall outside


def test_warp_backward():
    import jax.numpy as jnp
    from slowflow_tpu.core.warp import warp_backward

    src = jnp.asarray(np.arange(64, dtype=np.float32).reshape(1, 8, 8))
    flow = np.zeros((8, 8, 2), np.float32)
    flow[..., 0] = 1.0
    out = np.asarray(warp_backward(src, jnp.asarray(flow)))
    np.testing.assert_allclose(out[0, :, 1:], np.asarray(src)[0, :, :-1],
                               atol=1e-5)
