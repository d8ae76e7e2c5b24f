"""Stage-3 hypothesis-bank permutation and readback against NumPy
`take_along_axis`: both are exact gathers, so agreement is bitwise, ±inf
energy sentinels and UNKNOWN flow sentinels included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slowflow_tpu.tracking.driver import (
    _bank_permute, _bank_sort, _new_bank, _readback)
from slowflow_tpu.tracking.hypothesis import UNKNOWN

H, W, K, J = 6, 7, 16, 5


def _random_bank(rng):
    valid = rng.random((H, W, K)) < 0.7
    energy = rng.normal(0, 50, (H, W, K)).astype(np.float32)
    energy[~valid] = np.inf
    energy[0, 0, 3] = -np.inf
    flows = rng.normal(0, 20, (H, W, K, J, 2)).astype(np.float32)
    flows[~valid] = UNKNOWN
    return dict(
        flows=flows,
        occl=rng.integers(0, 2, (H, W, K, J + 1)).astype(np.int32),
        energy=energy,
        valid=valid,
        jet_est=rng.integers(0, 3, (H, W, K)).astype(np.int32),
    )


def _np_permute(bank, order):
    out = {}
    for k, a in bank.items():
        idx = order.reshape(order.shape + (1,) * (a.ndim - 3))
        out[k] = np.take_along_axis(a, idx, axis=2)
    return out


@pytest.mark.parametrize("jit", [False, True])
def test_bank_permute_matches_take_along_axis(rng, jit):
    bank = _random_bank(rng)
    order = np.argsort(rng.random((H, W, K)), axis=-1).astype(np.int32)
    fn = jax.jit(_bank_permute) if jit else _bank_permute
    got = fn({k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(order))
    want = _np_permute(bank, order)
    assert set(got) == set(want)
    for k in want:
        g = np.asarray(got[k])
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)
    assert np.isneginf(np.asarray(got["energy"])).sum() == 1


def test_bank_sort_orders_energy_with_sentinels_last(rng):
    bank = _random_bank(rng)
    out = _bank_sort({k: jnp.asarray(v) for k, v in bank.items()})
    e = np.where(bank["valid"], bank["energy"], np.inf)
    order = np.argsort(e, axis=-1, kind="stable")
    want = _np_permute(bank, order)
    for k in want:
        np.testing.assert_array_equal(np.asarray(out[k]), want[k], err_msg=k)
    # invalid slots keep their +inf sentinel and sit behind every valid one
    got_e = np.asarray(out["energy"])
    got_v = np.asarray(out["valid"])
    assert np.isposinf(got_e[~got_v]).all()
    assert (np.diff(got_v.astype(int), axis=-1) <= 0).all()


def test_readback_matches_take_along_axis(rng):
    bank = _random_bank(rng)
    selected = rng.integers(0, K, (H, W)).astype(np.int32)
    xy_incr = 2.0
    flow, occ = _readback(jnp.asarray(bank["flows"]),
                          jnp.asarray(bank["occl"]), jnp.asarray(selected),
                          J, xy_incr)
    idx = selected[..., None]
    want_flow = np.take_along_axis(bank["flows"][:, :, :, J - 1],
                                   idx[..., None], axis=2)[:, :, 0] / xy_incr
    want_occ = np.take_along_axis(bank["occl"].max(-1), idx, axis=2)[..., 0] > 0
    np.testing.assert_array_equal(np.asarray(flow), want_flow)
    np.testing.assert_array_equal(np.asarray(occ), want_occ)


def test_new_bank_shapes():
    bank = _new_bank(H, W, K, J)
    assert bank["flows"].shape == (H, W, K, J, 2)
    assert bank["occl"].shape == (H, W, K, J + 1)
    assert np.isposinf(np.asarray(bank["energy"])).all()
    assert not np.asarray(bank["valid"]).any()
