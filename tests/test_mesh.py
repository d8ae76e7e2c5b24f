"""Multi-device mesh tests: jet DP and sp spatial sharding execute and agree
with the single-device result. Runs on the virtual 8-device CPU mesh forced
by conftest.py (skips when unavailable)."""
import jax
import numpy as np
import pytest

from slowflow_tpu.parallel.mesh import make_mesh, sharded_jet_step
from slowflow_tpu.variational.multiframe import (
    MultiFrameParams, compute_one_level)


def _inputs(b, s, h, w, seed=3):
    rng = np.random.default_rng(seed)
    f = 2 * (s - 1) + 1
    seq = rng.random((b, f, 3, h, w)).astype(np.float32) * 255.0
    wx = np.zeros((b, h, w), np.float32)
    wy = np.zeros((b, h, w), np.float32)
    cw = np.ones((b, 3, h, w), np.float32)
    na = np.zeros((b, 3), np.float32)
    ns = np.ones((b, 3), np.float32)
    return wx, wy, seq, cw, na, ns


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_spatial_sharding_matches_unsharded():
    """compute_one_level under a jet×sp mesh (n_sp=2, real halo exchange)
    must produce the same flow as the unsharded single-device run."""
    from functools import partial

    n = len(jax.devices())
    n_sp = 2
    n_jet = n // n_sp
    mesh = make_mesh(n_jet=n_jet, n_sp=n_sp)

    p = MultiFrameParams(S=2, rho=(1.0,), omega=(1.0,), layers=1,
                         niter_alter=2, niter_outer=2, niter_inner=1,
                         niter_solver=4, occlusion_reasoning=True)
    b, h, w = n_jet, 32, 40
    args = _inputs(b, 2, h, w)

    ref_fn = jax.jit(jax.vmap(partial(compute_one_level, p=p)))
    ref = ref_fn(*args)

    from jax.sharding import NamedSharding, PartitionSpec as P
    with mesh:
        step = sharded_jet_step(mesh, p, spatial_shard=True)
        wx, wy, seq, cw, na, ns = args
        put = jax.device_put
        sharded = (
            put(wx, NamedSharding(mesh, P("jet", "sp", None))),
            put(wy, NamedSharding(mesh, P("jet", "sp", None))),
            put(seq, NamedSharding(mesh, P("jet", None, None, "sp", None))),
            put(cw, NamedSharding(mesh, P("jet", None, "sp", None))),
            put(na, NamedSharding(mesh, P("jet", None))),
            put(ns, NamedSharding(mesh, P("jet", None))),
        )
        out = step(*sharded)
        out = jax.tree_util.tree_map(np.asarray, out)

    for a, b_ in zip(ref[:2], out[:2]):
        np.testing.assert_allclose(np.asarray(a), b_, rtol=0, atol=1e-4)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >=4 devices")
def test_dryrun_multichip_inprocess():
    """The dry run body executes directly when enough devices are live."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as g
    g._dryrun_body(len(jax.devices()))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_shard_map_jet_axis_bitwise_vs_single():
    """variational_mt_sharded (shard_map over jet, unrolled body per shard)
    must match the single-device unrolled pipeline BITWISE: the per-jet math
    is identical, only the placement differs. This pins sharded-vs-unsharded
    across device counts (1 vs 8)."""
    from slowflow_tpu.variational.multiframe import (
        variational_mt_batched, variational_mt_sharded)

    p = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), layers=2,
                         niter_alter=2, niter_outer=3, niter_solver=10,
                         occlusion_reasoning=True, smoothing=1)
    args = _inputs(8, 3, 48, 64)
    mesh = make_mesh(n_jet=8, n_sp=1)
    wx, wy, seq, cw, na, ns = args
    sharded = variational_mt_sharded(wx, wy, seq, p, mesh, cw, na, ns)
    single = variational_mt_batched(wx, wy, seq, p, cw, na, ns)
    for a, b, name in zip(sharded, single, ("wx", "wy", "occ")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
