"""Device-mesh sharding for jet-parallel and spatially-sharded execution.

The reference is single-node OpenMP (SURVEY.md §2.3): the only parallel axes
are (a) independent jets and (b) SIMD lanes. This framework scales the same
axes across devices:

  - `jet` axis (DP): a batch of jet windows is sharded across devices; no
    cross-jet communication exists, so this is pure data parallelism.
  - `sp` axis (spatial): the H dimension of a single large image is sharded;
    the stencil ops (convolutions, SOR sweeps, warps) read halo rows, which
    XLA lowers to neighbour collectives automatically under jit with
    sharding constraints. This is an extension beyond the reference (needed
    only for frames exceeding one device's memory).

Statistics that cross the jet axis (sequence normalization, quantiles) are
plain reductions; everything else is per-jet local.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_jet: int | None = None, n_sp: int = 1, devices=None) -> Mesh:
    """Create a (jet, sp) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_jet is None:
        n_jet = n // n_sp
    assert n_jet * n_sp == n, (n_jet, n_sp, n)
    dev_array = np.array(devices).reshape(n_jet, n_sp)
    return Mesh(dev_array, axis_names=("jet", "sp"))


def shard_jet_batch(mesh: Mesh, *arrays, batch_axis: int = 0,
                    spatial_axis: int | None = None):
    """Place arrays with the batch axis sharded over `jet` (and optionally a
    spatial axis over `sp`)."""
    out = []
    for a in arrays:
        spec = [None] * a.ndim
        spec[batch_axis] = "jet"
        if spatial_axis is not None and mesh.shape["sp"] > 1:
            spec[spatial_axis] = "sp"
        out.append(jax.device_put(a, NamedSharding(mesh, P(*spec))))
    return tuple(out)


def sharded_jet_step(mesh: Mesh, params, spatial_shard: bool = False):
    """Jitted multi-device jet step: one `compute_one_level` pass over a
    batch of windows, with batch sharded over `jet` and (optionally) image
    rows over `sp`. Used by the multi-device dry run.
    """
    from functools import partial

    from ..variational.multiframe import compute_one_level

    fn = jax.vmap(partial(compute_one_level, p=params))

    def spec(*axes):
        return NamedSharding(mesh, P(*axes))

    sp = "sp" if spatial_shard else None
    in_shardings = (
        spec("jet", sp, None),                 # wx [B, H, W]
        spec("jet", sp, None),                 # wy
        spec("jet", None, None, sp, None),     # seq [B, F, 3, H, W]
        spec("jet", None, sp, None),           # channel_w [B, 3, H, W]
        spec("jet", None),                     # norm_avg [B, 3]
        spec("jet", None),                     # norm_std
    )
    out_shardings = (spec("jet", sp, None),) * 3
    return jax.jit(fn, in_shardings=in_shardings,
                   out_shardings=out_shardings)
