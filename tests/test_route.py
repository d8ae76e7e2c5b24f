"""The solve runs one plain XLA route on every platform: no Pallas call
(compiled or interpreted) and no kernel custom call in the jitted pipeline.
The same check runs on the card as chip_smoke.py's route phase."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from slowflow_tpu.variational.multiframe import (  # noqa: E402
    MultiFrameParams, _mt_pipeline_batched, variational_mt_batched)

SMALL = MultiFrameParams(S=3, rho=(1.0, 1.0), omega=(0.0, 2.0), layers=2,
                         niter_alter=2, niter_outer=2, niter_solver=4,
                         occlusion_reasoning=True, smoothing=1)


def _specs(b, h, w, f=5):
    return [jax.ShapeDtypeStruct(s, jnp.float32) for s in
            ((b, h, w), (b, h, w), (b, f, 3, h, w), (b, 3, h, w), (b, 3),
             (b, 3))]


@pytest.mark.parametrize("unroll", [True, False])
def test_solve_has_no_kernel_calls(unroll):
    import dataclasses

    p = dataclasses.replace(SMALL, unroll_jets=unroll)
    traced = _mt_pipeline_batched.trace(*_specs(2, 24, 32), p=p)
    assert chip_smoke.route_violations(traced) == []


def test_route_check_flags_kernels():
    """Negative controls: a Pallas call in the program and a kernel custom
    call in a lowering are both caught."""
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    def fn(x):
        return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
            x.shape, x.dtype))(x)

    jaxpr = jax.make_jaxpr(fn)(jnp.ones((8, 128), jnp.float32))
    assert chip_smoke.pallas_primitives(jaxpr) == ["pallas_call"]
    hlo = ('%0 = stablehlo.custom_call @__gpu$xla.gpu.triton(%a)\n'
           '%1 = stablehlo.custom_call @tpu_custom_call(%b)\n'
           '%2 = stablehlo.custom_call @Sharding(%c)\n')
    assert chip_smoke.kernel_custom_calls(hlo) == [
        "__gpu$xla.gpu.triton", "tpu_custom_call"]


@pytest.mark.gpu
def test_one_linearisation_step_on_card_matches_cpu():
    """On the card: one outer iteration (warp, derivatives, assembly, SOR)
    agrees with the same program on the host CPU to float rounding — the
    sums run in another order. Longer solves amplify that rounding (see
    chip_smoke.py's level phase), so only the step is held pointwise."""
    import dataclasses

    p = dataclasses.replace(SMALL, layers=1, niter_alter=1, niter_outer=1)
    rng = np.random.default_rng(0)
    b, h, w = 2, 40, 48
    seq = rng.random((b, 5, 3, h, w)).astype(np.float32) * 255
    z = np.zeros((b, h, w), np.float32)
    outs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        args = [jax.device_put(a, dev) for a in (z, z, seq)]
        outs.append([np.asarray(o) for o in
                     variational_mt_batched(*args, p)])
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-5)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=1e-5)


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_fixed_label_level_holds_the_labels(label):
    """chip_smoke.py's level phase holds the occlusion labels with
    fixed_label_level: every occlusion update returns the given labels."""
    import dataclasses
    from functools import partial

    p = dataclasses.replace(SMALL, layers=1, niter_alter=3)
    h, w = 24, 32
    seq, avg, std = chip_smoke.scene_window(h, w)
    z = np.zeros((h, w), np.float32)
    labels = np.full((h, w), label, np.float32)
    fn = jax.jit(partial(chip_smoke.fixed_label_level, p=p))
    _, _, occ = fn(z, z, seq, np.ones((3, h, w), np.float32), avg, std,
                   labels)
    np.testing.assert_array_equal(np.asarray(occ), 2.0 * labels - 1.0)


def test_four_card_phase_on_virtual_devices(capsys):
    """chip_smoke.py --four on four virtual CPU devices: the shards land on
    four devices and the sharded solve matches both one-device programs."""
    import json

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual multi-device CPU mesh")
    chip_smoke.phase_four(SMALL, b=8, h=32, w=48)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["shard_devices"] == [0, 1, 2, 3]
    assert res["vs_per_card_program"]["bitwise_equal"]
    assert res["vs_one_card_program"]["max_epe_gap_px"] == 0.0
