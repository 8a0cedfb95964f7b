"""The level-1 region (``ps2d_levels=2``) of the port against the JAX
package's, on the CPU: the port's kernels run their plain versions, the
JAX Pallas kernels run in interpret mode (as tests/test_ps2d.py runs
them).

  * K4 (``pool_into_halo``) against JAX ``pool_into_flat``, compared in
    the normal layout: bit-exact (a max is exact), and the output halo
    exactly zero.
  * The UNet3D eval forward at ``ps2d_levels=2`` against JAX's, with the
    same parameters moved over by the weight bridge, under the bounds of
    test_torch_unet.py's ``test_unet_eval_matches_jax``: max |d logit|
    <= 2^-5 * max(scale, 1), mean <= 2^-9 * max(scale, 1), labels agree
    at >= 0.99. Both sides must take the level-1 region: JAX's fused
    pool and the port's K4 wrapper are each counted, so a silent fall
    back to level 0 fails the test.
  * Which levels run in the regions: the port's ``halo_levels`` against
    the JAX forward's gate, exactly, except where a TPU kernel plan
    overflows its on-chip memory budget (a limit the port has not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, load_flax_params)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    unet3d as unet3d_module)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

from test_torch_ps2d import _bf16, _flat, _np
from test_torch_unet import flax_variables


@pytest.mark.parametrize("shape", [(1, 4, 8, 16, 32), (2, 6, 12, 8, 32),
                                   (1, 2, 16, 8, 64)])
def test_pool_into_halo_plain_matches_pool_into_flat(shape):
    rng = np.random.default_rng(11)
    B, D, H, W, C = shape
    x_np, x = _bf16(rng, shape)
    plan0 = J.make_ps2d_plan(H // 2, W // 2, C, C)
    plan1 = J.make_ps2d_plan(H // 4, W // 4, C, C)
    ref = J.flat_to_normal(J.pool_into_flat(_flat(x_np, plan0), plan0, plan1,
                                            interpret=True), plan1)
    y = T.pool_into_halo(T.pack_halo(x))
    assert tuple(y.shape) == (B, D // 2 + 2, H // 2 + 2, W // 2 + 2, C)
    np.testing.assert_array_equal(_np(T.halo_to_normal(y)), _np(ref))
    assert (_np(y) * (1 - _np(T.halo_mask(y)))).max() == 0


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("features", [(32, 64), (32, 64, 128)])
def test_unet_level2_matches_jax(monkeypatch, features):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 16, 4)).astype(np.float32)
    variables = flax_variables(UNet3D(features=features, seed=3,
                                      device="cpu"))
    # the JAX forward imports pool_into_flat from its module at trace
    # time, and reaches it only inside the level-1 region
    j_pools = _counting(monkeypatch, J, "pool_into_flat")
    jm = JUNet3D(out_channels=4, features=features, dtype=jnp.bfloat16,
                 ps2d_eval=True, ps2d_levels=2)
    ref = np.asarray(jax.jit(
        lambda v, a: jm.apply(v, a, train=False)["logits"])(
            variables, jnp.asarray(x)))
    assert j_pools, "JAX did not take the level-1 region"

    t_pools = _counting(monkeypatch, unet3d_module, "pool_into_halo")
    model = UNet3D(features=features, ps2d_eval=True, ps2d_levels=2,
                   device="cpu")
    model.load_state_dict(load_flax_params(variables))
    assert model.halo_levels(x.shape[1:4]) == 2
    out = model.eval()(torch.from_numpy(x)).numpy()
    assert len(t_pools) == 1, "the port did not take the level-1 region"

    assert out.shape == ref.shape and out.dtype == np.float32
    d = np.abs(out - ref)
    scale = max(np.abs(ref).max(), 1.0)
    assert d.max() <= 2 ** -5 * scale, (d.max(), scale)
    assert d.mean() <= 2 ** -9 * scale, (d.mean(), scale)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.99


def _jax_halo_levels(shape, features, levels=2):
    """The JAX UNet3D's eval gate (models/unet3d.py:593-614), plans
    included: 0, 1 or 2 levels in the ps2d regions."""
    D, H, W = shape
    f0 = features[0]
    if f0 % 32 or D % 2 or H % 2 or W % 2:
        return 0
    if (J.make_ps2d_plan_multi(H // 2, W // 2, (f0, f0), f0) is None
            or J.make_ps2d_plan(H // 2, W // 2, f0, f0) is None):
        return 0
    if not (levels >= 2 and len(features) >= 2 and features[1] % 32 == 0
            and D % 4 == 0 and H % 8 == 0 and W % 8 == 0):
        return 1
    f1 = features[1]
    dec = J.make_ps2d_plan_multi(H // 4, W // 4, (f1, f1), f1,
                                 vmem_budget=28 * 2 ** 20)
    enc = J.make_ps2d_plan(H // 4, W // 4, f0, f1)
    return 2 if dec is not None and enc is not None else 1


@pytest.mark.parametrize("shape,features,levels", [
    ((128, 128, 128), (32, 64, 128, 256, 512), 2),  # the serving window
    ((16, 16, 16), (32, 64), 2),
    ((8, 12, 16), (32, 64), 2),        # H % 8: level 0 only
    ((6, 8, 8), (32, 64), 2),          # D % 4: level 0 only
    ((16, 16, 16), (32, 64), 1),
    ((16, 16, 16), (16, 32), 2),       # width: no region
    ((16, 16, 16), (32, 48), 2),       # level-1 width: level 0 only
    ((16, 14, 16), (32,), 2),          # one level
])
def test_halo_levels_follow_the_jax_gate(shape, features, levels):
    model = UNet3D(features=features, ps2d_eval=True, ps2d_levels=levels,
                   device="cpu")
    assert model.halo_levels(shape) == _jax_halo_levels(shape, features,
                                                        levels)


def test_halo_levels_ignore_the_tpu_memory_budget():
    """The one difference from the JAX gate (ROADMAP.md, faults): JAX
    also drops a level whose TPU kernel plan overflows its on-chip
    memory budget, which happens only at widths far beyond any window
    or model size the port runs; the port keeps the region there."""
    shape = (8, 8, 4096)
    assert _jax_halo_levels(shape, (32, 64)) < 2
    assert UNet3D(features=(32, 64), ps2d_eval=True, ps2d_levels=2,
                  device="cpu").halo_levels(shape) == 2
