"""The port's UNet3D eval forward against the JAX package's, with the
same parameters moved over by the weight bridge, on the CPU (the port's
kernels run their plain versions, the JAX Pallas kernels interpret).

Bounds are those tests/test_ps2d.py holds the JAX ps2d forward to
against its normal forward: bf16 rounding happens at other places in
the two packages (XLA may keep an elementwise chain in f32 where torch
rounds each step), so logits drift by a few bf16 ulp:

  * random init: max |d logit| <= 2^-5 * max(scale, 1), mean <= 2^-9 *
    max(scale, 1), labels agree at >= 0.99;
  * the trained fixture (real margins): the margin contract — no label
    may differ where the reference's top-2 margin exceeds twice the
    max drift — and at most 1e-3 of the labels differ.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, load_flax_params, to_flax_variables)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "ps2d_parity_params.npz")


def _jax_logits(features, ps2d, variables, x):
    """The JAX eval forward, jitted (one compile instead of one per op)."""
    jm = JUNet3D(out_channels=4, features=features, dtype=jnp.bfloat16,
                 ps2d_eval=ps2d)
    fn = jax.jit(lambda v, a: jm.apply(v, a, train=False)["logits"])
    return np.asarray(fn(variables, jnp.asarray(x)))


def _port(variables, features, ps2d):
    model = UNet3D(features=features, ps2d_eval=ps2d, device="cpu")
    model.load_state_dict(load_flax_params(variables))
    return model.eval()


def flax_variables(model):
    """A port model's weights as the JAX model's variable tree (numpy).
    Cheaper than ``UNet3D.init``, which takes about a minute op by op on
    one CPU core."""
    return to_flax_variables(model.state_dict())


@pytest.mark.parametrize("ps2d", [False, True])
def test_unet_eval_matches_jax(ps2d):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 4, 16, 24, 4)).astype(np.float32)
    variables = flax_variables(UNet3D(features=(32, 64), seed=3,
                                      device="cpu"))
    ref = _jax_logits((32, 64), ps2d, variables, x)
    out = _port(variables, (32, 64), ps2d)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    d = np.abs(out - ref)
    scale = max(np.abs(ref).max(), 1.0)
    assert d.max() <= 2 ** -5 * scale, (d.max(), scale)
    assert d.mean() <= 2 ** -9 * scale, (d.mean(), scale)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.99


def _fixture_variables():
    data = np.load(FIXTURE)
    tree = {}
    for key in data.files:
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


@pytest.mark.parametrize("ps2d", [False, True])
def test_trained_fixture_margin_contract(ps2d):
    variables = _fixture_variables()
    rng = np.random.default_rng(5)
    # in-distribution input for the fixture's blob task (real margins)
    x = np.asarray(rng.normal(0.0, 0.3, (1, 8, 24, 16, 4)), np.float32)
    zz, yy, xx = np.ogrid[:8, :24, :16]
    blob = ((zz - 4) ** 2 + (yy - 10) ** 2 + (xx - 8) ** 2) < 9
    x[0][blob] += np.asarray([1.0, 0.4, 0.4, 0.0], np.float32)
    ref = _jax_logits((32,), ps2d, variables, x)
    out = _port(variables, (32,), ps2d)(torch.from_numpy(x)).numpy()
    d = np.abs(out - ref)
    assert d.max() <= 2 ** -5 * max(np.abs(ref).max(), 1.0), d.max()
    top2 = np.sort(ref, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    assert np.median(margin) > 2.0, np.median(margin)    # fixture sane
    dis = out.argmax(-1) != ref.argmax(-1)
    assert dis.mean() <= 1e-3, dis.mean()
    assert not (dis & (margin > 2 * d.max())).any(), (
        margin[dis].max(), d.max())


def test_weight_bridge_covers_the_tree():
    """Every JAX parameter and batch statistic lands on a port tensor of
    the same shape, and nothing of the port is left out."""
    variables = _fixture_variables()
    state = load_flax_params(variables)
    model = UNet3D(features=(32,), device="cpu")
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    np.testing.assert_array_equal(
        state["down0.conv1.kernel"].numpy(),
        variables["params"]["down0"]["conv1"]["kernel"])


def test_unported_options_raise():
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import config as tcfg
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.predictor import (
        Predictor)
    # float32 with the ps2d region is no longer refused: it runs on the
    # kernels' f32 forms (their plain versions here) and in the region
    pred = Predictor(tcfg.Config(
        model=tcfg.ModelConfig(features=(32, 64), compute_dtype="float32",
                               ps2d_eval=True),
        data=tcfg.DataConfig(image_size=(16, 16, 16))), device="cpu")
    assert pred.seg_model.halo_levels((16, 16, 16)) == 1
    lab = pred.segment_tumor(np.zeros((8, 8, 8, 4), np.float32),
                             mode="whole_volume")
    assert lab.shape == (8, 8, 8)
    model = UNet3D(features=(32, 64), device="cpu")
    # fewer than 2**levels voxels on an axis
    with pytest.raises(ValueError):
        model(torch.zeros((1, 2, 8, 8, 4)))


def test_unet_odd_levels_match_jax():
    """Interior levels that do not double back are reconciled with
    resize_trilinear (decoder input and attention-gate signal), as in
    JAX; bounds of test_unet_eval_matches_jax."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 4, 6, 10, 4)).astype(np.float32)
    variables = flax_variables(UNet3D(features=(32, 64), seed=4,
                                      device="cpu"))
    ref = _jax_logits((32, 64), False, variables, x)
    out = _port(variables, (32, 64), False)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 4, 6, 10, 4)
    d = np.abs(out - ref)
    scale = max(np.abs(ref).max(), 1.0)
    assert d.max() <= 2 ** -5 * scale, (d.max(), scale)
    assert d.mean() <= 2 ** -9 * scale, (d.mean(), scale)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.99


def test_level2_ineligible_shape_stays_at_level0(monkeypatch):
    """ps2d_levels=2 on a shape whose level 1 is ineligible (H % 8 != 0):
    both packages run the level-0 region only, and agree."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 8, 12, 16, 4)).astype(np.float32)
    variables = flax_variables(UNet3D(features=(32, 64), seed=5,
                                      device="cpu"))
    calls = []
    real = J.pool_into_flat
    monkeypatch.setattr(J, "pool_into_flat",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jm = JUNet3D(out_channels=4, features=(32, 64), dtype=jnp.bfloat16,
                 ps2d_eval=True, ps2d_levels=2)
    ref = np.asarray(jax.jit(
        lambda v, a: jm.apply(v, a, train=False)["logits"])(
            variables, jnp.asarray(x)))
    assert not calls
    model = UNet3D(features=(32, 64), ps2d_eval=True, ps2d_levels=2,
                   device="cpu")
    model.load_state_dict(load_flax_params(variables))
    assert model.halo_levels(x.shape[1:4]) == 1
    out = model.eval()(torch.from_numpy(x)).numpy()
    d = np.abs(out - ref)
    scale = max(np.abs(ref).max(), 1.0)
    assert d.max() <= 2 ** -5 * scale, (d.max(), scale)
    assert d.mean() <= 2 ** -9 * scale, (d.mean(), scale)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.99
