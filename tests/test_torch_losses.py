"""The port's losses, Dice metrics, nearest resize and EDT/Hausdorff
against the JAX package's, on the CPU, on the same seeded inputs.

  * every loss of ``losses.py`` on f32 logits: within 1e-5 relative
    (f32 sums of the same terms in another order);
  * ``resize_nearest``: bit-exact (the same float32 index arithmetic);
  * ``per_class_dice``, ``mean_foreground_dice``, ``region_dice``: within
    1e-6 (counts of the same integer labels);
  * ``edt_squared``: bit-exact (the same float32 additions and minima);
    ``hausdorff_distance_device`` within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import losses as JL
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import metrics as JM
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops import edt as JE
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.resize import (
    resize_nearest as j_resize_nearest)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import losses as TL
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import metrics as TM
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import edt as TE
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.resize import (
    resize_nearest)


def _case(seed, shape=(2, 6, 8, 10), c=4, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(*shape, c)) * scale).astype(np.float32)
    targets = rng.integers(0, c, size=shape).astype(np.int32)
    return logits, targets


def _close(got, want, rel=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(abs(want), 1e-6), (got, want)


LOSSES = {
    "softmax_dice_loss": lambda m: m.softmax_dice_loss,
    "cross_entropy_loss": lambda m: m.cross_entropy_loss,
    "focal_loss": lambda m: m.focal_loss,
    "focal_loss(0.25, 3)": lambda m: lambda a, b: m.focal_loss(a, b, 0.25,
                                                               3.0),
    "combined_loss": lambda m: m.combined_loss,
    "combined_loss(0.2, 0.5, 0.3)": lambda m: lambda a, b: m.combined_loss(
        a, b, (0.2, 0.5, 0.3), 0.5, 1.5),
    "boundary_loss": lambda m: m.boundary_loss,
    "combined_loss3d": lambda m: lambda a, b: m.combined_loss3d(a, b)[0],
    "tversky_loss": lambda m: m.tversky_loss,
    "DiceLoss": lambda m: m.DiceLoss(),
    "FocalLoss": lambda m: m.FocalLoss(),
    "CombinedLoss": lambda m: m.CombinedLoss(),
    "CombinedLoss3D": lambda m: lambda a, b: m.CombinedLoss3D()(a, b)[0],
    "TverskyLoss3D": lambda m: m.TverskyLoss3D(),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(name):
    logits, targets = _case(1)
    want = LOSSES[name](JL)(jnp.asarray(logits), jnp.asarray(targets))
    got = LOSSES[name](TL)(torch.from_numpy(logits),
                           torch.from_numpy(targets).long())
    assert got.dtype == torch.float32 and got.ndim == 0
    _close(got, want)


def test_combined_loss3d_parts_match_jax():
    logits, targets = _case(2)
    _, want = JL.combined_loss3d(jnp.asarray(logits), jnp.asarray(targets))
    _, got = TL.combined_loss3d(torch.from_numpy(logits),
                                torch.from_numpy(targets).long())
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_loss_gradient_matches_jax():
    """d combined_loss / d logits: the train step's first cotangent."""
    logits, targets = _case(3)
    want = jax.grad(JL.combined_loss)(jnp.asarray(logits),
                                      jnp.asarray(targets))
    x = torch.from_numpy(logits).requires_grad_()
    TL.combined_loss(x, torch.from_numpy(targets).long()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-9)


@pytest.mark.parametrize("weights", [(1.0, 0.8, 0.6, 0.4), (1.0, 0.5)])
def test_deep_supervision_loss_native_scale(weights):
    """Deep heads at their native scales (full, 1/2, 1/4 and one past the
    weights): targets nearest-resized per head, as JAX does."""
    rng = np.random.default_rng(4)
    shape = (2, 8, 12, 16)
    logits = rng.normal(size=(*shape, 4)).astype(np.float32)
    targets = rng.integers(0, 4, size=shape).astype(np.int32)
    deep = [rng.normal(size=(2, 8 // f, 12 // f, 16 // f, 4)).astype(
        np.float32) for f in (1, 2, 4, 8)]
    want = JL.deep_supervision_loss(
        jnp.asarray(logits), [jnp.asarray(d, jnp.bfloat16) for d in deep],
        jnp.asarray(targets), weights)
    got = TL.deep_supervision_loss(
        torch.from_numpy(logits),
        [torch.from_numpy(d).to(torch.bfloat16) for d in deep],
        torch.from_numpy(targets).long(), weights)
    _close(got, want)
    shim = TL.DeepSupervisionLoss3D(weights, TL.combined_loss)
    _close(shim({"logits": torch.from_numpy(logits),
                 "deep": [torch.from_numpy(d).to(torch.bfloat16)
                          for d in deep]},
                torch.from_numpy(targets).long()), want)


@pytest.mark.parametrize("src,dst", [
    ((8, 12, 16), (4, 6, 8)),       # the deep heads' halvings
    ((8, 12, 16), (1, 3, 2)),
    ((7, 9, 10), (3, 4, 7)),        # uneven ratios
    ((5, 6, 7), (11, 13, 3)),       # upsampling
    ((6, 6, 6), (6, 6, 6)),
])
def test_resize_nearest_bit_exact(src, dst):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1000, size=(2, *src, 3)).astype(np.int32)
    want = np.asarray(j_resize_nearest(jnp.asarray(x), dst))
    got = resize_nearest(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_dice_metrics_match_jax():
    rng = np.random.default_rng(6)
    pred = rng.integers(0, 4, size=(2, 6, 8, 10))
    # a target that overlaps the prediction: most labels kept
    target = np.where(rng.random(pred.shape) < 0.7, pred,
                      rng.integers(0, 4, size=pred.shape))
    logits = rng.normal(size=(*pred.shape, 4)).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    np.testing.assert_allclose(
        TM.per_class_dice(tp, tt).numpy(),
        np.asarray(JM.per_class_dice(pred, target)), atol=1e-6)
    for a, b in ((tp, pred), (torch.from_numpy(logits), logits)):
        _close(TM.mean_foreground_dice(a, tt),
               JM.mean_foreground_dice(b, target), rel=1e-6)
    got, want = TM.region_dice(tp, tt), JM.region_dice(pred, target)
    assert set(got) == set(want) == {"WT", "TC", "ET"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    # an absent class: Dice 0 with eps, no NaN
    d = TM.per_class_dice(torch.zeros(10, dtype=torch.long),
                          torch.zeros(10, dtype=torch.long))
    assert torch.isfinite(d).all() and float(d[0]) == pytest.approx(1.0)


def test_edt_bit_exact():
    rng = np.random.default_rng(7)
    mask = rng.random((9, 12, 40)) < 0.02
    want = np.asarray(JE.edt_squared(jnp.asarray(mask)))
    got = TE.edt_squared(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("percentile", [95.0, 100.0])
def test_hausdorff_matches_jax(percentile):
    rng = np.random.default_rng(8)
    zz, yy, xx = np.ogrid[:12, :16, :20]
    a = ((zz - 6) ** 2 + (yy - 8) ** 2 + (xx - 9) ** 2) < 20
    b = a ^ (rng.random(a.shape) < 0.03)
    want = float(JE.hausdorff_distance_device(
        jnp.asarray(a), jnp.asarray(b), percentile=percentile))
    got = TE.hausdorff_distance_device(
        torch.from_numpy(a), torch.from_numpy(b), percentile=percentile)
    assert got.dtype == torch.float32
    _close(got, want, rel=1e-6)
    empty = TE.hausdorff_distance_device(torch.from_numpy(a),
                                         torch.zeros(a.shape, dtype=bool))
    assert float(empty) == float("inf")
