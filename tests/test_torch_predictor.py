"""The port's Predictor against the JAX package's, on the same
skull-stripped (zero-background) volume and the same weights (the
trained fixture tests/fixtures/ps2d_parity_params.npz, features (32,),
or seeded random weights of features (32, 64) for the level-1 region),
with a small ROI so the crop is covered by several blended windows.

The forward drifts by a few bf16 ulp (test_torch_unet.py), so:

  * labels agree at >= 0.99 of the voxels, exactly outside the crop
    (both paste background), and everywhere the reference's top-2 logit
    margin exceeds twice the largest logit drift (the margin contract);
  * a confidence (max softmax probability) moves by at most half the
    largest logit drift (each softmax output is 1/2-Lipschitz in the
    max norm of the logits), plus 1e-6 of f32 rounding; outside the
    crop it is exactly 1.0 on both sides;
  * mirror TTA averages 8 such forwards, so its probabilities move by
    at most half the largest drift over the 8 flips: held to the
    cropped run's bound with a factor 2 for the drift of the other
    flips;
  * classification: the same class, confidence within 2^-6 (the
    classifier's logits agree to a bf16 ulp, test_torch_classifier.py).
"""

import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import config as jcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference.predictor import (
    Predictor as JPredictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import config as tcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import cropping
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.predictor import (
    Predictor)

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    BrainTumorClassifier, UNet3D, UNet3DWithClassifier)

from test_torch_unet import _fixture_variables, flax_variables

ROI = (16, 16, 16)


def _volume():
    """(28, 44, 36, 4): an ellipsoid of tissue with a tumour blob, exact
    zeros outside (the fixture's blob task, in a brain)."""
    rng = np.random.default_rng(9)
    D, H, W = 28, 44, 36
    zz, yy, xx = np.ogrid[:D, :H, :W]
    brain = (((zz - 13) / 9) ** 2 + ((yy - 21) / 15) ** 2
             + ((xx - 18) / 11) ** 2) < 1
    vol = np.zeros((D, H, W, 4), np.float32)
    vol[brain] = rng.normal(0.0, 0.3, (int(brain.sum()), 4))
    blob = (((zz - 13) ** 2 + (yy - 18) ** 2 + (xx - 16) ** 2) < 9) & brain
    vol[blob] += np.asarray([1.0, 0.4, 0.4, 0.0], np.float32)
    return vol


@pytest.mark.parametrize("ps2d", [False, True])
def test_segment_tumor_cropped_matches_jax(ps2d):
    variables = _fixture_variables()
    inf = dict(roi_size=ROI, overlap=0.5, sw_batch_size=4,
               crop_bucket_ladder=())
    jp = JPredictor(
        jcfg.Config(model=jcfg.ModelConfig(features=(32,), ps2d_eval=ps2d),
                    data=jcfg.DataConfig(image_size=ROI),
                    inference=jcfg.InferenceConfig(**inf)),
        seg_variables=variables)
    tp = Predictor(
        tcfg.Config(model=tcfg.ModelConfig(features=(32,), ps2d_eval=ps2d),
                    inference=tcfg.InferenceConfig(**inf)),
        seg_variables=variables, device="cpu")
    vol = _volume()
    ref = jp.segment_tumor(vol, mode="cropped")
    got = tp.segment_tumor(vol, mode="cropped")
    assert got.shape == ref.shape == vol.shape[:3] and got.dtype == np.int8
    offs, bucket = cropping.plan_crop(vol, multiple=16, min_size=16)
    assert bucket == (32, 32, 32)           # 3 x 3 x 3 blended windows
    inside = np.zeros(vol.shape[:3], bool)
    inside[tuple(slice(o, o + b) for o, b in zip(offs, bucket))] = True
    np.testing.assert_array_equal(got[~inside], ref[~inside])
    assert (got == ref).mean() >= 0.99, (got != ref).mean()
    assert (ref > 0).any()                  # the tumour is found


def test_predictor_entry_points():
    if not torch.cuda.is_available():
        # the entry point defaults to the card and never falls back
        with pytest.raises(RuntimeError):
            Predictor(tcfg.Config(model=tcfg.ModelConfig(features=(32,))))
    tp = Predictor(tcfg.Config(
        model=tcfg.ModelConfig(features=(32,)),
        data=tcfg.DataConfig(image_size=ROI),
        inference=tcfg.InferenceConfig(roi_size=ROI)), seed=1,
        device="cpu")
    vol = _volume()
    labels = tp.segment_tumor(vol[..., 0])     # one modality, tiled
    assert labels.shape == vol.shape[:3] and labels.dtype == np.int8
    tp.load_seg_params(_fixture_variables()["params"])
    labels = tp.segment_tumor(vol, mode="whole_volume")
    assert labels.shape == vol.shape[:3] and labels.dtype == np.int8
    assert tp.classify_grade(vol) is None      # no joint weights yet


# ----------------------------------------------------------------------
# the server's request: segment_with_confidence, TTA, whole_volume,
# classify_tumor, classify_grade
# ----------------------------------------------------------------------

CASES = {
    # trained fixture, the level-0 region
    "fixture-levels1": dict(features=(32,), levels=1),
    # seeded random weights, the level-1 region (ps2d_levels=2)
    "random-levels2": dict(features=(32, 64), levels=2),
}


def _pair(case, ps2d=True, image_size=ROI):
    """(JAX Predictor, port Predictor) with the same weights."""
    c = CASES[case]
    seg = (_fixture_variables() if c["features"] == (32,) else
           flax_variables(UNet3D(features=c["features"], seed=6,
                                 device="cpu")))
    cls = flax_variables(BrainTumorClassifier(seed=7, device="cpu"))
    inf = dict(roi_size=ROI, overlap=0.5, sw_batch_size=4,
               crop_bucket_ladder=())
    model = dict(features=c["features"], ps2d_eval=ps2d,
                 ps2d_levels=c["levels"])
    jp = JPredictor(
        jcfg.Config(model=jcfg.ModelConfig(**model),
                    data=jcfg.DataConfig(image_size=image_size),
                    inference=jcfg.InferenceConfig(**inf)),
        seg_variables=seg, cls_variables={"params": cls["params"]})
    tp = Predictor(
        tcfg.Config(model=tcfg.ModelConfig(**model),
                    data=tcfg.DataConfig(image_size=image_size),
                    inference=tcfg.InferenceConfig(**inf)),
        seg_variables=seg, cls_variables={"params": cls["params"]},
        device="cpu")
    return jp, tp


def _drift(jp, tp, vol, mode):
    """(max |d logit|, reference top-2 margin) of one segmentation."""
    ref = np.asarray(jp._segment_logits(jp._canon(vol), mode)[0])
    got = tp._segment_logits(tp._canon(vol), mode)[0].numpy()
    top2 = np.sort(ref, axis=-1)
    return np.abs(got - ref).max(), top2[..., -1] - top2[..., -2]


def _crop_mask(vol):
    """(mask of the crop window in the volume, the window's slices in
    the crop: the bucket may reach past the volume's far edge)."""
    offs, bucket = cropping.plan_crop(vol, multiple=16, min_size=16)
    sl = tuple(slice(o, min(o + b, f))
               for o, b, f in zip(offs, bucket, vol.shape[:3]))
    inside = np.zeros(vol.shape[:3], bool)
    inside[sl] = True
    return inside, sl, tuple(slice(0, s.stop - s.start) for s in sl)


def test_classify_tumor_matches_jax():
    jp, tp = _pair("fixture-levels1")
    vol = _volume()
    for v in (vol, vol[..., :3]):          # 3 modalities: tiled to 4
        ref, got = jp.classify_tumor(v), tp.classify_tumor(v)
        assert got[0] == ref[0] and abs(got[1] - ref[1]) <= 2 ** -6, (
            got, ref)
    seg = tp.segment_tumor(vol, mode="cropped")
    assert (seg > 0).any()
    ref, got = jp.classify_tumor(vol, seg), tp.classify_tumor(vol, seg)
    assert got[0] == ref[0] and abs(got[1] - ref[1]) <= 2 ** -6
    none = np.zeros(vol.shape[:3], np.int8)
    assert tp.classify_tumor(vol, none) == jp.classify_tumor(vol, none) \
        == ("No Tumor Detected", 0.95)


def test_classify_grade_matches_jax():
    jp, tp = _pair("fixture-levels1")
    vol = _volume()
    assert tp.classify_grade(vol) is None and jp.classify_grade(vol) is None
    joint = UNet3DWithClassifier(features=(32,), seed=8, device="cpu")
    joint.unet.load_state_dict(tp.seg_model.state_dict())
    tree = flax_variables(joint)
    jp.load_joint_grade(tree["params"], tree["batch_stats"])
    tp.load_joint_grade(tree["params"], tree["batch_stats"])
    ref, got = jp.classify_grade(vol), tp.classify_grade(vol)
    assert isinstance(got[0], int) and got[0] == ref[0], (got, ref)
    assert abs(got[1] - ref[1]) <= 2 ** -6, (got, ref)
