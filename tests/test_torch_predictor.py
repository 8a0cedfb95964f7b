"""The port's Predictor.segment_tumor against the JAX package's, on the
same skull-stripped (zero-background) volume and the same trained
weights (tests/fixtures/ps2d_parity_params.npz, features (32,)), with a
small ROI so the crop is covered by several blended windows.

Labels must agree at >= 0.99 of the voxels (the forward drifts by a few
bf16 ulp, see test_torch_unet.py) and exactly outside the crop, where
both paste background.
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

from test_torch_unet import _fixture_variables

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
        inference=tcfg.InferenceConfig(roi_size=ROI)), seed=1,
        device="cpu")
    vol = _volume()
    labels = tp.segment_tumor(vol[..., 0])     # one modality, tiled
    assert labels.shape == vol.shape[:3] and labels.dtype == np.int8
    tp.load_seg_params(_fixture_variables()["params"])
    with pytest.raises(NotImplementedError):
        tp.segment_tumor(vol, mode="whole_volume")
