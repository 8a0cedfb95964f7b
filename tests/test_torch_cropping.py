"""The port's crop planning and sliding-window helpers against the JAX
package's, on the same numpy inputs. Integer outputs (boxes, buckets,
offsets, crops, pasted maps, patch grids) must be bit-exact; the f32
blend of the sliding window agrees to f32 rounding (atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference import (
    cropping as jcrop, sliding_window as jsw)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    cropping as tcrop, sliding_window as tsw)


def _volume(kind, seed):
    rng = np.random.default_rng(seed)
    shape = (37, 45, 29, 4)
    if kind == "noise":
        return rng.normal(size=shape).astype(np.float32)
    vol = np.zeros(shape, np.float32)
    if kind == "empty":
        return vol
    lo = rng.integers(2, 10, 3)
    hi = lo + rng.integers(8, 19, 3)
    vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = rng.normal(
        1.0, 0.3, (*(hi - lo), 4))
    if kind == "zscored":           # constant nonzero background
        vol = vol - 0.7
    return vol


CASES = [("brain", 0, {}), ("brain", 1, {"ladder": (16, 32, 48)}),
         ("zscored", 2, {}), ("noise", 3, {}), ("empty", 4, {}),
         ("brain", 5, {"tol": 0.5}), ("brain", 6, {"background": "zero"}),
         ("brain", 7, {"multiple": 8, "min_size": 48})]


@pytest.mark.parametrize("kind,seed,kw", CASES)
def test_crop_plan_extract_paste_bit_exact(kind, seed, kw):
    vol = _volume(kind, seed)
    box_kw = {k: kw[k] for k in ("tol", "background") if k in kw}
    assert tcrop.nonzero_bbox(vol, **box_kw) == jcrop.nonzero_bbox(
        vol, **box_kw)
    assert tcrop.nonzero_bbox(vol[..., 0], **box_kw) == jcrop.nonzero_bbox(
        vol[..., 0], **box_kw)
    plan_t = tcrop.plan_crop(vol, **kw)
    plan_j = jcrop.plan_crop(vol, **kw)
    assert plan_t == plan_j
    offs, bucket = plan_t
    crop_t = tcrop.extract_crop(vol, offs, bucket)
    crop_j = jcrop.extract_crop(vol, offs, bucket)
    np.testing.assert_array_equal(crop_t, crop_j)
    labels = (crop_t[..., 0] > 0.5).astype(np.int8)
    np.testing.assert_array_equal(
        tcrop.paste_full(labels, offs, vol.shape[:3]),
        jcrop.paste_full(labels, offs, vol.shape[:3]))


@pytest.mark.parametrize("extent,full,ladder", [
    ((10, 100, 150), (240, 240, 155), None),
    ((150, 185, 140), (240, 240, 155), (96, 128, 160, 192, 224, 256)),
    ((250, 30, 70), (240, 240, 155), (96, 128)),
])
def test_bucket_and_offsets_bit_exact(extent, full, ladder):
    bt = tcrop.bucket_shape(extent, full, ladder=ladder)
    assert bt == jcrop.bucket_shape(extent, full, ladder=ladder)
    box = ((3, 7, 11), tuple(3 + e for e in extent))
    assert (tcrop.crop_offsets(box, bt, full)
            == jcrop.crop_offsets(box, bt, full))


def test_patch_grid_and_importance_map():
    for dim, roi, ov in [(160, 128, 0.5), (192, 128, 0.5), (100, 32, 0.25),
                         (20, 32, 0.5), (155, 128, 0.125)]:
        assert (tsw.compute_patch_starts(dim, roi, ov)
                == jsw.compute_patch_starts(dim, roi, ov))
    np.testing.assert_array_equal(
        tsw.gaussian_importance_map((16, 24, 8), 0.125),
        np.asarray(jsw.gaussian_importance_map((16, 24, 8), 0.125)))


@pytest.mark.parametrize("shape,roi,overlap,batch", [
    ((20, 28, 12, 3), (8, 8, 8), 0.5, 4),      # 3x6x2 windows, short group
    ((6, 9, 8, 3), (8, 8, 8), 0.5, 2),         # padded up to the roi
    ((8, 8, 8, 3), (8, 8, 8), 0.5, 4),         # single-window fast path
])
def test_sliding_window_blend_matches(shape, roi, overlap, batch):
    rng = np.random.default_rng(11)
    vol = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(shape[-1], 4)).astype(np.float32)
    ref = np.asarray(jsw.sliding_window_inference(
        jnp.asarray(w), jnp.asarray(vol), lambda p, x: x @ p,
        roi_size=roi, overlap=overlap, sw_batch_size=batch))
    wt = torch.from_numpy(w)
    got = tsw.sliding_window_inference(
        torch.from_numpy(vol), lambda x: x @ wt, roi_size=roi,
        overlap=overlap, sw_batch_size=batch).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
