"""The public names the port had still missing, against their JAX
counterparts on the CPU:

* ``metrics.LossMetrics`` (sigmoid Dice, focal, their combination) and
  ``metrics.SegmentationMetrics`` (the binary metrics as floats) on the
  inputs of tests/test_metrics.py and tests/test_parity_utils.py, within
  1e-6 relative, and the facade's methods that
  tests/test_api_surface.py asks of JAX's;
* ``utils.mesh.voxel_surface_mesh`` / ``mesh_surface_area``: the same
  vertices, faces and area as JAX's;
* ``inference.sliding_window.make_sw_predictor`` with a
  ``set_variables`` swap, against JAX's on the same weights (f32,
  ``atol 1e-4``);
* ``ops.conv.conv3d_zsum`` against ``conv3d_zcat`` (f32: 1e-5 of the
  output's scale; bf16: the per-tap roundings, 2^-7) and JAX's (f32,
  1e-5; bf16 within 1 bf16 ulp of the scale);
* ``train.trainer.batch_num_classes``;
* every name exported by JAX's ``__init__.py`` files, importable from the
  port's package of the same path (``ops.conv3d_form``, a TPU conv
  formulation picker, excepted; ``inference``'s int8 calibration is not
  ported).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import (
    metrics as JM)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference.sliding_window import (
    make_sw_predictor as j_make_sw_predictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops import (
    conv as jconv)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train.trainer import (
    batch_num_classes as j_batch_num_classes)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.utils import (
    mesh as jmesh)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
    metrics as TM)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.sliding_window import (
    make_sw_predictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import (
    conv as tconv)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.trainer import (
    batch_num_classes)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.utils import (
    mesh as tmesh)

JAX_PKG = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu"
PORT = JAX_PKG + "_torch"


@pytest.fixture
def masks():
    rng = np.random.default_rng(42)      # tests/test_metrics.py's masks
    pred = (rng.random((16, 16, 16)) > 0.7).astype(np.float32)
    target = (rng.random((16, 16, 16)) > 0.7).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("name", ["dice_coefficient", "iou_score",
                                  "sensitivity", "specificity",
                                  "hausdorff_distance"])
def test_segmentation_metrics_facade_equals_jax(masks, name):
    pred, target = masks
    got = getattr(TM.SegmentationMetrics, name)(pred, target)
    want = getattr(JM.SegmentationMetrics, name)(pred, target)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-6)


def test_segmentation_metrics_compute_all_and_surface(masks):
    pred, target = masks
    got = TM.SegmentationMetrics.compute_all_metrics(pred, target)
    want = JM.SegmentationMetrics.compute_all_metrics(pred, target)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    # tests/test_api_surface.py:56-65, asked of the port's module
    for meth in ("dice_coefficient", "iou_score", "sensitivity",
                 "specificity", "hausdorff_distance",
                 "compute_all_metrics"):
        assert callable(getattr(TM.SegmentationMetrics, meth, None)), meth
    assert TM.LossMetrics is not None


@pytest.mark.parametrize("variant", ["dice_loss", "focal_loss",
                                     "combined_loss"])
def test_loss_metrics_equal_jax(variant):
    rng = np.random.default_rng(42)   # tests/test_parity_utils.py:113-115
    logits = rng.normal(size=(1, 4, 4, 4, 2)).astype(np.float32)
    onehot = np.eye(2)[rng.integers(0, 2, (1, 4, 4, 4))]
    args = ((logits, onehot.argmax(-1)) if variant == "focal_loss"
            else (logits, onehot))
    got = getattr(TM.LossMetrics, variant)(*args)
    want = getattr(JM.LossMetrics, variant)(*args)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    if variant == "dice_loss":
        assert 0.0 <= float(got) <= 1.0


@pytest.mark.parametrize("case", ["cube", "blob", "empty"])
def test_voxel_surface_mesh_equals_jax(case):
    mask = np.zeros((6, 6, 6), bool)
    if case == "cube":
        mask[1:4, 1:4, 1:4] = True      # tests/test_parity_utils.py:122-125
    elif case == "blob":
        mask = np.random.default_rng(3).random((7, 6, 5)) > 0.6
    got = tmesh.voxel_surface_mesh(mask)
    want = jmesh.voxel_surface_mesh(mask)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    area = tmesh.mesh_surface_area(*got)
    assert area == jmesh.mesh_surface_area(*want)
    if case == "cube":
        assert area == pytest.approx(54.0) and len(got[0]) == 56
        assert area == tmesh.surface_area_voxel(mask)


def test_make_sw_predictor_swaps_weights_as_jax():
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(20, 24, 16, 4)).astype(np.float32)
    kw = dict(roi_size=(16, 16, 16), overlap=0.5, sw_batch_size=2)
    va, vb = (to_flax_variables(UNet3D(features=(8, 16), seed=s,
                                       device="cpu").state_dict())
              for s in (1, 2))
    model = UNet3D(features=(8, 16), seed=9, device="cpu",
                   compute_dtype="float32")
    model.eval()
    jmodel = JUNet3D(out_channels=4, features=(8, 16), dtype=jnp.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, va)
    predict = make_sw_predictor(model, va, **kw)
    jpredict = j_make_sw_predictor(jmodel, jvars, **kw)
    x = torch.from_numpy(vol)
    a = predict(x).numpy()
    np.testing.assert_allclose(a, np.asarray(jpredict(jnp.asarray(vol))),
                               atol=1e-4, rtol=1e-3)
    predict.set_variables(vb)
    jpredict.set_variables(jax.tree_util.tree_map(jnp.asarray, vb))
    b = predict(x).numpy()
    assert np.abs(b - a).max() > 1e-3          # the weights did change
    np.testing.assert_allclose(b, np.asarray(jpredict(jnp.asarray(vol))),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_zsum_equals_zcat_and_jax(dtype):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 8, 10, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 8, 12)) * 0.2).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got = tconv.conv3d_zsum(xt, wt, bt, dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (2, 6, 8, 10, 12)
    got = got.float().numpy()
    zcat = tconv.conv3d_zcat(xt, wt, bt, dtype=tdt).float().numpy()
    want = np.asarray(jconv.conv3d_zsum(jnp.asarray(x, jdt),
                                        jnp.asarray(w), jnp.asarray(b)),
                      np.float32)
    scale = np.abs(zcat).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, zcat, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        # three roundings to bf16 and two bf16 adds against zcat's one
        assert np.abs(got - zcat).max() <= 2 ** -7 * scale
        assert np.abs(got - want).max() <= 2 ** -8 * scale


def test_batch_num_classes():
    model = UNet3D(features=(8, 16), device="cpu")
    assert batch_num_classes(model) == 4 == j_batch_num_classes(
        JUNet3D(features=(8, 16)))

    class Five:
        out_channels = 5
    assert batch_num_classes(Five()) == 5 == j_batch_num_classes(Five())


NOT_PORTED = {"ops": {"conv3d_form"}}


@pytest.mark.parametrize("sub", ["", "ops", "data", "train", "models",
                                 "inference", "serve", "utils",
                                 "parallel"])
def test_every_jax_export_is_importable_from_the_port(sub):
    suffix = f".{sub}" if sub else ""
    jmod = importlib.import_module(JAX_PKG + suffix)
    tmod = importlib.import_module(PORT + suffix)
    names = set(jmod.__all__) - NOT_PORTED.get(sub, set())
    assert names, sub
    missing = []
    for n in sorted(names):
        try:
            exec(f"from {PORT + suffix} import {n}", {})
        except ImportError:
            missing.append(n)
    assert not missing, (sub, missing)
    if sub in ("", "ops", "data", "parallel"):
        assert set(tmod.__all__) >= names, sub
