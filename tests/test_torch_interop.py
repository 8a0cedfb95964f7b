"""The port's ``utils/torch_interop.py`` against the JAX package's: a
reference-layout ``state_dict`` (the JAX package's
``export_unet3d_to_torch`` of a U-Net's weights) gives the same flax tree
through the port's import as through JAX's, bit for bit; the port's
``UNet3D`` loaded from it as a ``.pth`` gives the JAX model's f32 logits
within 1e-4 max(scale, 1); the classifier import, both exports and the
``.pth`` save / load round trip (bare and in the reference trainer's
``model_state_dict`` wrapper)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import models as jmodels
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.utils import (
    torch_interop as J)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    BrainTumorClassifier, UNet3D, load_flax_params, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.utils import (
    torch_interop as T)

FEATS = (8, 16)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.fixture(scope="module")
def reference_sd():
    """A reference-layout state_dict made by the JAX package's export of
    a U-Net's weights (running BatchNorm statistics not at their
    defaults)."""
    var = to_flax_variables(UNet3D(features=FEATS, seed=3,
                                   device="cpu").state_dict())
    rng = np.random.default_rng(0)
    hb = var["batch_stats"]["head_bn"]
    hb["mean"] = rng.uniform(-0.2, 0.2, hb["mean"].shape).astype(np.float32)
    hb["var"] = rng.uniform(0.7, 1.4, hb["var"].shape).astype(np.float32)
    return J.export_unet3d_to_torch(var["params"], var["batch_stats"], FEATS)


def test_unet_import_equals_jax(reference_sd):
    got = T.import_unet3d_from_torch(reference_sd, 4, FEATS)
    want = J.import_unet3d_from_torch(reference_sd, 4, FEATS)
    assert_trees_equal(got[0], want[0])
    assert_trees_equal(got[1], want[1])
    # tensors in, the same tree out
    as_tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in reference_sd.items()}
    assert_trees_equal(T.import_unet3d_from_torch(as_tensors, 4, FEATS)[0],
                       want[0])


def test_unet_export_equals_jax(reference_sd):
    params, bs = J.import_unet3d_from_torch(reference_sd, 4, FEATS)
    got = T.export_unet3d_to_torch(params, bs, FEATS)
    want = J.export_unet3d_to_torch(params, bs, FEATS)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], reference_sd[k], err_msg=k)


def test_pth_loads_into_the_ports_unet(tmp_path, reference_sd):
    """The ``.pth`` into the port's f32 UNet3D: JAX's f32 logits on the
    same weights within 1e-4 max(scale, 1)."""
    p = str(tmp_path / "best.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in reference_sd.items()}, p)
    model = UNet3D(features=FEATS, seed=9, device="cpu",
                   compute_dtype="float32")
    model.eval()
    params, bs = T.load_torch_checkpoint(p, 4, FEATS, model=model)
    x = np.random.default_rng(1).normal(size=(1, 16, 16, 16, 4)
                                        ).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jm = jmodels.UNet3D(features=FEATS, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False)
                              ["logits"])(
        {"params": jax.tree_util.tree_map(jnp.asarray, params),
         "batch_stats": jax.tree_util.tree_map(jnp.asarray, bs)},
        jnp.asarray(x)))
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    # the model now holds exactly the imported weights
    assert_trees_equal(to_flax_variables(model.state_dict())["params"],
                       params)


def test_save_load_round_trip(tmp_path, reference_sd):
    params, bs = T.import_unet3d_from_torch(reference_sd, 4, FEATS)
    p = str(tmp_path / "best.pth")
    assert T.save_torch_checkpoint(p, params, bs, FEATS) == p
    saved = torch.load(p, weights_only=True)
    assert set(saved) == set(reference_sd)
    wrapped = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": saved, "best_dice": 0.9}, wrapped)
    for path in (p, wrapped):
        got = T.load_torch_checkpoint(path, 4, FEATS)
        want = J.load_torch_checkpoint(path, 4, FEATS)
        assert_trees_equal(got[0], want[0])
        assert_trees_equal(got[0], params)
        assert_trees_equal(got[1], bs)


class TClassifier(tnn.Module):
    """The reference's BrainTumorClassifier layout (main.py:278-328)."""

    def __init__(self, n=4):
        super().__init__()
        self.features = tnn.Sequential(
            tnn.Conv3d(4, 32, 3, 1, 1), tnn.ReLU(), tnn.MaxPool3d(2),
            tnn.Conv3d(32, 64, 3, 1, 1), tnn.ReLU(), tnn.MaxPool3d(2),
            tnn.Conv3d(64, 128, 3, 1, 1), tnn.ReLU(),
            tnn.AdaptiveAvgPool3d((4, 4, 4)))
        self.classifier = tnn.Sequential(
            tnn.Linear(128 * 64, 512), tnn.ReLU(), tnn.Dropout(0.5),
            tnn.Linear(512, n))

    def forward(self, x):
        x = self.features(x)
        return self.classifier(x.view(x.size(0), -1))


def test_classifier_import_equals_jax():
    torch.manual_seed(1)
    tm = TClassifier().eval()
    got = T.import_classifier_from_torch(tm.state_dict())
    assert_trees_equal(got, J.import_classifier_from_torch(tm.state_dict()))
    # the port's classifier with the imported weights: the reference
    # module's logits (the fc1 permutation NCDHW -> NDHWC included)
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 16, 4)
                                        ).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x.transpose(0, 4, 1, 2, 3))).numpy()
    model = BrainTumorClassifier(device="cpu", compute_dtype="float32")
    model.eval()
    model.load_state_dict(load_flax_params({"params": got}))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, atol=1e-4, rtol=1e-4)
