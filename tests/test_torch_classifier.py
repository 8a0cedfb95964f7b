"""The port's classifier and joint grade head against the JAX package's
``models/classifier.py`` and ``models/joint.py``, with the same weights
moved over by the weight bridge, on the CPU.

Both compute in bf16 with f32 accumulation; bf16 rounding happens at
other places in the two frameworks, so logits drift by a few bf16 ulp of
the activations they are made from. Tolerances:

  * classifier logits within 2^-5 * max(max|ref|, 1), argmax equal;
  * grade and segmentation logits within 2^-5 * max(max|ref|, 1) (the
    trunk's drift, test_torch_unet.py, reaches the grade head through
    the pooled bottleneck and the burden features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    BrainTumorClassifier as JClassifier)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models.joint import (
    UNet3DWithClassifier as JJoint)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    BrainTumorClassifier, UNet3DWithClassifier, load_flax_params)

from test_torch_unet import flax_variables


def _close(out, ref):
    d = np.abs(out - ref).max()
    assert d <= 2 ** -5 * max(np.abs(ref).max(), 1.0), (d, np.abs(ref).max())


@pytest.mark.parametrize("shape", [(2, 16, 16, 16, 4), (1, 24, 16, 20, 4)])
def test_classifier_matches_jax(shape):
    rng = np.random.default_rng(21)
    x = rng.normal(size=shape).astype(np.float32)
    model = BrainTumorClassifier(seed=2, device="cpu").eval()
    variables = flax_variables(model)
    ref = np.asarray(jax.jit(lambda v, a: JClassifier(
        num_classes=4, dtype=jnp.bfloat16).apply(v, a, train=False))(
            {"params": variables["params"]}, jnp.asarray(x)))
    out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (shape[0], 4) and out.dtype == np.float32
    _close(out, ref)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_joint_grade_matches_jax():
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, 16, 16, 16, 4)).astype(np.float32)
    model = UNet3DWithClassifier(features=(32, 64), seed=3,
                                 device="cpu").eval()
    # non-trivial running statistics for the head BatchNorm
    gen = torch.Generator().manual_seed(0)
    model.unet.head_bn.mean.copy_(torch.rand(16, generator=gen) * 0.4 - 0.2)
    model.unet.head_bn.var.copy_(torch.rand(16, generator=gen) + 0.5)
    variables = flax_variables(model)
    jm = JJoint(out_channels=4, num_grades=4, features=(32, 64),
                dtype=jnp.bfloat16)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    out = model(torch.from_numpy(x))
    assert out["grade_logits"].shape == (2, 4)
    _close(out["grade_logits"].numpy(), np.asarray(ref["grade_logits"]))
    _close(out["logits"].numpy(), np.asarray(ref["logits"]))


@pytest.mark.parametrize("which", ["classifier", "joint"])
def test_weight_bridge_covers_classifier_trees(which):
    """Every JAX parameter and batch statistic lands on a port tensor of
    the same shape, a Dense kernel transposed; nothing is left out."""
    model = (BrainTumorClassifier(seed=0, device="cpu") if which ==
             "classifier" else UNet3DWithClassifier(features=(32,), seed=0,
                                                    device="cpu"))
    variables = flax_variables(model)
    state = load_flax_params(variables)
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    fc = "fc1" if which == "classifier" else "grade_fc1"
    np.testing.assert_array_equal(state[f"{fc}.weight"].numpy(),
                                  variables["params"][fc]["kernel"].T)
