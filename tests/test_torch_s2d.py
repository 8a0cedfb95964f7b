"""``s2d_eval`` / ``s2d_train``: the JAX package runs level 0 in its
space-to-depth layout (``ops/s2d.py``), which fills the TPU's lanes and
computes the same function (tests/test_s2d.py); the port's ``UNet3D``
and ``Predictor`` take both flags and run the normal path. Here the
port with the flags is held against JAX's s2d forwards on the CPU, same
weights (the weight bridge), bf16, under the bf16 drift bounds of the
eval and train forwards (tests/test_torch_unet.py,
tests/test_torch_train_step.py): max |d logit| <= 2^-5 * max(scale, 1),
mean <= 2^-9 * max(scale, 1), labels agree at >= 0.99; the loss within
1e-2 relative, the gradients directionally (per leaf cosine >= 0.9, norm
ratio in [0.5, 2]).

The train forward's mean drift is the exception. JAX's own s2d train
logits are 1.04-1.18 x 2^-9 * scale (mean) from its own normal path's at
this size (BatchNorm on batch statistics spreads each rounding over the
batch; measured on three inputs), so nothing that computes the normal
path meets that bound against them. There the port is held to JAX's
normal path within the bounds, and to JAX's s2d path within them plus
JAX's own s2d-against-normal mean drift (measured: 1.09 x 2^-9 * scale
against 0.96 to the normal path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_train_step import (assert_drift, assert_grads_directional,
                                   port_step)

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_loss_fn as j_make_loss_fn)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import config as tcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.predictor import (
    Predictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)

FEATS = (16, 32)


def test_s2d_eval_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 8, 16, 24, 4)).astype(np.float32)
    model = UNet3D(features=FEATS, seed=6, device="cpu", s2d_eval=True)
    assert model.s2d_eval and not model.s2d_train
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.bfloat16,
                 s2d_eval=True)
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False)[
        "logits"])(variables, jnp.asarray(x)))
    out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    d = np.abs(out - ref)
    scale = max(np.abs(ref).max(), 1.0)
    assert d.max() <= 2 ** -5 * scale, (d.max(), scale)
    assert d.mean() <= 2 ** -9 * scale, (d.mean(), scale)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.99
    # the flag changes nothing of the port's forward
    plain = UNet3D(features=FEATS, seed=6, device="cpu")
    assert torch.equal(plain(torch.from_numpy(x)), torch.from_numpy(out))


def test_s2d_train_forward_and_loss_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 8, 16, 16, 4)).astype(np.float32)
    y = ((rng.random((1, 8, 16, 16)) < 0.2) * 2).astype(np.int32)
    model = UNet3D(features=FEATS, seed=7, device="cpu", dropout_rate=0.0,
                   s2d_train=True)
    assert model.s2d_train
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.bfloat16,
                 dropout_rate=0.0, s2d_train=True)
    loss_fn = j_make_loss_fn(JConfig())

    def loss(params):
        out, _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(out, jnp.asarray(y)), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    jn = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.bfloat16,
                 dropout_rate=0.0)
    normal = np.asarray(jax.jit(lambda p, a: jn.apply(
        {"params": p, "batch_stats": variables["batch_stats"]}, a,
        train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)})[0]["logits"])(
            variables["params"], jnp.asarray(x)))
    out, lt, grads = port_step(model, x, y)
    logits = out["logits"].detach().numpy()
    ref = np.asarray(jout["logits"])
    assert_drift(logits, normal, "logits against JAX's normal path")
    scale = max(np.abs(ref).max(), 1.0)
    d = np.abs(logits - ref)
    assert d.max() <= 2 ** -5 * scale, (d.max(), scale)
    jax_own = np.abs(ref - normal).mean()
    assert d.mean() <= 2 ** -9 * scale + jax_own, (d.mean(), jax_own, scale)
    assert len(out["deep"]) == len(jout["deep"]) == 1
    assert_drift(out["deep"][0].detach().float().numpy(),
                 np.asarray(jout["deep"][0], np.float32), "deep0")
    assert abs(lt - float(jl)) <= 1e-2 * abs(float(jl)), (lt, float(jl))
    assert_grads_directional(grads, jax.tree_util.tree_map(np.asarray, jg))


def test_predictor_takes_the_s2d_flags():
    def pred(**flags):
        return Predictor(tcfg.Config(
            model=tcfg.ModelConfig(features=FEATS, **flags),
            data=tcfg.DataConfig(image_size=(16, 16, 16))), device="cpu")
    p = pred(s2d_eval=True, s2d_train=True)
    assert p.seg_model.s2d_eval and p.seg_model.s2d_train
    vol = np.random.default_rng(5).normal(size=(12, 20, 16, 4)).astype(
        np.float32)
    lab = p.segment_tumor(vol, mode="sliding_window")
    assert lab.shape == (12, 20, 16)
    np.testing.assert_array_equal(
        lab, pred().segment_tumor(vol, mode="sliding_window"))
