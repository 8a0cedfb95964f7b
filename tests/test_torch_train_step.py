"""The port's train forward, loss and gradients of ``UNet3D(ps2d_train=
True)`` against the JAX package's, on the CPU, with the same parameters
(moved by the weight bridge), the same batch and dropout at rate 0 (JAX's
PRNG and a ``torch.Generator`` draw different masks; the masks are
checked by distribution in tests/test_torch_train_loop.py).

Both packages compute in bf16; the port's K6 runs its plain K1, JAX's
Pallas kernel runs in interpret mode. Bounds:

  * logits and each deep head: the ps2d drift bounds of the eval forward
    (PERF.md section 2): max |d| <= 2^-5 * max(scale, 1), mean <= 2^-9 *
    max(scale, 1);
  * the head BatchNorm's new running statistics: within 1e-3 of the
    largest running variance. They are f32 moments of bf16 activations,
    and 1e-4 is below the bf16 drift of the reference itself: JAX's own
    normal and kernel paths give new statistics 3.1e-4 (mean) and
    8.2e-4 (variance) apart on this batch, the port's paths 6.0e-4 and
    8.4e-4, the port's kernel path and JAX's 3.9e-4 and 3.9e-4;
  * the loss within 1e-2 relative; the gradients directionally, as JAX's
    own test of its kernel path holds them (tests/test_ps2d.py:538-606):
    per leaf cosine >= 0.9 and norm ratio in [0.5, 2] (at random init a
    bf16 rounding of a few activations moves cancellation-prone gradient
    elements far more than it moves the direction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_loss_fn as j_make_loss_fn)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.config import (
    Config)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    make_loss_fn)

FEATS = (32, 64)
SHAPE = (1, 4, 16, 24)      # B, D, H, W: the region needs even D, H, W


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*SHAPE, 4)).astype(np.float32)
    # a label mask the net can fit (tests/test_ps2d.py:617-619)
    y = ((rng.random(SHAPE) < 0.2) * 2).astype(np.int32)
    return x, y


def port_step(model, x, y):
    """(out, loss, grads by flax path) of one port train forward."""
    out = model.forward_train(torch.from_numpy(x), generator=None)
    loss = make_loss_fn(Config())(out, torch.from_numpy(y).long())
    named = list(model.named_parameters())
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g)
             for (n, p), g in zip(named, gs)}
    return out, float(loss.detach()), to_flax_variables(grads)["params"]


def flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from flat_leaves(v, key)
        else:
            yield key, np.asarray(v, np.float32)


# zero in exact arithmetic: the head conv's bias feeds a BatchNorm on
# batch statistics, which removes any per-channel shift; in bf16 both
# packages give rounding noise there, checked to be small instead
ZERO_GRADS = {"/head_conv/bias": "/head_conv/kernel"}


def assert_grads_directional(got, ref):
    ref_leaves = dict(flat_leaves(ref))
    got_leaves = dict(flat_leaves(got))
    assert set(got_leaves) == set(ref_leaves)
    checked = 0
    for k, b in ref_leaves.items():
        a = got_leaves[k]
        assert a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        if k in ZERO_GRADS:
            big = np.linalg.norm(got_leaves[ZERO_GRADS[k]])
            assert np.linalg.norm(a) <= 1e-2 * big, k
            continue
        a, b = a.ravel(), b.ravel()
        if b.size < 8:           # a cosine says nothing of a scalar
            continue
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 1e-6 or nb < 1e-6:
            continue
        c = float(a @ b / (na * nb))
        assert c >= 0.9, (k, c)
        assert 0.5 <= na / nb <= 2.0, (k, na / nb)
        checked += 1
    assert checked >= 40, checked


def assert_drift(a, b, name):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, name
    d = np.abs(a - b)
    scale = max(np.abs(b).max(), 1.0)
    assert d.max() <= 2 ** -5 * scale, (name, d.max(), scale)
    assert d.mean() <= 2 ** -9 * scale, (name, d.mean(), scale)


@pytest.fixture(scope="module")
def case():
    x, y = _batch(11)
    model = UNet3D(features=FEATS, seed=3, device="cpu", dropout_rate=0.0,
                   remat=True, ps2d_train=True)
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.bfloat16,
                 dropout_rate=0.0, ps2d_train=True)
    loss_fn = j_make_loss_fn(JConfig())

    def loss(params):
        out, mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(out, jnp.asarray(y)), (out, mut["batch_stats"])

    (jl, (jout, jbs)), jg = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    ref = {"loss": float(jl), "logits": np.asarray(jout["logits"]),
           "deep": [np.asarray(d, np.float32) for d in jout["deep"]],
           "batch_stats": jax.tree_util.tree_map(np.asarray, jbs),
           "grads": jax.tree_util.tree_map(np.asarray, jg)}
    return model, x, y, ref


def test_train_forward_matches_jax(case):
    model, x, y, ref = case
    with torch.no_grad():
        out = model.forward_train(torch.from_numpy(x), generator=None)
    assert out["logits"].dtype == torch.float32
    assert_drift(out["logits"].numpy(), ref["logits"], "logits")
    # deep heads at their native scale: level 0 full, level 1 halved
    assert len(out["deep"]) == len(ref["deep"]) == 1
    for i, (d, r) in enumerate(zip(out["deep"], ref["deep"])):
        assert d.dtype == torch.bfloat16
        assert_drift(d.float().numpy(), r, f"deep{i}")
    mean, var = out["batch_stats"]
    ref_bn = ref["batch_stats"]["head_bn"]
    scale = np.abs(ref_bn["var"]).max()
    for got, want in ((mean, ref_bn["mean"]), (var, ref_bn["var"])):
        d = np.abs(got.numpy() - want).max()
        assert d <= 1e-3 * scale, (d, scale)
    # the buffers are not written by the forward
    assert torch.equal(model.head_bn.mean, torch.zeros_like(mean))


def test_train_loss_and_grads_match_jax(case):
    model, x, y, ref = case
    _, loss, grads = port_step(model, x, y)
    assert np.isfinite(loss)
    assert abs(loss - ref["loss"]) <= 1e-2 * abs(ref["loss"]), (
        loss, ref["loss"])
    assert_grads_directional(grads, ref["grads"])


def test_kernel_route_matches_normal_route(case):
    """The port's K6 region against its own normal path (no region),
    same parameters: what chip_smoke.py holds the card's kernel path
    to."""
    model, x, y, _ = case
    normal = UNet3D(features=FEATS, device="cpu", dropout_rate=0.0)
    normal.load_state_dict(model.state_dict())
    _, lk, gk = port_step(model, x, y)
    _, ln, gn = port_step(normal, x, y)
    assert abs(lk - ln) <= 1e-2 * abs(ln), (lk, ln)
    assert_grads_directional(gk, gn)
