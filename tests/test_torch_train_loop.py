"""The port's train loop (``train/loop.py``): gradient accumulation,
activation checkpointing, dropout, and the joint and eval steps against
the JAX package's, on the CPU.

  * ``grad_accum=2`` against the full batch, with the rules of
    tests/test_trainer.py:86-125: loss within 1e-4 relative, Dice within
    0.05, gradient norm within 1e-3 relative, parameters after the
    update within 3e-4 (Adam's first step is about +-lr * sign(g), so a
    near-zero gradient may flip);
  * ``remat`` (torch.utils.checkpoint) changes nothing: the recomputed
    forward is the same arithmetic, bit for bit on the CPU;
  * dropout: JAX's PRNG and a torch.Generator give different masks, so
    the masks are checked by shape (one value per batch item and
    channel), values (0 or 1 / keep) and keep rate (within 5 sigma);
  * the joint step's ``seg_loss`` and ``grade_ce`` against JAX's
    ``joint_loss`` on the same parameters, dropout off on both sides,
    within 1e-2 relative (bf16 forwards);
  * the eval step: the loss within 1e-2 relative, labels agree on >= 99%
    of voxels, and the Dice values and the HD95 computed from JAX's labels
    equal JAX's within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import models as JMOD
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.metrics import (
    mean_foreground_dice as j_mean_foreground_dice, region_dice as j_region_dice)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models.joint import (
    grade_from_volume as j_grade_from_volume, joint_loss as j_joint_loss)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.edt import (
    hausdorff_distance_device as j_hausdorff)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_loss_fn as j_make_loss_fn)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.config import (
    Config)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.metrics import (
    mean_foreground_dice, region_dice)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    BrainTumorClassifier, UNet3D, UNet3DWithClassifier, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.dropout import (
    dropout)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    create_train_state, make_eval_step, make_joint_train_step,
    make_train_step)

FEATS = (32, 64)


def _batch(seed, b=2, shape=(8, 16, 16)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, *shape, 4)).astype(np.float32)
    y = ((rng.random((b, *shape)) < 0.2) * 2).astype(np.int32)
    return {"image": torch.from_numpy(x), "mask": torch.from_numpy(y).long()}


def _model(**kw):
    return UNet3D(features=FEATS, seed=2, device="cpu", dropout_rate=0.0,
                  ps2d_train=True, **kw)


def test_grad_accum_matches_full_batch():
    batch = _batch(1, b=4)
    cfg = Config()
    s1 = create_train_state(_model(), cfg, steps_per_epoch=2)
    s2 = create_train_state(_model(), cfg, steps_per_epoch=2)
    g = torch.Generator().manual_seed(0)
    _, m1 = make_train_step(cfg)(s1, batch, g)
    _, m2 = make_train_step(cfg.replace(grad_accum=2))(s2, batch, g)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)
    assert float(m2["dice"]) == pytest.approx(float(m1["dice"]), abs=0.05)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-3)
    for (n, a), b in zip(s1.model.named_parameters(),
                         s2.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-4, msg=n)
    # the BatchNorm statistics advanced (per microbatch under accumulation)
    assert not torch.equal(s2.model.head_bn.var, torch.ones(16))
    assert s1.step == s2.step == 1
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(cfg.replace(grad_accum=3))(s1, batch, g)


def test_eval_forward_stays_without_gradients():
    """``forward`` is the eval forward under ``torch.no_grad``; the train
    forward is the separate ``forward_train``."""
    m = _model()
    x = _batch(6)["image"]
    assert not m(x).requires_grad
    out = m.forward_train(x)
    assert out["logits"].requires_grad and out["logits"].grad_fn is not None


def test_deep_heads_full_res():
    """Deep heads at their native scales, and with ``deep_sup_full_res``
    each one resized trilinearly to the input's scale."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.resize import (
        resize_trilinear)
    x = _batch(8)["image"]

    def heads(full_res):
        m = UNet3D(features=(32, 64, 128), seed=2, device="cpu",
                   dropout_rate=0.0, ps2d_train=True,
                   deep_sup_full_res=full_res)
        with torch.no_grad():
            return m.forward_train(x)["deep"]

    native, full = heads(False), heads(True)
    assert [tuple(d.shape[1:4]) for d in native] == [(8, 16, 16),
                                                     (4, 8, 8)]
    for a, b in zip(native, full):
        assert torch.equal(resize_trilinear(a, x.shape[1:4]), b)


def test_remat_changes_nothing():
    batch = _batch(2)
    outs = []
    for remat in (False, True):
        m = _model(remat=remat)
        out = m.forward_train(batch["image"])
        loss = out["logits"].square().mean() + sum(
            d.float().square().mean() for d in out["deep"])
        grads = torch.autograd.grad(loss, list(m.parameters()),
                                    allow_unused=True)
        outs.append((loss, grads))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def test_dropout_masks_by_distribution():
    g = torch.Generator().manual_seed(5)
    x = torch.ones((64, 3, 4, 5, 64), dtype=torch.bfloat16)
    y = dropout(x, 0.2, g, (1, 2, 3))
    # one mask value per (batch, channel), broadcast over D, H, W
    assert torch.equal(y, y[:, :1, :1, :1].expand_as(y))
    vals = set(y.float().unique().tolist())
    assert vals <= {0.0, float(torch.tensor(1 / 0.8, dtype=torch.bfloat16))}
    kept = (y[:, 0, 0, 0] != 0).float().mean().item()
    sigma = (0.8 * 0.2 / (64 * 64)) ** 0.5
    assert abs(kept - 0.8) <= 5 * sigma, kept
    # the same seed draws the same mask; rate 0 is the identity
    y2 = dropout(x, 0.2, torch.Generator().manual_seed(5), (1, 2, 3))
    assert torch.equal(y, y2)
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.5, None)
    # the U-Net draws per level; the classifier and the grade head drop
    # elements of their hidden layer
    m = UNet3D(features=(32, 64), device="cpu", dropout_rate=0.5)
    b = _batch(3)
    a1 = m.forward_train(b["image"], torch.Generator().manual_seed(1))
    a2 = m.forward_train(b["image"], torch.Generator().manual_seed(2))
    assert not torch.equal(a1["logits"], a2["logits"])
    c = BrainTumorClassifier(device="cpu")
    xc = torch.randn(2, 16, 16, 16, 4)
    with torch.no_grad():
        l1 = c.forward_train(xc, torch.Generator().manual_seed(1))
        l2 = c.forward_train(xc, torch.Generator().manual_seed(2))
    assert l1.shape == (2, 4) and not torch.equal(l1, l2)
    c.dropout_rate = 0.0
    with torch.no_grad():
        torch.testing.assert_close(c.forward_train(xc, None), c(xc))


def _patch_flax_dropout(monkeypatch):
    """JAX's grade head draws Dropout(0.3) at train from its PRNG: turn
    flax's Dropout into the identity for this test (the port's rate is
    set to 0 the same way)."""
    import flax.linen as nn
    monkeypatch.setattr(nn, "Dropout",
                        lambda *a, **k: (lambda x, *aa, **kk: x))


def test_joint_step_matches_jax(monkeypatch):
    _patch_flax_dropout(monkeypatch)
    batch = _batch(4)
    model = UNet3DWithClassifier(features=FEATS, seed=1, device="cpu",
                                 dropout_rate=0.0)
    model.grade_dropout = 0.0
    variables = to_flax_variables(model.state_dict())
    jm = JMOD.UNet3DWithClassifier(features=FEATS, dtype=jnp.bfloat16,
                                   dropout_rate=0.0)
    x, y = jnp.asarray(batch["image"].numpy()), jnp.asarray(
        batch["mask"].numpy().astype(np.int32))
    tumor = jnp.sum((y > 0).astype(jnp.int32), axis=(1, 2, 3))
    grades = j_grade_from_volume(tumor, int(np.prod(y.shape[1:])))

    def parts(v):
        out, _ = jm.apply(v, x, train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return j_joint_loss(out, y, grades, j_make_loss_fn(JConfig()), 0.3)

    jloss, jparts = jax.jit(parts)(variables)
    state = create_train_state(model, Config())
    _, m = make_joint_train_step(Config())(state, batch,
                                           torch.Generator().manual_seed(0))
    for k, want in (("seg_loss", jparts["seg_loss"]),
                    ("grade_ce", jparts["grade_ce"]), ("loss", jloss)):
        assert float(m[k]) == pytest.approx(float(want), rel=1e-2), k
    assert 0.0 <= float(m["grade_acc"]) <= 1.0
    assert state.step == 1


def test_eval_step_matches_jax():
    batch = _batch(5, b=2, shape=(8, 16, 24))
    model = UNet3D(features=FEATS, seed=6, device="cpu")
    variables = to_flax_variables(model.state_dict())
    jm = JMOD.UNet3D(out_channels=4, features=FEATS, dtype=jnp.bfloat16)
    x = jnp.asarray(batch["image"].numpy())
    y_np = batch["mask"].numpy().astype(np.int32)
    jout = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x)
    jloss = float(j_make_loss_fn(JConfig())(jout, jnp.asarray(y_np)))
    jlab = np.array(jnp.argmax(jout["logits"], -1))
    jdice = float(j_mean_foreground_dice(jlab, y_np))
    jreg = {k: float(v) for k, v in j_region_dice(jlab, y_np).items()}
    m = make_eval_step(Config(), with_hausdorff=True)(
        create_train_state(model, Config()), batch)
    assert float(m["loss"]) == pytest.approx(jloss, rel=1e-2)
    lab = m["pred_labels"]
    assert lab.shape == batch["mask"].shape
    assert (lab.numpy() == jlab).mean() >= 0.99
    assert m["hausdorff"].shape == (2,)
    # the same labels give the same Dice values and distances
    jl, yt = torch.from_numpy(jlab), batch["mask"]
    assert float(mean_foreground_dice(jl, yt)) == pytest.approx(jdice,
                                                                abs=1e-6)
    for k, v in region_dice(jl, yt).items():
        assert float(v) == pytest.approx(jreg[k], abs=1e-6), k
        assert float(m[f"dice_{k}"]) == pytest.approx(jreg[k], abs=0.02)
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.edt import (
        hausdorff_distance_device)
    for i in range(2):
        want = float(j_hausdorff(jnp.asarray(jlab[i] > 0),
                                 jnp.asarray(y_np[i] > 0), percentile=95.0))
        got = float(hausdorff_distance_device(jl[i] > 0, yt[i] > 0, 95.0))
        assert got == pytest.approx(want, rel=1e-6)
