"""``compute_dtype="float32"`` on the normal path: the port against the
JAX package run in float32 (its ``dtype=jnp.float32``), on the same
weights and inputs.

Both packages compute full float32 on the CPU (the port's f32 library
calls run with TF32 off, ``ops.conv.full_f32``, which only the card
would use), so the tolerances are float32's, not bf16's:

  * logits within 1e-4 * max(scale, 1) of JAX's, scale = max |logit|;
  * labels equal wherever JAX's top-2 logit margin exceeds twice the
    largest logit drift (the margin contract), and confidences within
    half that drift plus 1e-6 (softmax is 1/2-Lipschitz in the max norm);
  * one train step at dropout 0 (the dropout masks differ by design):
    loss within 1e-5 * max(|loss|, 1), every gradient leaf at cosine
    >= 0.9999 and norm ratio within 1e-3 of 1;
  * the bf16 default is unchanged: the bf16 outputs of the U-Net (eval
    and train forwards), the classifier and the joint model hash to the
    values the port gave before the compute dtype was threaded through
    it, and an f32 call leaves the TF32 settings as they were, also when
    two threads' f32 sections overlap;
  * a compute dtype other than bf16 and f32 raises ``ValueError``.

float32 with the ps2d region is held to JAX's in test_torch_f32_region.py.
"""

import hashlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import config as jcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference.predictor import (
    Predictor as JPredictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_loss_fn as j_make_loss_fn)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import config as tcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.predictor import (
    Predictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    BrainTumorClassifier, UNet3D, UNet3DWithClassifier, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv import (
    full_f32, tf32_for_bf16)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    create_train_state, make_eval_step, make_loss_fn, make_train_step)

from test_torch_predictor import _volume
from test_torch_train_step import flat_leaves

FEATS = (32, 64)
ROI = (16, 16, 16)
F32 = "float32"


def _margin_contract(got, ref):
    """Logits within 1e-4 * max(scale, 1); labels equal where the margin
    exceeds twice the drift. Returns the largest drift."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    d = np.abs(got - ref).max()
    assert d <= 1e-4 * max(np.abs(ref).max(), 1.0), d
    top2 = np.sort(ref, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    flips = got.argmax(-1) != ref.argmax(-1)
    assert not (flips & (margin > 2 * d)).any()
    return d


@pytest.fixture(scope="module")
def predictors():
    seg = to_flax_variables(UNet3D(features=FEATS, seed=3, device="cpu")
                            .state_dict())
    cls = to_flax_variables(BrainTumorClassifier(seed=4, device="cpu")
                            .state_dict())
    inf = dict(roi_size=ROI, overlap=0.5, sw_batch_size=4,
               crop_bucket_ladder=())
    jp = JPredictor(jcfg.Config(
        model=jcfg.ModelConfig(features=FEATS, compute_dtype=F32),
        data=jcfg.DataConfig(image_size=ROI),
        inference=jcfg.InferenceConfig(**inf)),
        seg_variables=seg, cls_variables=cls)
    tp = Predictor(tcfg.Config(
        model=tcfg.ModelConfig(features=FEATS, compute_dtype=F32),
        data=tcfg.DataConfig(image_size=ROI),
        inference=tcfg.InferenceConfig(**inf)),
        seg_variables=seg, cls_variables=cls, device="cpu")
    return jp, tp


def test_predictor_f32_segment_and_confidence_match_jax(predictors):
    jp, tp = predictors
    assert tp.seg_model.compute_dtype == torch.float32
    vol = _volume()
    canon = tp._canon(vol)
    ref, rplan = jp._segment_logits(canon, "cropped")
    got, plan = tp._segment_logits(canon, "cropped")
    assert plan == rplan
    drift = _margin_contract(got.numpy(), ref)
    rl, rc = jp.segment_with_confidence(vol, mode="cropped")
    gl, gc = tp.segment_with_confidence(vol, mode="cropped")
    assert gl.shape == rl.shape == vol.shape[:3]
    assert (gl == rl).mean() >= 0.999
    assert np.abs(gc - rc).max() <= drift / 2 + 1e-6
    # whole_volume: resize, one forward, resize back
    ref_w, _ = jp._segment_logits(canon, "whole_volume")
    got_w, _ = tp._segment_logits(canon, "whole_volume")
    _margin_contract(got_w.numpy(), ref_w)


def test_predictor_f32_classify_matches_jax(predictors):
    jp, tp = predictors
    vol = _volume()
    x = tp._model_input(tp._canon(vol))
    got = tp.cls_model(x).numpy()
    ref = np.asarray(jp._classify(jp.cls_variables,
                                 jnp.asarray(tp._canon(vol))))
    assert np.abs(got - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)
    name, conf = tp.classify_tumor(vol)
    rname, rconf = jp.classify_tumor(vol)
    assert name == rname and abs(conf - rconf) <= 1e-5


def test_f32_train_step_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32)
    y = ((rng.random((1, 16, 16, 16)) < 0.2) * 2).astype(np.int32)
    model = UNet3D(features=FEATS, seed=3, device="cpu", dropout_rate=0.0,
                   remat=True, compute_dtype=F32)
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.float32,
                 dropout_rate=0.0)
    jloss = j_make_loss_fn(jcfg.Config())

    def loss(params):
        out, _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jloss(out, jnp.asarray(y))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(
        variables["params"])
    out = model.forward_train(torch.from_numpy(x))
    assert out["logits"].dtype == torch.float32
    assert all(d.dtype == torch.float32 for d in out["deep"])
    lt = make_loss_fn(tcfg.Config())(out, torch.from_numpy(y).long())
    named = list(model.named_parameters())
    gs = torch.autograd.grad(lt, [p for _, p in named], allow_unused=True)
    grads = to_flax_variables({n: torch.zeros_like(p) if g is None else g
                               for (n, p), g in zip(named, gs)})["params"]
    assert abs(float(lt.detach()) - float(ref_loss)) <= 1e-5 * max(
        abs(float(ref_loss)), 1.0)
    got = dict(flat_leaves(grads))
    ref = dict(flat_leaves(jax.tree_util.tree_map(np.asarray, ref_grads)))
    assert set(got) == set(ref)
    checked = 0
    for k, b in ref.items():
        a, b = got[k].ravel(), b.ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if k == "/head_conv/bias" or nb < 1e-6:
            continue       # zero in exact arithmetic (BatchNorm after it)
        assert a @ b / (na * nb) >= 0.9999, k
        assert abs(na / nb - 1) <= 1e-3, k
        checked += 1
    assert checked >= 40

    # the steps of train/loop.py run f32 models end to end
    state = create_train_state(model, tcfg.Config(), steps_per_epoch=2)
    batch = {"image": torch.from_numpy(x), "mask": torch.from_numpy(y)}
    _, m = make_train_step(tcfg.Config())(state, batch, None)
    assert np.isfinite(float(m["loss"]))
    ev = make_eval_step(tcfg.Config())(state, batch)
    assert ev["pred_labels"].shape == y.shape


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# sha256 prefixes of the bf16 outputs below, taken from the port before
# the compute dtype was threaded through it (the same at 1, 2 and 6
# threads)
BF16_DIGESTS = {"unet": "6fb83b16cd7ea5a6", "unet_train": "69dc66416ffc0a8f",
                "classifier": "960394dcfa712e87", "joint": "b163101dc0d5b998"}


def test_bf16_default_unchanged_and_tf32_restored():
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(2, 16, 16, 16, 4)).astype(np.float32))
    u = UNet3D(features=FEATS, seed=5, device="cpu")
    assert u.compute_dtype == torch.bfloat16
    assert all(m.compute_dtype == torch.bfloat16 for m in u.modules()
               if hasattr(m, "compute_dtype"))
    out = u.forward_train(x, torch.Generator().manual_seed(3))
    j = UNet3DWithClassifier(features=FEATS, seed=9, device="cpu")(x)
    got = {"unet": _digest(u(x)),
           "unet_train": _digest(out["logits"], *out["deep"],
                                 *out["batch_stats"]),
           "classifier": _digest(BrainTumorClassifier(seed=7,
                                                      device="cpu")(x)),
           "joint": _digest(j["logits"], j["grade_logits"])}
    assert got == BF16_DIGESTS
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision())
    with full_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    UNet3D(features=FEATS, device="cpu", compute_dtype=F32)(x)
    assert (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == (conv, mm)


def test_full_f32_sections_overlap_across_threads():
    """Two requests' f32 sections overlapping in two threads (A opens, B
    opens, A closes, B closes): TF32 stays off until both have closed,
    a section that lets TF32 in for bf16 values does not turn it on
    meanwhile, and the settings from before A are restored after B."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    seen = []
    b_open, a_closed = threading.Event(), threading.Event()

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision())

    def a():
        with full_f32():
            b_open.wait(5)
        a_closed.set()

    def b():
        with full_f32():
            b_open.set()
            a_closed.wait(5)
            seen.append(flags())
            with tf32_for_bf16():
                seen.append(flags())

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert seen == [(False, "highest")] * 2
        assert flags() == (True, "high")
        with tf32_for_bf16():
            assert torch.backends.cudnn.allow_tf32
        assert flags() == (True, "high")
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def test_compute_dtype_float16_raises():
    with pytest.raises(ValueError):
        UNet3D(features=FEATS, device="cpu", compute_dtype="float16")
