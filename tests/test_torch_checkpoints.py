"""The port's checkpoints (``train/checkpoints.py``, the port's own
format) on the CPU: the round trip bit for bit, EMA and pre-EMA restores
both ways, write-then-swap, the archive, ``compatible_tree``, serving's
adoption of trained weights, and a checkpoint's weights applied by the
JAX package's ``UNet3D`` against the port's logits (within the bf16
drift of tests/test_torch_unet.py: max 2^-5, mean 2^-9 of max(scale, 1)).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import config as tcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.predictor import (
    Predictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, UNet3DWithClassifier)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    checkpoints as ck, create_train_state, make_joint_train_step,
    make_train_step)

FEATS = (16, 32)


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
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.normal(size=(b, 8, 8, 8, 4))
                                      .astype(np.float32)),
            "mask": torch.from_numpy(rng.integers(0, 4, (b, 8, 8, 8)))}


def _state(seed=0, ema=0.0, steps=2, feats=FEATS):
    conf = tcfg.Config(ema_decay=ema)
    model = UNet3D(features=feats, seed=seed, device="cpu")
    state = create_train_state(model, conf, steps_per_epoch=2)
    step = make_train_step(conf)
    g = torch.Generator().manual_seed(seed)
    for i in range(steps):
        step(state, _batch(i), g)
    return state


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_round_trip_bit_exact(tmp_path, ema):
    state = _state(ema=ema)
    path = ck.save_checkpoint(str(tmp_path / "best_x"), state,
                              best_dice=0.5, epoch=3,
                              metrics_history={"val_dice": [0.1, 0.5]})
    assert os.path.isfile(os.path.join(path, "state", "state.pt"))
    raw = torch.load(os.path.join(path, "state", "state.pt"),
                     weights_only=True)
    assert set(raw) == ({"params", "batch_stats", "opt_state", "step"}
                        | ({"ema_params"} if ema else set()))
    assert set(raw["opt_state"]) == {"count", "mu", "nu"}
    assert set(raw["params"]) == set(raw["opt_state"]["mu"])
    fresh = _state(seed=9, ema=ema, steps=0)
    restored, meta = ck.restore_checkpoint(path, fresh)
    assert restored is fresh and restored.step == state.step == 2
    assert meta["best_dice"] == 0.5 and meta["epoch"] == 3
    assert meta["metrics_history"] == {"val_dice": [0.1, 0.5]}
    assert_trees_equal(ck.state_tree(restored), ck.state_tree(state))
    # training goes on from the restored state as from the saved one
    conf = tcfg.Config(ema_decay=ema)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    make_train_step(conf)(state, _batch(7), g1)
    make_train_step(conf)(restored, _batch(7), g2)
    assert_trees_equal(ck.state_tree(restored), ck.state_tree(state))


def test_ema_and_pre_ema_restores(tmp_path):
    plain = _state(ema=0.0)
    p1 = ck.save_checkpoint(str(tmp_path / "plain"), plain)
    into_ema = ck.restore_checkpoint(p1, _state(seed=4, ema=0.9, steps=0))[0]
    tree = ck.state_tree(into_ema)
    # the EMA is seeded from the restored params, in its own memory
    assert_trees_equal(tree["ema_params"], tree["params"])
    name, e = next(iter(into_ema.ema_params.items()))
    assert e.data_ptr() != dict(into_ema.model.named_parameters())[
        name].data_ptr()
    ema = _state(ema=0.9)
    p2 = ck.save_checkpoint(str(tmp_path / "ema"), ema)
    into_plain = ck.restore_checkpoint(p2, _state(seed=4, steps=0))[0]
    assert into_plain.ema_params is None
    assert_trees_equal(ck.state_tree(into_plain)["params"],
                       ck.state_tree(ema)["params"])
    # serving prefers the EMA weights
    params, bstats = ck.load_inference_weights(p2)
    assert_trees_equal(params, ck.state_tree(ema)["ema_params"])
    assert "head_bn" in bstats


def test_write_then_swap_keeps_the_old_state(tmp_path, monkeypatch):
    state = _state(steps=1)
    path = ck.save_checkpoint(str(tmp_path / "best_a"), state, epoch=1)
    before = ck.state_tree(state)
    make_train_step(tcfg.Config())(state, _batch(3),
                                   torch.Generator().manual_seed(0))

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ck.torch, "save", broken)
    with pytest.raises(OSError):
        ck.save_checkpoint(path, state, epoch=2)
    monkeypatch.undo()
    params, _ = ck.load_inference_weights(path)
    assert_trees_equal(params, before["params"])
    # the next save replaces it
    ck.save_checkpoint(path, state, epoch=2)
    assert not os.path.exists(os.path.join(path, "state.tmp"))
    assert_trees_equal(ck.load_inference_weights(path)[0],
                       ck.state_tree(state)["params"])


def test_archive_existing(tmp_path):
    assert ck.archive_existing(str(tmp_path / "nothing")) is None
    path = ck.save_checkpoint(str(tmp_path / "best_run"), _state(steps=0))
    dest = ck.archive_existing(path)
    assert not os.path.exists(path)
    assert dest.startswith(str(tmp_path / "archive" / "best_run_"))
    assert os.path.isfile(os.path.join(dest, "state", "state.pt"))
    assert not os.access(os.path.join(dest, "trainer_meta.json"), os.W_OK) \
        or os.geteuid() == 0
    assert oct(os.stat(dest).st_mode & 0o777) == "0o555"
    # a second archive of the same name in the same second
    path = ck.save_checkpoint(str(tmp_path / "best_run"), _state(steps=0))
    assert ck.archive_existing(path) != dest


def test_compatible_tree_and_params_only(tmp_path):
    a = ck.state_tree(_state(steps=0))["params"]
    b = ck.state_tree(_state(seed=3, steps=0))["params"]
    c = ck.state_tree(_state(steps=0, feats=(16, 32, 64)))["params"]
    assert ck.compatible_tree(a, b)
    assert not ck.compatible_tree(a, c)
    assert not ck.compatible_tree(a, {**a, "extra": np.zeros(2)})
    assert ck.compatible_tree({"w": np.zeros((2, 3))},
                              {"w": np.zeros((2, 3), np.float16)})
    assert not ck.compatible_tree({"w": np.zeros((2, 3))},
                                  {"w": np.zeros((3, 2))})
    path = ck.save_params_only(str(tmp_path / "export"), a)
    assert_trees_equal(ck.restore_params_only(path, b), a)
    with pytest.raises(ValueError):
        ck.restore_params_only(path, c)
    assert_trees_equal(ck.load_inference_weights(path)[0], a)


def _predictor(feats=FEATS):
    conf = tcfg.Config(model=tcfg.ModelConfig(features=feats),
                       data=tcfg.DataConfig(image_size=(16, 16, 16)))
    return Predictor(conf, device="cpu", seed=11)


def test_adoption_picks_the_newest_compatible_best(tmp_path):
    models = tmp_path / "models"
    good = _state(seed=1, steps=1)
    p_good = ck.save_checkpoint(str(models / "best_good"), good)
    p_wide = ck.save_checkpoint(str(models / "best_wide"),
                                _state(seed=2, steps=0, feats=(16, 32, 64)))
    p_old = ck.save_checkpoint(str(models / "best_old"), _state(seed=3))
    os.utime(p_old, (1, 1))
    os.utime(p_good, (2, 2))
    os.utime(p_wide, (3, 3))          # the newest, but another model
    (models / "best_broken").mkdir()
    pred = _predictor()
    assert ck.adopt_trained_weights(pred, "none", str(models)) is None
    assert ck.adopt_trained_weights(pred, "", str(models)) == p_good
    adopted = {k: v.detach().numpy() for k, v in
               pred.seg_model.state_dict().items()}
    want = {k: v.detach().numpy() for k, v in
            good.model.state_dict().items()}
    for k in want:
        np.testing.assert_array_equal(adopted[k], want[k], err_msg=k)
    # an explicit path adopts that checkpoint; one that does not fit, none
    assert ck.adopt_trained_weights(_predictor(), p_old) == p_old
    assert ck.adopt_trained_weights(_predictor(), p_wide) is None
    assert ck.adopt_trained_weights(_predictor(), "", str(tmp_path / "x")) \
        is None


def test_joint_checkpoint_adopts_trunk_and_grade_head(tmp_path):
    conf = tcfg.Config()
    joint = UNet3DWithClassifier(features=FEATS, device="cpu", seed=2)
    state = create_train_state(joint, conf, steps_per_epoch=1)
    make_joint_train_step(conf)(state, _batch(1),
                                torch.Generator().manual_seed(0))
    path = ck.save_checkpoint(str(tmp_path / "best_joint"), state)
    pred = _predictor()
    assert pred.classify_grade(np.zeros((16, 16, 16, 4), np.float32)) is None
    assert ck.adopt_trained_weights(pred, path) == path
    for k, v in joint.unet.state_dict().items():
        np.testing.assert_array_equal(
            pred.seg_model.state_dict()[k].numpy(), v.detach().numpy())
    grade = pred.classify_grade(np.ones((16, 16, 16, 4), np.float32))
    assert grade is not None and grade[0] in range(4)


def test_checkpoint_weights_in_jax_unet(tmp_path):
    state = _state(seed=5, steps=2, feats=(32, 64))
    path = ck.save_checkpoint(str(tmp_path / "best_j"), state)
    params, bstats = ck.load_inference_weights(path)
    x = np.random.default_rng(3).normal(size=(1, 8, 16, 16, 4)).astype(
        np.float32)
    jm = JUNet3D(out_channels=4, features=(32, 64), dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False)[
        "logits"])({"params": params, "batch_stats": bstats},
                   jnp.asarray(x)))
    out = state.model(torch.from_numpy(x)).numpy()
    d = np.abs(out - ref)
    scale = max(np.abs(ref).max(), 1.0)
    assert d.max() <= 2 ** -5 * scale and d.mean() <= 2 ** -9 * scale
