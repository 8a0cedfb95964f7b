"""``convert_orbax_checkpoint.py``: a JAX trainer checkpoint (Orbax,
written by the JAX package's ``save_checkpoint``) converted into the
port's format and read back by the port's ``restore_checkpoint``:
``params``, ``batch_stats``, AdamW's ``mu`` / ``nu`` and ``count``,
``step`` and ``ema_params`` bit-equal to what JAX saved, for optax's
``adamw`` alone and for the chain ``clip_by_global_norm`` -> ``adamw``,
with and without an EMA; the metadata carried over; and a params-only
export converted to ``params.pt``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import convert_orbax_checkpoint as C
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import config as jcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    checkpoints as jck, state as jstate)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import config as tcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    checkpoints as ck, create_train_state)

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
        assert la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _jax_state(clip: float, ema: bool, seed: int = 0):
    """A JAX TrainState with every optimizer leaf and the EMA made random
    (count and step 7), as a trained state holds them."""
    rng = np.random.default_rng(seed)
    var = to_flax_variables(UNet3D(features=FEATS, seed=seed,
                                   device="cpu").state_dict())
    conf = jcfg.Config(optimizer=jcfg.OptimizerConfig(grad_clip_norm=clip))

    def rand(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.asarray(np.full(x.shape, 7, x.dtype))
        return jnp.asarray(rng.normal(size=x.shape).astype(x.dtype))
    params = jax.tree_util.tree_map(jnp.asarray, var["params"])
    state = jstate.TrainState.create(
        apply_fn=JUNet3D(features=FEATS).apply, params=params,
        tx=jstate.build_optimizer(conf.optimizer, steps_per_epoch=2),
        batch_stats=jax.tree_util.tree_map(rand, var["batch_stats"]),
        ema_params=jax.tree_util.tree_map(rand, params) if ema else None)
    return state.replace(opt_state=jax.tree_util.tree_map(rand,
                                                          state.opt_state),
                         step=jnp.asarray(7, jnp.int32))


def _adam(opt_state):
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(s, "mu"):
            return s
    raise AssertionError("no Adam state")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("clip,ema", [(0.0, False), (1.0, True)])
def test_trainer_checkpoint_converts_bit_for_bit(tmp_path, clip, ema):
    js = _jax_state(clip, ema)
    src = jck.save_checkpoint(str(tmp_path / "best_jax"), js,
                              best_dice=0.625, epoch=4,
                              metrics_history={"val_dice": [0.5, 0.625]})
    dst = C.convert(src, str(tmp_path / "best_port"))
    assert os.path.isfile(os.path.join(dst, "state", "state.pt"))

    state = create_train_state(
        UNet3D(features=FEATS, seed=11, device="cpu"),
        tcfg.Config(ema_decay=0.9 if ema else 0.0), steps_per_epoch=2)
    state, meta = ck.restore_checkpoint(dst, state)
    assert meta == json.load(open(os.path.join(src, "trainer_meta.json")))
    tree = ck.state_tree(state)
    adam = _adam(js.opt_state)
    assert_trees_equal(tree["params"], _np(js.params))
    assert_trees_equal(tree["batch_stats"], _np(js.batch_stats))
    assert_trees_equal(tree["opt_state"]["mu"], _np(adam.mu))
    assert_trees_equal(tree["opt_state"]["nu"], _np(adam.nu))
    assert int(tree["opt_state"]["count"]) == int(adam.count) == 7
    assert int(tree["step"]) == int(js.step) == 7
    if ema:
        assert_trees_equal(tree["ema_params"], _np(js.ema_params))
    else:
        assert "ema_params" not in tree
    # serving adopts it as it adopts the port's own checkpoints
    params, bstats = ck.load_inference_weights(dst)
    assert_trees_equal(params, _np(js.ema_params if ema else js.params))


def test_params_only_export_converts(tmp_path):
    js = _jax_state(0.0, False, seed=2)
    src = jck.save_params_only(str(tmp_path / "export"), js.params)
    dst = C.convert(src, str(tmp_path / "port_export"))
    assert os.path.isfile(os.path.join(dst, "params.pt"))
    live = to_flax_variables(UNet3D(features=FEATS, device="cpu")
                             .state_dict())["params"]
    assert_trees_equal(ck.restore_params_only(dst, live), _np(js.params))
    params, bstats = ck.load_inference_weights(dst)
    assert_trees_equal(params, _np(js.params)) and bstats is None


def test_cli(tmp_path, capsys):
    js = _jax_state(0.0, False, seed=3)
    src = jck.save_params_only(str(tmp_path / "export"), js.params)
    assert C.main([src, str(tmp_path / "out")]) == 0
    assert capsys.readouterr().out.strip() == str(tmp_path / "out")
