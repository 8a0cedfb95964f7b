"""The port's data-parallel train, joint and eval steps (``mesh=`` on
``train/loop.py``'s step factories) on a two-rank gloo world of CPU
processes (tests/_torch_parallel_workers.py), each rank on its 2 rows of
a global batch of 4 (16^3, features (8, 16), f32, dropout at rate 0):

* the gradients handed to the optimizer against JAX's single-device
  ``value_and_grad`` on the global batch, JAX's own tolerances
  (tests/test_parallel.py ``test_dp_step_matches_single_device``): the
  loss within 1e-4 relative, each leaf within ``atol 1e-5, rtol 1e-3``;
  the head BatchNorm's new running statistics within 1e-5 of JAX's (its
  batch statistics are the global batch's, through a differentiable
  all-reduce); the step's Dice equal to JAX's on the global batch;
* the parameters after the update bit-identical on both ranks, and the
  step's metrics and gradients within 1e-6 of one process's on the
  global batch;
* ``grad_accum=2`` with a mesh (each rank accumulates its microbatches,
  one reduction) against one process's ``grad_accum=2`` on the batch
  whose microbatches hold the same rows;
* the joint step and the eval step: their reduced metrics against one
  process's on the global batch, the eval step's labels and HD95 this
  rank's rows of one process's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parallel_workers import (dp_eval_step, dp_train_step,
                                     joint_model, run_world)
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.metrics import (
    mean_foreground_dice as j_mean_foreground_dice)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_loss_fn as j_make_loss_fn)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, UNet3DWithClassifier, to_flax_variables)

KW = dict(features=(8, 16), compute_dtype="float32", dropout_rate=0.0)


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _unet(state):
    from _torch_parallel_workers import _unet as build
    return build(state, **KW)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(4)
    state = _state(UNet3D(seed=3, device="cpu", **KW))
    joint = _state(UNet3DWithClassifier(features=(8, 16), seed=5,
                                        device="cpu", dropout_rate=0.0,
                                        compute_dtype="float32"))
    batch = {"image": rng.normal(size=(4, 16, 16, 16, 4)).astype(np.float32),
             "mask": rng.integers(0, 4, (4, 16, 16, 16)).astype(np.int32)}
    ranks = run_world("training", (state, joint, batch),
                      tmp_path_factory.mktemp("training"))
    return state, joint, batch, ranks


@pytest.fixture(scope="module")
def jax_step(world):
    """JAX's single-device loss, gradients, logits and new batch stats on
    the global batch, from the same weights."""
    state, _, batch, _ = world
    variables = to_flax_variables(_unet(state).state_dict())
    model = JUNet3D(out_channels=4, features=(8, 16), dtype=jnp.float32,
                    dropout_rate=0.0)
    loss_fn = j_make_loss_fn(JConfig())

    def loss(params):
        out, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(batch["image"]), train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return loss_fn(out, jnp.asarray(batch["mask"])), (out["logits"],
                                                          mut["batch_stats"])

    (jl, (logits, bs)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                    variables["params"]))
    dice = float(j_mean_foreground_dice(logits, jnp.asarray(batch["mask"])))
    return float(jl), grads, bs, dice


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v, np.float32)


def _flax(named, part="params"):
    """A by-name dict of numpy arrays as the flax tree's leaves."""
    tree = to_flax_variables({k: torch.from_numpy(v)
                              for k, v in named.items()})
    return dict(_leaves(tree[part]))


def test_each_rank_holds_its_rows(world):
    *_, ranks = world
    assert [r["rows"] for r in ranks] == [2, 2]


def test_dp_loss_and_gradients_match_jax_single_device(world, jax_step):
    *_, ranks = world
    jl, jgrads, _, _ = jax_step
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    for r in ranks:
        assert r["step"]["metrics"]["loss"] == pytest.approx(jl, rel=1e-4)
        got = _flax(r["step"]["grads"])
        assert set(got) == set(want) and len(want) > 40
        for k, b in want.items():
            np.testing.assert_allclose(got[k], b, atol=1e-5, rtol=1e-3,
                                       err_msg=k)


def test_dp_batch_norm_statistics_and_dice_match_jax(world, jax_step):
    *_, ranks = world
    _, _, jbs, jdice = jax_step
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jbs)))
    for r in ranks:
        mean, var = r["step"]["bn"]
        got = _flax({"head_bn.mean": mean, "head_bn.var": var},
                    "batch_stats")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
        assert r["step"]["metrics"]["dice"] == pytest.approx(jdice,
                                                             abs=1e-6)


def test_dp_parameters_bit_identical_across_ranks(world):
    *_, ranks = world
    for part in ("step", "accum", "joint"):
        a, b = ranks[0][part]["params"], ranks[1][part]["params"]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(part, k))
        assert ranks[0][part]["metrics"] == ranks[1][part]["metrics"]


def _close(got, want, tol=1e-6):
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-5, abs=tol), k
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=0, atol=tol,
                                   err_msg=k)
    for g, w in zip(got["bn"], want["bn"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_dp_step_equals_one_process(world):
    state, _, batch, ranks = world
    _close(ranks[0]["step"], dp_train_step(_unet(state), batch))


def test_dp_grad_accum_equals_one_process(world):
    """Rank r's microbatch i is global row 2r + i, so the group's
    microbatch i holds rows {i, 2 + i}: one process's grad_accum=2 on the
    batch in the order (0, 2, 1, 3) has the same microbatches."""
    state, _, batch, ranks = world
    order = [0, 2, 1, 3]
    perm = {k: v[order] for k, v in batch.items()}
    _close(ranks[0]["accum"], dp_train_step(_unet(state), perm,
                                            grad_accum=2))


def test_dp_joint_step_equals_one_process(world):
    _, joint, batch, ranks = world
    want = dp_train_step(joint_model(joint), batch, joint=True)
    assert set(want["metrics"]) == {"loss", "seg_loss", "grade_ce",
                                    "grade_acc", "dice"}
    _close(ranks[0]["joint"], want)


def test_dp_eval_step_equals_one_process(world):
    state, _, batch, ranks = world
    want = dp_eval_step(_unet(state), batch)
    for r, out in enumerate(ranks):
        got = out["eval"]
        assert set(got) == set(want)
        for k in ("loss", "dice", "dice_WT", "dice_TC", "dice_ET"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                                  abs=1e-6), k
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(got["pred_labels"],
                                      want["pred_labels"][rows])
        np.testing.assert_allclose(got["hausdorff"], want["hausdorff"][rows],
                                   rtol=1e-6)
