"""Five train steps of the port against five of the JAX package, on the
CPU: the same parameters (moved by the weight bridge), the same batch,
dropout off, the normal path at features (32, 64), Config() defaults
(deep-supervision combined loss, AdamW with SGDR).

Each step's loss within 1e-2 relative and gradient norm within 5e-2
relative of JAX's: bf16 forwards and backwards on both sides, and Adam
turns a rounding difference on a near-zero gradient into a full lr step,
so the trajectories drift apart a little with every update. The head
BatchNorm's running variance after the five updates within 1e-2.
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
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.config import (
    Config)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    create_train_state, make_train_step)

FEATS = (32, 64)


def _batch(seed, b=2, shape=(8, 16, 16)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, *shape, 4)).astype(np.float32)
    y = ((rng.random((b, *shape)) < 0.2) * 2).astype(np.int32)
    return {"image": torch.from_numpy(x), "mask": torch.from_numpy(y).long()}


def test_five_steps_track_jax():
    batch = _batch(7)
    model = UNet3D(features=FEATS, seed=4, device="cpu", dropout_rate=0.0)
    variables = to_flax_variables(model.state_dict())
    jm = JMOD.UNet3D(out_channels=4, features=FEATS, dtype=jnp.bfloat16,
                     dropout_rate=0.0)
    cfg = JConfig()
    jstate = j_create_train_state(jm, cfg, jax.random.PRNGKey(0),
                                  (1, 8, 16, 16, 4), steps_per_epoch=2)
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    jstep = j_make_train_step(cfg, donate=False)
    jb = {"image": jnp.asarray(batch["image"].numpy()),
          "mask": jnp.asarray(batch["mask"].numpy().astype(np.int32))}
    state = create_train_state(model, Config(), steps_per_epoch=2)
    step = make_train_step(Config())
    losses = []
    for i in range(5):
        jstate, jm_ = jstep(jstate, jb, jax.random.PRNGKey(i))
        state, m = step(state, batch, None)
        losses.append(float(m["loss"]))
        assert losses[-1] == pytest.approx(float(jm_["loss"]), rel=1e-2), i
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=5e-2), i
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(model.head_bn.var.numpy(),
                               np.asarray(jstate.batch_stats["head_bn"]["var"]),
                               rtol=1e-2)
