"""The port's ps2d eval region and ``deep_sup_full_res`` on D slabs
(mesh data 1 x space 2), on a gloo world of CPU processes
(tests/_torch_parallel_workers.py), against JAX's whole-volume
functions (tests/test_torch_spatial_ps2d.py has the slab pieces and the
``ps2d_train`` step):

* the eval forward at ``ps2d_eval, ps2d_levels=2`` (features (32, 64),
  f32, 2 windows of 16^3) through ``make_spatial_apply`` against JAX's
  unsharded forward (Pallas in interpret mode) within ``atol 1e-4, rtol
  1e-3`` (``__graft_entry__.py``'s tolerance), both sides counted into
  the level-2 region: the port's K1 / K2 / K3 / K4 wrappers 7 / 2 / 2 /
  1 times a rank, JAX's kernels as often, so that a silent fallback
  fails; no tensor of the region is gathered;
* the ``deep_sup_full_res`` step at features (8, 16, 32), dropout 0 (the
  level-1 head resized by 2 on each slab through an edge-clamped
  exchange) against JAX's ``make_train_step(mesh=create_mesh(1, 2))`` on
  two virtual CPU devices, at tests/test_torch_spatial.py's tolerances.

The world starts first; JAX's forward and step compile in threads while
the ranks run.
"""

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parallel_workers import World
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.parallel import (
    create_mesh as j_create_mesh, replicated as j_replicated)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_train_step as j_make_train_step)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train.state import (
    TrainState as JTrainState, build_optimizer as j_build_optimizer)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    to_flax_variables)

from test_torch_spatial_ps2d import DEEP_FEATS, FEATS, _flax, _leaves, model_inputs

JAX_KERNELS = ("ps2d_conv3d_flat_multi", "up_k2s2_into_flat",
               "pack_flat_fast", "pool_into_flat")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = model_inputs()
    world = World("spatial_ps2d_eval", (d,),
                  tmp_path_factory.mktemp("spatial_ps2d_eval"), timeout=300)
    try:
        counts = {}
        with ThreadPoolExecutor(2) as pool:
            window = pool.submit(_jax_window, d["state"], d["wins"], counts)
            deep = pool.submit(_jax_deep_step, d["deep_state"], d["batch"])
            out = {"jax_window": window.result(), "jax_deep": deep.result()}
        out.update(jax_counts=counts, inputs=d, ranks=world.results())
    finally:
        world.stop()
    return out


def _jax_window(state, wins, counts):
    """JAX's unsharded eval forward at ``ps2d_eval, ps2d_levels=2`` in
    f32; ``counts``: its region's kernels, counted at trace time in this
    thread (the train steps' threads reach the same functions)."""
    variables = to_flax_variables({k: torch.from_numpy(v)
                                   for k, v in state.items()})
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.float32,
                 ps2d_eval=True, ps2d_levels=2)
    saved = {k: getattr(J, k) for k in JAX_KERNELS}
    me = threading.get_ident()

    def counted(name):
        def wrapper(*a, **k):
            if threading.get_ident() == me:
                counts[name] = counts.get(name, 0) + 1
            return saved[name](*a, **k)
        return wrapper
    for k in JAX_KERNELS:
        setattr(J, k, counted(k))
    try:
        return np.asarray(jax.jit(
            lambda v, a: jm.apply(v, a, train=False)["logits"])(
                variables, jnp.asarray(wins)))
    finally:
        for k, fn in saved.items():
            setattr(J, k, fn)


def _jax_config(features):
    c = JConfig()
    return c.replace(model=dataclasses.replace(
        c.model, features=features, compute_dtype="float32", remat=False),
        use_tensorboard=False)


def _jax_deep_step(state, batch):
    """JAX's GSPMD train step of ``UNet3D(deep_sup_full_res=True)`` at
    features (8, 16, 32) on a (1, 2) mesh of two virtual CPU devices:
    (loss, parameters after the step)."""
    variables = to_flax_variables({k: torch.from_numpy(v)
                                   for k, v in state.items()})
    model = JUNet3D(out_channels=4, features=DEEP_FEATS, dtype=jnp.float32,
                    dropout_rate=0.0, deep_sup_full_res=True)
    cfg = _jax_config(DEEP_FEATS)
    mesh = j_create_mesh(1, 2, devices=jax.devices()[:2])
    js = JTrainState.create(
        apply_fn=model.apply,
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        ema_params=None, tx=j_build_optimizer(cfg.optimizer, 1))
    js = jax.device_put(js, j_replicated(mesh))
    step = j_make_train_step(cfg, mesh=mesh, donate=False)
    new, metrics = step(js, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(1))
    return float(metrics["loss"]), _leaves(jax.tree_util.tree_map(
        np.asarray, new.params))


def test_slab_eval_region_matches_jax_unsharded(worlds):
    counts = worlds["jax_counts"]
    want = {"conv3d_halo": 7, "up_k2s2_into_halo": 2, "pack_halo": 2,
            "pool_into_halo": 1}
    assert [counts.get(k, 0) for k in JAX_KERNELS] == list(want.values())
    ref = np.asarray(worlds["jax_window"])
    for r in worlds["ranks"]:
        assert {k: r["eval_calls"][k] for k in want} == want
        assert r["eval_calls"]["conv3d_halo_train"] == 0
        assert r["eval"].shape == ref.shape == (2, 16, 16, 16, 4)
        np.testing.assert_allclose(r["eval"], ref, atol=1e-4, rtol=1e-3)


def test_slab_deep_sup_full_res_step_matches_jax_gspmd(worlds):
    """Loss within 1e-5 relative; the parameters after the step within
    ``atol 1e-5, rtol 1e-3``, those that a normalisation takes away
    (their gradient rounding noise, Adam's step of one rate in any
    direction) within one rate of their start on both sides."""
    jl, jp = worlds["jax_deep"]
    start = _flax({k: v for k, v in worlds["inputs"]["deep_state"].items()
                   if k not in ("head_bn.mean", "head_bn.var")})
    lr = _jax_config(DEEP_FEATS).optimizer.learning_rate
    away = {"/head_conv/bias", "/att2/w_g/bias", "/att2/w_x/bias"} | {
        f"/att{i}/psi/bias" for i in range(3)}
    for r in worlds["ranks"]:
        got = r["deep"]
        assert got["metrics"]["loss"] == pytest.approx(jl, rel=1e-5)
        params = _flax(got["params"])
        assert set(params) == set(jp) and away <= set(jp)
        for k, v in jp.items():
            if k in away:
                for side in (params[k], v):
                    assert np.abs(side - start[k]).max() <= lr * 1.001, k
                continue
            np.testing.assert_allclose(params[k], v, atol=1e-5, rtol=1e-3,
                                       err_msg=k)
