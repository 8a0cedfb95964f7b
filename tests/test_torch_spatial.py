"""The port's spatially sharded U-Net (mesh ``space`` > 1) on gloo worlds
of CPU processes (tests/_torch_parallel_workers.py), against the JAX
package and against one process:

* the halo exchange's gradient (float64, x (1, 8, 6, 6, 3) over two D
  slabs, a conv to 4 channels): ``sharded_conv3d`` and the exchange at
  halo 1 and 2 with both boundaries, each against the global function's
  gradient within 1e-12, and the exchange without a group;
* at features (8, 16), 16^3, f32, dropout 0, the weights moved by the
  bridge: the train step at data 1 x space 2 against JAX's
  ``make_train_step(mesh=create_mesh(1, 2))`` on two virtual CPU devices
  (loss within 1e-5 relative, the parameters after the step within
  ``atol 1e-5, rtol 1e-3``, tests/test_parallel.py's tolerance) and
  against one process (loss within 1e-6 relative, least leaf cosine of
  the gradients >= 0.99999); the same step under ``remat``, and the
  joint step; the parameters bit-identical across the ranks (data 2 x
  space 2, four ranks: tests/test_torch_spatial_mesh.py);
* the spatial sliding-window forward (``make_spatial_apply``) against
  JAX's unsharded one within ``atol 1e-4, rtol 1e-3``
  (``__graft_entry__.py``'s tolerance); the eval step's loss, region
  Dice and HD95 against one process;
* the slab forward's refusal of an odd depth, the slab forwards that
  the previous slice refused (the ps2d regions, ``deep_sup_full_res``)
  running on each slab, and the deep-supervision targets: a slab's
  nearest-resized targets are the resized targets' slab.

Both worlds start first; the model's runs while JAX compiles its step
and its sliding window and one process takes its steps, in threads.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parallel_workers import (World, _ndhwc_conv, dp_eval_step,
                                     dp_train_step, joint_model)
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference.sliding_window import (
    sliding_window_inference as j_sliding_window_inference)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.parallel import (
    create_mesh as j_create_mesh, replicated as j_replicated)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_train_step as j_make_train_step)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train.state import (
    TrainState as JTrainState, build_optimizer as j_build_optimizer)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, UNet3DWithClassifier, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.resize import (
    resize_nearest)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel.spatial import (
    halo_exchange_d)

KW = dict(features=(8, 16), compute_dtype="float32", dropout_rate=0.0)
CASES = [f"{b}{h}" for b in ("edge", "zero") for h in (1, 2)]


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _unet(state, **kw):
    from _torch_parallel_workers import _unet as build
    return build(state, **KW, **kw)


def _pad(x, halo, boundary):
    """The global volume padded in D as the exchange pads the ends."""
    if boundary == "zero":
        z = torch.zeros_like(x[:, :halo])
        return torch.cat([z, x, z], 1)
    return torch.cat([x[:, :1].expand_as(x[:, :halo]), x,
                      x[:, -1:].expand_as(x[:, :halo])], 1)


def _grad(f, x, c):
    xt = torch.from_numpy(x).requires_grad_()
    (f(xt) * torch.from_numpy(c)).sum().backward()
    return xt.grad.numpy()


def _halo_fn(ws, case, exchange=None):
    """The global function of ``case``: the conv VALID in D of the volume
    padded by ``halo`` planes (``exchange``: pad through
    ``halo_exchange_d`` without a group instead)."""
    b, h = case[:-1], int(case[-1])
    conv = _ndhwc_conv(torch.from_numpy(ws[h]), (0, 1, 1))
    pad = exchange or _pad
    return lambda v: conv(pad(v, h, b))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both worlds of this file, started at once: the exchange's, on
    x (1, 8, 6, 6, 3) float64, and the model's (``inputs()``)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 6, 6, 3))
    ws = {h: rng.normal(size=(2 * h + 1, 3, 3, 3, 4)) for h in (1, 2)}
    cs = {k: rng.normal(size=(1, 8, 6, 6, 4)) for k in ["sharded"] + CASES}
    tmp = tmp_path_factory.mktemp("spatial")
    d = inputs()
    return {"exchange": (x, ws, cs, World("exchange_grads", (x, ws, cs),
                                          tmp)),
            "inputs": d,
            "model": World("spatial_model", (d["state"], d["joint"],
                                             d["batch"], d["vol"]),
                           tmp, timeout=240)}


@pytest.fixture(scope="module")
def exchange(started):
    x, ws, cs, world = started["exchange"]
    return x, ws, cs, world.results()


@pytest.mark.parametrize("case", ["sharded"] + CASES)
def test_exchange_gradient_equals_the_global_function(exchange, case):
    x, ws, cs, ranks = exchange
    if case == "sharded":
        fn = _ndhwc_conv(torch.from_numpy(ws[1]), 1)
    else:
        fn = _halo_fn(ws, case)
    want = _grad(fn, x, cs[case])
    got = np.concatenate([r[case] for r in ranks], axis=1)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(want[:, 3:5]).max() > 1.0      # the slab-edge planes


@pytest.mark.parametrize("case", CASES)
def test_exchange_without_a_group_is_the_padded_volume(exchange, case):
    x, ws, cs, _ = exchange
    b, h = case[:-1], int(case[-1])
    xt = torch.from_numpy(x)
    assert torch.equal(halo_exchange_d(xt, h, None, b), _pad(xt, h, b))
    want = _grad(_halo_fn(ws, case), x, cs[case])
    got = _grad(_halo_fn(ws, case, lambda v, hh, bb: halo_exchange_d(
        v, hh, None, bb)), x, cs[case])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# ------------------------------------------------------------------ model

def _jax_config():
    c = JConfig()
    return c.replace(model=dataclasses.replace(
        c.model, features=(8, 16), compute_dtype="float32", remat=False),
        use_tensorboard=False)


def _jax_step(state, batch, data, space):
    """JAX's GSPMD train step on a (data, space) mesh of the first
    data * space virtual CPU devices, from the port's weights: (loss,
    parameters after the step). The state is ``create_train_state``'s
    with the port's weights, built without its jitted init."""
    variables = to_flax_variables(_unet(state).state_dict())
    model = JUNet3D(out_channels=4, features=(8, 16), dtype=jnp.float32,
                    dropout_rate=0.0)
    cfg = _jax_config()
    mesh = j_create_mesh(data, space, devices=jax.devices()[:data * space])
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
    return float(metrics["loss"]), jax.tree_util.tree_map(np.asarray,
                                                          new.params)


def inputs():
    """The weights (U-Net and joint model), a global batch of 2 and a
    (24, 16, 16, 4) volume, from seeds."""
    rng = np.random.default_rng(4)
    state = _state(UNet3D(seed=3, device="cpu", **KW))
    joint = _state(UNet3DWithClassifier(features=(8, 16), seed=5,
                                        device="cpu", dropout_rate=0.0,
                                        compute_dtype="float32"))
    batch = {"image": rng.normal(size=(2, 16, 16, 16, 4)).astype(np.float32),
             "mask": rng.integers(0, 4, (2, 16, 16, 16)).astype(np.int32)}
    vol = rng.normal(size=(24, 16, 16, 4)).astype(np.float32)
    return {"state": state, "joint": joint, "batch": batch, "vol": vol}


def _jax_window(state, vol):
    jm = JUNet3D(out_channels=4, features=(8, 16), dtype=jnp.float32,
                 dropout_rate=0.0)
    variables = to_flax_variables(_unet(state).state_dict())
    return np.asarray(j_sliding_window_inference(
        variables, jnp.asarray(vol),
        lambda v, p: jm.apply(v, p, train=False)["logits"],
        roi_size=(16, 16, 16), overlap=0.5, sw_batch_size=2))


def one_process_steps(d):
    """One process's train step, joint step and eval step on the whole
    batch."""
    return {"step": dp_train_step(_unet(d["state"]), d["batch"]),
            "joint": dp_train_step(joint_model(d["joint"]), d["batch"],
                                   joint=True),
            "eval": dp_eval_step(_unet(d["state"]), d["batch"])}


@pytest.fixture(scope="module")
def worlds(started):
    """While the model's world runs: JAX's (1, 2) step, its unsharded
    sliding window and one process's steps, in three threads."""
    d = dict(started["inputs"])
    with ThreadPoolExecutor(3) as pool:
        step = pool.submit(_jax_step, d["state"], d["batch"], 1, 2)
        window = pool.submit(_jax_window, d["state"], d["vol"])
        one = pool.submit(one_process_steps, d)
        d["jax"] = {"1x2": step.result(), "window": window.result()}
        d["one"] = one.result()
    d["two"] = started["model"].results()
    return d


@pytest.fixture(scope="module")
def one_process(worlds):
    return worlds["one"]["step"]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v, np.float32)


def _flax_params(named):
    tree = to_flax_variables({k: torch.from_numpy(v)
                              for k, v in named.items()})
    return dict(_leaves(tree["params"]))


def _normed_away(name: str) -> bool:
    """A bias that a normalisation takes away, so that its gradient is
    zero in exact arithmetic and what is computed is rounding noise:
    ``head_conv.bias`` (the BatchNorm on batch statistics), each gate's
    ``psi`` bias (``GroupNorm(1, 1)``) and, at the level of width 8, the
    gate's ``w_g`` and ``w_x`` biases (a GroupNorm of 4 groups over its
    4 channels). Adam's first step moves such a leaf by noise / (|noise|
    + eps) times the rate: anywhere within one rate of where it was."""
    name = name.removeprefix("unet.")
    return (name == "head_conv.bias" or name.endswith(".psi.bias")
            or name in {"att1.w_g.bias", "att1.w_x.bias"})


def _least_cosine(got, want):
    """The least cosine over the gradient leaves; of a leaf that a
    normalisation takes away (``_normed_away``) only the smallness of
    the gradient is checked."""
    cmin, n = 1.0, 0
    top = max(np.linalg.norm(v) for v in want.values())
    for k, b in want.items():
        a, b = got[k].ravel().astype(np.float64), b.ravel().astype(np.float64)
        if _normed_away(k):
            assert max(np.linalg.norm(a), np.linalg.norm(b)) <= 1e-5 * top, k
            continue
        if np.linalg.norm(b) < 1e-12:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        cmin = min(cmin, a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        n += 1
    assert n > 40
    return cmin


def test_each_rank_holds_its_slab(worlds):
    two = worlds["two"]
    assert [r["mesh"] for r in two] == [{"data": 1, "space": 2}] * 2
    assert [r["depth"] for r in two] == [8, 8]


def check_step_matches_jax(worlds, ranks, mesh):
    """The leaves that a normalisation takes away (``_normed_away``) are
    held within one learning rate of their start on both sides; every
    other leaf to JAX's within tests/test_parallel.py's tolerance."""
    jloss, jparams = worlds["jax"][mesh]
    want = dict(_leaves(jparams))
    start = _flax_params({k: v for k, v in worlds["state"].items()
                          if k not in ("head_bn.mean", "head_bn.var")})
    lr = _jax_config().optimizer.learning_rate
    away = {"/" + k.replace(".", "/") for k in worlds["state"]
            if _normed_away(k)}
    assert len(away) == 5
    for r in ranks:
        assert r["step"]["metrics"]["loss"] == pytest.approx(jloss, rel=1e-5)
        got = _flax_params(r["step"]["params"])
        assert set(got) == set(want) and len(want) > 40
        for k, v in want.items():
            if k in away:
                for side in (got[k], v):
                    assert np.abs(side - start[k]).max() <= lr * 1.001, k
                continue
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-3,
                                       err_msg=k)


def test_spatial_step_matches_jax_gspmd_step(worlds):
    check_step_matches_jax(worlds, worlds["two"], "1x2")


def check_bit_identical(ranks, part):
    first = ranks[0][part]
    for r in ranks[1:]:
        assert set(r[part]["params"]) == set(first["params"])
        for k, v in first["params"].items():
            np.testing.assert_array_equal(r[part]["params"][k], v,
                                          err_msg=(part, k))
        assert r[part]["metrics"] == first["metrics"]


@pytest.mark.parametrize("part", ["step", "remat", "joint"])
def test_spatial_parameters_bit_identical_across_ranks(worlds, part):
    check_bit_identical(worlds["two"], part)


def check_equals_one_process(ranks, part, want):
    """The slab step's loss, metrics, gradients and BatchNorm statistics
    against one process on the whole batch."""
    for r in ranks:
        got = r[part]
        assert got["metrics"]["loss"] == pytest.approx(
            want["metrics"]["loss"], rel=1e-6)
        for k in ("dice", "grad_norm"):
            assert got["metrics"][k] == pytest.approx(want["metrics"][k],
                                                      rel=1e-5), k
        assert _least_cosine(got["grads"], want["grads"]) >= 0.99999
        for g, w in zip(got["bn"], want["bn"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("part", ["step", "remat"])
def test_spatial_step_equals_one_process(worlds, one_process, part):
    """``remat``: the backward replays each block's exchanges and
    all-reduces, in the same order on both ranks."""
    check_equals_one_process(worlds["two"], part, one_process)


def test_spatial_joint_step_equals_one_process(worlds):
    want = worlds["one"]["joint"]
    for r in worlds["two"]:
        got = r["joint"]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-5,
                                                      abs=1e-6), k
        assert _least_cosine(got["grads"], want["grads"]) >= 0.99999


def test_spatial_sliding_window_matches_jax_unsharded(worlds):
    want = worlds["jax"]["window"]
    for r in worlds["two"]:
        assert r["window"].shape == want.shape == (24, 16, 16, 4)
        np.testing.assert_allclose(r["window"], want, atol=1e-4, rtol=1e-3)


def test_spatial_eval_step_equals_one_process(worlds):
    want = worlds["one"]["eval"]
    for i, r in enumerate(worlds["two"]):
        got = r["eval"]
        assert set(got) == set(want)
        for k in ("loss", "dice", "dice_WT", "dice_TC", "dice_ET"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                                  abs=1e-6), k
        np.testing.assert_allclose(got["hausdorff"], want["hausdorff"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(
            got["pred_labels"], want["pred_labels"][:, 8 * i:8 * i + 8])


@pytest.mark.parametrize("what,kind,words", [
    ("odd_depth", "ValueError", "multiple of space * 2^2 = 8")])
def test_slab_forward_refusals(worlds, what, kind, words):
    for r in worlds["two"]:
        got = r["refusals"][what]
        assert got is not None and got[0] == kind and words in got[1], got


@pytest.mark.parametrize("what,logits,deep,calls", [
    # deep heads at full resolution: the slab's depth at every level
    ("deep_sup_full_res", (2, 8, 16, 16, 4), [(2, 8, 16, 16, 4)] * 2,
     {}),
    # the train region: K6 three times (enc0.conv2, dec0's two convs)
    ("ps2d_train", (2, 8, 16, 16, 4), [(2, 8, 16, 16, 4)],
     {"conv3d_halo_train": 3}),
    # the level-0 eval region: K1 three times, K2 once, K3 twice
    ("ps2d_eval", (2, 8, 16, 16, 4), [],
     {"conv3d_halo": 3, "up_k2s2_into_halo": 1, "pack_halo": 2})])
def test_slab_forward_runs_what_was_refused(worlds, what, logits, deep,
                                            calls):
    """The slab forwards that the previous spatial slice refused run on
    each rank's slab (their values against the whole volume:
    tests/test_torch_spatial_ps2d*.py)."""
    for r in worlds["two"]:
        got = r["runs"][what]
        assert got["finite"] and got["logits"] == logits, got
        assert got["deep"] == deep, got
        assert {k: v for k, v in got["calls"].items() if v} == calls, got


@pytest.mark.parametrize("ranks", [2, 4])
def test_resized_slab_targets_are_slabs_of_resized_targets(ranks):
    """deep_supervision_loss resizes each rank's slab of the targets to
    its head's slab shape; with every slab's depth a multiple of the
    levels' 2^i, that is the resized targets' slab."""
    t = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, (2, 16, 16, 16, 1)).astype(np.int32))
    d = 16 // ranks
    for level in (1, 2):
        size = (16 >> level,) * 3
        whole = resize_nearest(t, size)
        for r in range(ranks):
            part = resize_nearest(t[:, d * r:d * (r + 1)],
                                  (d >> level,) + size[1:])
            np.testing.assert_array_equal(
                part.numpy(), whole[:, (d >> level) * r:
                                    (d >> level) * (r + 1)].numpy())
