"""The port's ps2d region on D slabs (mesh ``space`` > 1), on gloo worlds
of CPU processes (tests/_torch_parallel_workers.py), against the whole
volume: the region's kernels run their plain versions, the JAX Pallas
kernels run in interpret mode (as tests/test_torch_level1.py runs them),
and no tensor of the region is gathered.

* float64 pieces on two slabs, each within 1e-12 of the same function on
  the whole volume: the halo-layout exchange's gradient (both volume
  ends included), K1's plain version with live D halo planes (two
  inputs, affine + ReLU + ``in_mul0`` + statistics), K6's forward and
  its data and weight gradients (a cotangent with garbage on its halo);
* at features (32, 64), 16^3, dropout 0, the weights moved by the
  bridge, data 1 x space 2: the ``ps2d_train`` step in f32 against JAX's
  ``UNet3D(ps2d_train=True)`` on the whole volume (the function JAX's
  GSPMD step computes: it gathers the region's inputs) under
  tests/test_torch_f32_region.py's bounds (loss within 1e-5 relative,
  every gradient leaf at cosine >= 0.9999 and norm ratio within 1e-3),
  and against the port's one-process step (loss within 1e-6 relative,
  least leaf cosine >= 0.99999); the same in bf16 under the ps2d drift
  bounds (loss within 1e-2 relative, cosine >= 0.9); K6 called 3 times a
  step on each rank.

The slab eval region and ``deep_sup_full_res`` on slabs are in
tests/test_torch_spatial_ps2d_eval.py. Both worlds start first; JAX's
two steps run in threads, and one process takes its steps, while the
ranks run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parallel_workers import World, _ndhwc_conv, dp_train_step
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_loss_fn as j_make_loss_fn)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

FEATS, DEEP_FEATS = (32, 64), (8, 16, 32)


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def pieces_inputs():
    """Global float64 arrays of the pieces' world: a halo tensor with
    values everywhere (the exchange), two zero-halo inputs, a mask, an
    affine and weights (K1), two interiors, weights and a cotangent with
    garbage on its halo (K6)."""
    rng = np.random.default_rng(0)
    B, D, H, W = 1, 8, 6, 6
    r = rng.normal

    def packed(c):
        return np.pad(r(size=(B, D, H, W, c)), ((0, 0),) + ((1, 1),) * 3
                      + ((0, 0),))
    return {"xh": r(size=(B, D + 2, H + 2, W + 2, 3)),
            "w_x": r(size=(3, 3, 3, 3, 4)), "c_x": r(size=(B, D, H, W, 4)),
            "x0": packed(3), "x1": packed(2),
            "mul0": rng.random((B, D + 2, H + 2, W + 2, 3)),
            "w1": r(size=(3, 3, 3, 5, 4)) * 0.3,
            "scale": 1 + 0.3 * r(size=(B, 5)), "shift": 0.3 * r(size=(B, 5)),
            "i0": r(size=(B, D, H, W, 3)), "i1": r(size=(B, D, H, W, 2)),
            "w6": r(size=(3, 3, 3, 5, 4)) * 0.3,
            "c6": r(size=(B, D + 2, H + 2, W + 2, 4))}


def model_inputs():
    """The weights at features (32, 64) and (8, 16, 32), a batch of one
    16^3 volume with a label mask the net can fit, and 2 windows."""
    rng = np.random.default_rng(4)
    batch = {"image": rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32),
             "mask": ((rng.random((1, 16, 16, 16)) < 0.2) * 2).astype(
                 np.int32)}
    return {"state": _state(UNet3D(features=FEATS, seed=3, device="cpu")),
            "deep_state": _state(UNet3D(features=DEEP_FEATS, seed=5,
                                        device="cpu")),
            "batch": batch,
            "wins": rng.normal(size=(2, 16, 16, 16, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_ps2d")
    p, m = pieces_inputs(), model_inputs()
    worlds = {"pieces": (p, World("ps2d_pieces", (p,), tmp)),
              "model": (m, World("spatial_ps2d_train", (m,), tmp,
                                 timeout=300))}
    yield worlds
    for _, world in worlds.values():
        world.stop()


# ----------------------------------------------------------------- pieces

@pytest.fixture(scope="module")
def pieces(started):
    d, world = started["pieces"]
    return d, world.results()


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


def _glue(ranks, key):
    """The ranks' gradient of a halo tensor's slabs as the whole tensor's:
    rank 0's planes up to its last interior, rank 1's from its first;
    each live plane's gradient is zero."""
    r0, r1 = (r[key] for r in ranks)
    assert np.all(r0[:, -1] == 0) and np.all(r1[:, 0] == 0)
    return np.concatenate([r0[:, :-1], r1[:, 1:]], axis=1)


def test_exchange_reports_the_live_planes(pieces):
    _, ranks = pieces
    assert [r["live"] for r in ranks] == [(False, True), (True, False)]


def test_halo_exchange_gradient_equals_the_global_function(pieces):
    """A VALID conv of the exchanged slabs is the whole halo tensor's:
    its gradient reaches the volume's two end planes as the whole
    tensor's does, and the neighbours' edge planes through the
    reverse exchange."""
    d, ranks = pieces
    x = _t(d["xh"], True)
    (_ndhwc_conv(_t(d["w_x"]), 0)(x) * _t(d["c_x"])).sum().backward()
    want = x.grad.numpy()
    got = _glue(ranks, "exchange")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for plane in (0, -1, 4, 5):          # the ends, the slabs' edges
        assert np.abs(want[:, plane]).max() > 1.0


def test_k1_plain_with_live_planes_equals_the_whole_volume(pieces):
    d, ranks = pieces
    y, (s1, s2) = T.conv3d_halo(
        (_t(d["x0"]), _t(d["x1"])), _t(d["w1"]), in_scale=_t(d["scale"]),
        in_shift=_t(d["shift"]), in_relu=True, in_mul0=_t(d["mul0"]),
        emit_stats=True)
    y = y.numpy()
    for i, r in enumerate(ranks):
        yr = r["k1"][0]
        np.testing.assert_allclose(yr[:, 1:-1], y[:, 1 + 4 * i:5 + 4 * i],
                                   rtol=0, atol=1e-12)
        assert np.all(yr * (1 - T.halo_mask(torch.from_numpy(yr)).numpy())
                      == 0)
    for k, want in ((1, s1), (2, s2)):
        got = ranks[0]["k1"][k] + ranks[1]["k1"][k]
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=0)
    # the live planes matter: the slab's edge planes see the neighbour
    assert np.abs(y[:, 4:6]).max() > 0.1


def test_k6_on_slabs_equals_the_whole_volume(pieces):
    """K6's forward, data gradients (through the exchange's reverse) and
    weight gradient (summed over the slabs, as the step's reduction sums
    it) on two slabs against the whole volume; the cotangent's halo
    reaches nothing."""
    d, ranks = pieces
    leaves = [_t(d["i0"], True), _t(d["i1"], True)]
    w = _t(d["w6"], True)
    y = T.conv3d_halo_train([T.pack_halo_plain(v) for v in leaves], w)
    (y * _t(d["c6"])).sum().backward()
    y = y.detach().numpy()
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["k6"][0][:, 1:-1],
                                   y[:, 1 + 4 * i:5 + 4 * i], rtol=0,
                                   atol=1e-12)
    for j, v in enumerate(leaves):
        got = np.concatenate([r["k6"][1 + j] for r in ranks], axis=1)
        np.testing.assert_allclose(got, v.grad.numpy(), rtol=0, atol=1e-12)
    dw = ranks[0]["k6"][3] + ranks[1]["k6"][3]
    np.testing.assert_allclose(dw, w.grad.numpy(), rtol=0, atol=1e-12)


def test_k6_plain_with_live_planes_is_k6(pieces):
    """``conv3d_halo_train_plain`` with live planes (autograd through
    the plain K1) gives K6's gradients on the CPU, for inputs whose halo
    is zero but on their live planes."""
    d, _ = pieces
    rng = np.random.default_rng(1)
    c = rng.normal(size=(1, 6, 5, 5, 4))
    for live in ((True, False), (False, True), (True, True)):
        xs = [rng.normal(size=(1, 6, 5, 5, ch)) for ch in (3, 2)]
        for x in xs:
            x *= T.halo_mask(torch.from_numpy(x), live).numpy()
        grads = []
        for fn in (T.conv3d_halo_train, T.conv3d_halo_train_plain):
            ins = [_t(x, True) for x in xs]
            w = _t(d["w6"], True)
            (fn(ins, w, live) * _t(c)).sum().backward()
            grads.append([v.grad.numpy() for v in (*ins, w)])
        for a, b in zip(*grads):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        for plane, on in zip((0, -1), live):
            assert (np.abs(grads[0][0][:, plane]).max() > 0) == on


# ------------------------------------------------------------------ model

def _jax_train_grads(state, batch, dtype):
    """JAX's ``UNet3D(ps2d_train=True)`` loss and gradients on the whole
    batch (dropout 0), from the port's weights."""
    variables = to_flax_variables({k: torch.from_numpy(v)
                                   for k, v in state.items()})
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=dtype,
                 dropout_rate=0.0, ps2d_train=True)
    jloss = j_make_loss_fn(JConfig())

    def loss(params):
        out, _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(batch["image"]), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jloss(out, jnp.asarray(batch["mask"]))

    value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    return float(value), _leaves(jax.tree_util.tree_map(np.asarray, grads))


def _one_process(state, batch, dtype):
    model = UNet3D(features=FEATS, ps2d_train=True, dropout_rate=0.0,
                   compute_dtype=dtype, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return dp_train_step(model, batch)


@pytest.fixture(scope="module")
def worlds(started):
    d, world = started["model"]
    with ThreadPoolExecutor(2) as pool:
        jobs = {f"jax_{dt}": pool.submit(_jax_train_grads, d["state"],
                                         d["batch"], getattr(jnp, dt))
                for dt in ("float32", "bfloat16")}
        one = {dt: _one_process(d["state"], d["batch"], dt)
               for dt in ("float32", "bfloat16")}
        out = {k: v.result() for k, v in jobs.items()}
    out.update(one=one, inputs=d, ranks=world.results())
    return out


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def _flax(named):
    """Port leaves by name (parameters or gradients) as flax paths."""
    return _leaves(to_flax_variables({k: torch.from_numpy(v)
                                      for k, v in named.items()})["params"])


def test_each_rank_runs_the_region_on_its_slab(worlds):
    for r in worlds["ranks"]:
        assert r["depth"] == 8
        for dt in ("float32", "bfloat16"):
            assert r[dt]["calls"]["conv3d_halo_train"] == 3, r[dt]["calls"]


@pytest.mark.parametrize("dtype,rel,cos,ratio", [
    ("float32", 1e-5, 0.9999, 1e-3), ("bfloat16", 1e-2, 0.9, None)])
def test_slab_ps2d_train_step_matches_jax(worlds, dtype, rel, cos, ratio):
    """f32 under tests/test_torch_f32_region.py's bounds; bf16 under the
    ps2d drift bounds of tests/test_torch_train_step.py (norm ratio in
    [0.5, 2])."""
    jl, jg = worlds[f"jax_{dtype}"]
    checked = 0
    for r in worlds["ranks"]:
        got = r[dtype]
        assert abs(got["metrics"]["loss"] - jl) <= rel * max(abs(jl), 1.0)
        grads = _flax(got["grads"])
        assert set(grads) == set(jg)
        checked = 0
        for k, b in jg.items():
            a, b = grads[k].ravel(), b.ravel()
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            if k == "/head_conv/bias" or nb < 1e-6 or b.size < 8:
                continue      # zero in exact arithmetic; a scalar
            assert a @ b / (na * nb) >= cos, k
            if ratio is None:
                assert 0.5 <= na / nb <= 2.0, k
            else:
                assert abs(na / nb - 1) <= ratio, k
            checked += 1
    assert checked >= 40


def _least_cosine(got, want):
    cmin, n = 1.0, 0
    top = max(np.linalg.norm(v) for v in want.values())
    for k, b in want.items():
        a, b = got[k].ravel().astype(np.float64), b.ravel().astype(np.float64)
        if k == "head_conv.bias" or k.endswith(".psi.bias"):
            # taken away by a normalisation: rounding noise, small
            assert max(np.linalg.norm(a), np.linalg.norm(b)) <= 1e-3 * top, k
            continue
        cmin = min(cmin, a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        n += 1
    assert n > 40
    return cmin


@pytest.mark.parametrize("dtype,rel,cos", [("float32", 1e-6, 0.99999),
                                           ("bfloat16", 1e-2, 0.9)])
def test_slab_ps2d_train_step_equals_one_process(worlds, dtype, rel, cos):
    want = worlds["one"][dtype]
    for r in worlds["ranks"]:
        got = r[dtype]
        assert got["metrics"]["loss"] == pytest.approx(
            want["metrics"]["loss"], rel=rel)
        assert _least_cosine(got["grads"], want["grads"]) >= cos
    a, b = (worlds["ranks"][i][dtype]["params"] for i in (0, 1))
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k], err_msg=k)


