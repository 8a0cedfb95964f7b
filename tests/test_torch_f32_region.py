"""The ps2d region in float32: the port's region kernels' f32 plain
versions and its f32 region forward and train step against the JAX
package's f32 region, on the CPU (the JAX Pallas kernels in interpret
mode, as tests/test_torch_level1.py runs them).

Tolerances are float32's:

  * K1 (``conv3d_halo``, one and two inputs, affine + ReLU, ``mul0``,
    ``emit_stats``) and K2 (``up_k2s2_into_halo``) within 1e-5 *
    max|ref| (f32 sums in another order); K1's sums within 1e-5 of the
    largest sum; K3 (``pack_halo``) and K4 (``pool_into_halo``)
    bit-exact;
  * K1 rounds its f32 weights to bf16 (JAX ``pack_w_rot``) and K2 does
    not (JAX casts them to x.dtype): with weights that bf16 does not
    hold, the other rounding misses JAX by more than the tolerance;
  * ``UNet3D(compute_dtype="float32", ps2d_eval=True)`` at ``ps2d_levels``
    1 and 2: logits within 1e-4 * max(scale, 1) of JAX's, labels under
    the margin contract of test_torch_f32.py;
  * one ``ps2d_train`` step at dropout 0: loss within 1e-5 * max(|loss|,
    1), every gradient leaf at cosine >= 0.9999 and norm ratio within
    1e-3 of 1;
  * the port's f32 region against the port's own f32 normal path given
    K1's weights rounded to bf16 (``UNet3D.k1_kernel_names``), the same
    function: logits within 1e-5 * max(scale, 1) at levels 1 and 2, and
    the train loss and gradients as above, while the unrounded weights
    miss by more (chip_smoke.py's f32region phase holds the card to this
    reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.s2d import (
    space_to_depth_hw)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import (
    make_loss_fn as j_make_loss_fn)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, load_flax_params, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    unet3d as unet3d_module)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

from test_torch_f32 import _margin_contract
from test_torch_level1 import _counting
from test_torch_train_step import flat_leaves, port_step

F32 = torch.float32
FEATS = (32, 64)


def _f32(rng, shape, scale=1.0):
    """Same f32 values for both packages: (numpy, torch)."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return a, torch.from_numpy(a)


def _flat(x_np, plan):
    return J.pack_flat(space_to_depth_hw(jnp.asarray(x_np)), plan)


def _np(t):
    return np.asarray(t, np.float32)


def _close(got, ref, rel=1e-5):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    d = np.abs(got - ref).max()
    assert d <= rel * np.abs(ref).max(), (d, np.abs(ref).max())
    return d


def _zero_halo(y):
    assert y.dtype == F32
    assert (_np(y) * (1 - _np(T.halo_mask(y)))).max() == 0


def test_pack_and_pool_f32_match_jax_bit_exact():
    rng = np.random.default_rng(0)
    B, D, H, W, C = 2, 4, 8, 16, 32
    x_np, x = _f32(rng, (B, D, H, W, C))
    plan0 = J.make_ps2d_plan(H // 2, W // 2, C, C)
    plan1 = J.make_ps2d_plan(H // 4, W // 4, C, C)
    ref3 = J.flat_to_normal(J.pack_flat_fast(
        space_to_depth_hw(jnp.asarray(x_np)), plan0, interpret=True), plan0)
    y3 = T.pack_halo(x)
    _zero_halo(y3)
    np.testing.assert_array_equal(_np(T.halo_to_normal(y3)), _np(ref3))
    ref4 = J.flat_to_normal(J.pool_into_flat(_flat(x_np, plan0), plan0,
                                             plan1, interpret=True), plan1)
    y4 = T.pool_into_halo(y3)
    _zero_halo(y4)
    np.testing.assert_array_equal(_np(T.halo_to_normal(y4)), _np(ref4))


# (cis, co, affine + ReLU, mul0, stats): the region's f32 call forms
K1_CASES = [
    ((32,), 32, True, False, True),
    ((32, 32), 32, False, True, True),
    ((32,), 64, False, False, False),
    ((64, 64), 64, False, True, True),
]


def _k1_pair(cis, co, affine, mul0, stats, seed=0, w_scale=0.1):
    """(JAX's f32 K1 result, the port's plain f32 K1 result, the inputs)
    on the same seeded f32 inputs."""
    rng = np.random.default_rng(seed + sum(cis) + co)
    B, D, H, W = 2, 3, 8, 12
    xs = [_f32(rng, (B, D, H, W, c)) for c in cis]
    w_np, w = _f32(rng, (3, 3, 3, sum(cis), co), w_scale)
    if len(cis) == 1:
        plan = J.make_ps2d_plan(H // 2, W // 2, cis[0], co)
    else:
        plan = (J.make_ps2d_plan_multi(H // 2, W // 2, cis, co)
                or J.make_ps2d_plan_multi(H // 2, W // 2, cis, co,
                                          vmem_budget=28 * 2 ** 20))
    xfs = [_flat(x_np, J.input_plan(plan, i))
           for i, (x_np, _) in enumerate(xs)]
    kw_j, kw_t = {}, {}
    if affine:
        for name, base in (("scale", 1.0), ("shift", 0.0)):
            v_np, v = _f32(rng, (B, sum(cis)), 0.3)
            v_np, v = v_np + base, v + base
            parts, off = [], 0
            for c in cis:       # JAX lanes: phase-major per input
                parts.append(np.tile(v_np[:, off:off + c], (1, 4)))
                off += c
            kw_j[f"in_{name}"] = jnp.asarray(np.concatenate(parts, 1))
            kw_t[f"in_{name}"] = v
    if mul0:
        m_np, m = _f32(rng, (B, D, H, W, cis[0]), 0.5)
        kw_j["in_mul0"] = _flat(m_np, J.input_plan(plan, 0))
        kw_t["in_mul0"] = T.pack_halo(m)
    res_j = J.ps2d_conv3d_flat_multi(
        xfs, jnp.asarray(w_np), plan, cis=cis, interpret=True,
        in_relu=affine, emit_stats=stats, **kw_j)
    res_t = T.conv3d_halo([T.pack_halo(x) for _, x in xs], w,
                          in_relu=affine, emit_stats=stats, **kw_t)
    return res_j, res_t, plan, xs, w


@pytest.mark.parametrize("cis,co,affine,mul0,stats", K1_CASES)
def test_conv3d_halo_f32_matches_jax(cis, co, affine, mul0, stats):
    res_j, res_t, plan, _, _ = _k1_pair(cis, co, affine, mul0, stats)
    y_j, y_t = (res_j[0], res_t[0]) if stats else (res_j, res_t)
    _zero_halo(y_t)
    got = _np(T.halo_to_normal(y_t))
    _close(got, J.flat_to_normal(y_j, plan))
    if stats:
        B = got.shape[0]
        for s_j, s_t in zip(res_j[1], res_t[1]):
            s_j = np.asarray(s_j).reshape(B, 4, -1).sum(1)[:, :co]
            assert s_t.dtype == F32
            np.testing.assert_allclose(_np(s_t), s_j, rtol=0,
                                       atol=1e-5 * np.abs(s_j).max())


def _k2_pair(B, D2, H2, W2, ci, co, with_bias, seed=1):
    rng = np.random.default_rng(seed)
    x_np, x = _f32(rng, (B, D2, H2, W2, ci))
    w_np, w = _f32(rng, (2, 2, 2, ci, co), 0.1)
    b_np = (rng.normal(size=(co,)) * 0.1).astype(np.float32) if with_bias \
        else None
    plan = J.make_ps2d_plan(H2, W2, co, co)
    ref = _np(J.flat_to_normal(J.up_k2s2_into_flat(
        jnp.asarray(x_np), jnp.asarray(w_np),
        None if b_np is None else jnp.asarray(b_np), plan, interpret=True),
        plan))
    y = T.up_k2s2_into_halo(x, w, None if b_np is None
                            else torch.from_numpy(b_np))
    return ref, y, x, w, b_np


@pytest.mark.parametrize("B,D2,H2,W2,ci,co,with_bias", [
    (1, 3, 4, 8, 64, 32, True), (2, 2, 4, 6, 32, 32, False),
    (1, 2, 2, 4, 128, 64, True)])
def test_up_k2s2_into_halo_f32_matches_jax(B, D2, H2, W2, ci, co,
                                           with_bias):
    ref, y, _, _, _ = _k2_pair(B, D2, H2, W2, ci, co, with_bias)
    assert tuple(y.shape) == (B, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2, co)
    _zero_halo(y)
    _close(T.halo_to_normal(y), ref)


def test_k1_f32_rounds_weights_to_bf16_and_k2_does_not():
    """With weights that bf16 does not hold, each kernel's plain version
    meets JAX's within 1e-5 * max|ref| only with its own rounding: K1's
    output with unrounded weights, and K2's with bf16-rounded weights,
    miss JAX's by more than that (so this test tells the two apart)."""
    res_j, y_t, plan, xs, w = _k1_pair((32,), 32, False, False, False,
                                       w_scale=1.0)
    ref = _np(J.flat_to_normal(res_j, plan))
    _close(T.halo_to_normal(y_t), ref)
    x = xs[0][1]
    unrounded = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                         padding=1).permute(0, 2, 3, 4, 1)
    assert np.abs(_np(unrounded) - ref).max() > 10 * 1e-5 * np.abs(ref).max()

    ref2, y2, x2, w2, b2 = _k2_pair(1, 3, 4, 8, 64, 32, True)
    _close(T.halo_to_normal(y2), ref2)
    rounded = T.up_k2s2_into_halo(x2, w2.to(torch.bfloat16).float(),
                                  torch.from_numpy(b2))
    d = np.abs(_np(T.halo_to_normal(rounded)) - ref2).max()
    assert d > 10 * 1e-5 * np.abs(ref2).max(), d


def _variables(seed=3):
    return to_flax_variables(UNet3D(features=FEATS, seed=seed, device="cpu")
                             .state_dict())


@pytest.mark.parametrize("levels", [1, 2])
def test_unet_f32_region_matches_jax(monkeypatch, levels):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32)
    variables = _variables()
    j_pools = _counting(monkeypatch, J, "pool_into_flat")
    j_convs = _counting(monkeypatch, J, "ps2d_conv3d_flat_multi")
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.float32,
                 ps2d_eval=True, ps2d_levels=levels)
    ref = np.asarray(jax.jit(
        lambda v, a: jm.apply(v, a, train=False)["logits"])(
            variables, jnp.asarray(x)))
    assert j_convs and bool(j_pools) == (levels == 2), "JAX's region"

    t_pools = _counting(monkeypatch, unet3d_module, "pool_into_halo")
    t_convs = _counting(monkeypatch, unet3d_module, "conv3d_halo")
    model = UNet3D(features=FEATS, ps2d_eval=True, ps2d_levels=levels,
                   device="cpu", compute_dtype="float32")
    model.load_state_dict(load_flax_params(variables))
    assert model.halo_levels(x.shape[1:4]) == levels
    out = model.eval()(torch.from_numpy(x)).numpy()
    assert len(t_pools) == levels - 1 and len(t_convs) == 3 + 4 * (levels - 1)
    _margin_contract(out, ref)


def test_f32_ps2d_train_step_matches_jax(monkeypatch):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 4, 16, 24, 4)).astype(np.float32)
    y = ((rng.random((1, 4, 16, 24)) < 0.2) * 2).astype(np.int32)
    model = UNet3D(features=FEATS, seed=3, device="cpu", dropout_rate=0.0,
                   remat=True, ps2d_train=True, compute_dtype="float32")
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.float32,
                 dropout_rate=0.0, ps2d_train=True)
    jloss = j_make_loss_fn(JConfig())
    j_trains = _counting(monkeypatch, J, "ps2d_conv3d_flat_train")

    def loss(params):
        out, _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jloss(out, jnp.asarray(y))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(
        variables["params"])
    assert j_trains, "JAX did not take its train region"
    t_trains = _counting(monkeypatch, unet3d_module, "conv3d_halo_train")
    out, lt, grads = port_step(model, x, y)
    assert len(t_trains) == 3 and out["logits"].dtype == F32
    assert abs(lt - float(ref_loss)) <= 1e-5 * max(abs(float(ref_loss)), 1.0)
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


def _rounded_normal(model):
    """The f32 normal path with ``model``'s weights, K1's rounded to bf16,
    and with them unrounded."""
    levels = 2 if model.ps2d_eval and model.ps2d_levels >= 2 else 1
    sd = model.state_dict()
    normal = [UNet3D(features=FEATS, device="cpu", compute_dtype="float32",
                     dropout_rate=0.0) for _ in range(2)]
    normal[1].load_state_dict(sd)
    for k in model.k1_kernel_names(levels):
        sd[k] = sd[k].to(torch.bfloat16).float()
    normal[0].load_state_dict(sd)
    return normal


@pytest.mark.parametrize("levels", [1, 2])
def test_unet_f32_region_is_the_normal_path_with_k1_rounding(levels):
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 16, 16, 16, 4)).astype(np.float32))
    model = UNet3D(features=FEATS, ps2d_eval=True, ps2d_levels=levels,
                   seed=4, device="cpu", compute_dtype="float32")
    assert model.halo_levels(x.shape[1:4]) == levels
    rounded, unrounded = _rounded_normal(model)
    out, ref = model.eval()(x), rounded.eval()(x)
    scale = max(ref.abs().max().item(), 1.0)
    assert (out - ref).abs().max().item() <= 1e-5 * scale
    assert (out - unrounded.eval()(x)).abs().max().item() > 1e-4 * scale


def test_f32_ps2d_train_is_the_normal_path_with_k1_rounding():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 8, 16, 16, 4)).astype(np.float32)
    y = ((rng.random((1, 8, 16, 16)) < 0.2) * 2).astype(np.int32)
    model = UNet3D(features=FEATS, ps2d_train=True, seed=4, device="cpu",
                   compute_dtype="float32", dropout_rate=0.0)
    rounded, _ = _rounded_normal(model)
    _, lk, gk = port_step(model, x, y)
    _, ln, gn = port_step(rounded, x, y)
    assert abs(lk - ln) <= 1e-5 * max(abs(ln), 1.0)
    got, ref = dict(flat_leaves(gk)), dict(flat_leaves(gn))
    for k, b in ref.items():
        a, b = got[k].ravel(), b.ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if k == "/head_conv/bias" or nb < 1e-6:
            continue
        assert a @ b / (na * nb) >= 0.9999, k
        assert abs(na / nb - 1) <= 1e-3, k
