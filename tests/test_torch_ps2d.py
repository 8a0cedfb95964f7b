"""The port's level-0 region ops (ops/ps2d.py) against the JAX package's
ops/pallas/ps2d.py, on the same seeded inputs.

On the CPU the port's kernel wrappers run their plain PyTorch versions,
and the JAX Pallas kernels run in interpret mode, as tests/test_ps2d.py
runs them. Outputs are compared in the normal layout (JAX
``flat_to_normal`` / the port's ``halo_to_normal``). Tolerances:

  * K3 (``pack_halo``): bit-exact, pure data movement;
  * K2 (``up_k2s2_into_halo``): within 1 bf16 ulp of max|ref| — both
    sides round one f32 sum per output, in another order;
  * K1 (``conv3d_halo``): within 2^-7 * max|ref| (f32 sums of 27*ci
    products in another order, one bf16 rounding), emitted sums within
    1e-3 of the largest sum;
  * glue ops: within 2 bf16 ulp of max|ref| (bf16 elementwise steps
    that XLA may keep in f32 where torch rounds each one).

The CUDA kernels themselves are held against these plain versions on
the card by tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.s2d import (
    space_to_depth_hw)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

BF16 = torch.bfloat16


def _bf16(rng, shape, scale=1.0):
    """Same bf16 values for both packages: (numpy f32, torch bf16)."""
    t = torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(BF16)
    return t.float().numpy(), t


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _flat(x_np, plan):
    return J.pack_flat(space_to_depth_hw(_j(x_np)), plan)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _ulp(m):
    """One bf16 ulp at magnitude m."""
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


def test_pack_halo_plain_matches_pack_flat_fast():
    rng = np.random.default_rng(0)
    for shape in [(1, 4, 8, 16, 32), (2, 3, 8, 12, 32)]:
        x_np, x = _bf16(rng, shape)
        plan = J.make_ps2d_plan(shape[2] // 2, shape[3] // 2, shape[4], 32)
        ref = J.flat_to_normal(
            J.pack_flat_fast(space_to_depth_hw(_j(x_np)), plan,
                             interpret=True), plan)
        y = T.pack_halo(x)
        np.testing.assert_array_equal(_np(T.halo_to_normal(y)), _np(ref))
        assert (_np(y) * (1 - _np(T.halo_mask(y)))).max() == 0


@pytest.mark.parametrize("B,D2,H2,W2,ci,co,with_bias", [
    (1, 3, 4, 8, 64, 32, True), (2, 2, 4, 6, 32, 32, False)])
def test_up_k2s2_into_halo_plain_matches_up_k2s2_into_flat(
        B, D2, H2, W2, ci, co, with_bias):
    rng = np.random.default_rng(1)
    x_np, x = _bf16(rng, (B, D2, H2, W2, ci))
    w_np, w = _bf16(rng, (2, 2, 2, ci, co), 0.1)
    b_np = (rng.normal(size=(co,)) * 0.1).astype(np.float32) if with_bias \
        else None
    plan = J.make_ps2d_plan(H2, W2, co, co)
    ref = _np(J.flat_to_normal(J.up_k2s2_into_flat(
        _j(x_np), _j(w_np), None if b_np is None else jnp.asarray(b_np),
        plan, interpret=True), plan))
    y = T.up_k2s2_into_halo(x, w, None if b_np is None
                            else torch.from_numpy(b_np))
    assert tuple(y.shape) == (B, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2, co)
    d = np.abs(_np(T.halo_to_normal(y)) - ref)
    assert d.max() <= _ulp(np.abs(ref).max()), d.max()
    assert (_np(y) * (1 - _np(T.halo_mask(y)))).max() == 0


# (cis, co, affine, relu, mul0, stats): the region's three call forms
# (enc0/dec0 conv2: affine+relu+stats; dec0 conv1: two inputs, mask,
# stats) and the remaining combinations
K1_CASES = [
    ((32,), 32, None, False, False, False),
    ((32,), 32, "both", True, False, True),
    ((32, 32), 32, None, False, True, True),
    ((32, 32), 16, "both", False, True, True),
    ((64,), 64, "scale", True, False, False),
    ((32, 32), 32, "shift", True, False, True),
]


@pytest.mark.parametrize("cis,co,affine,relu,mul0,stats", K1_CASES)
def test_conv3d_halo_plain_matches_ps2d_conv3d_flat_multi(
        cis, co, affine, relu, mul0, stats):
    rng = np.random.default_rng(sum(cis) + co)
    B, D, H, W = 2, 3, 8, 12
    xs = [_bf16(rng, (B, D, H, W, c)) for c in cis]
    w_np, w = _bf16(rng, (3, 3, 3, sum(cis), co), 0.1)
    if len(cis) == 1:
        plan = J.make_ps2d_plan(H // 2, W // 2, cis[0], co)
    else:
        plan = J.make_ps2d_plan_multi(H // 2, W // 2, cis, co)
    xfs = [_flat(x_np, J.input_plan(plan, i))
           for i, (x_np, _) in enumerate(xs)]
    kw_j, kw_t = {}, {}
    for name in ("scale", "shift"):
        if affine in (name, "both"):
            base = 1.0 if name == "scale" else 0.0
            v_np, v = _bf16(rng, (B, sum(cis)), 0.3)
            v_np, v = v_np + base, (v.float() + base).to(BF16)
            # JAX lanes are phase-major per input: tile each block 4x
            parts, off = [], 0
            for c in cis:
                parts.append(np.tile(v_np[:, off:off + c], (1, 4)))
                off += c
            kw_j[f"in_{name}"] = _j(np.concatenate(parts, axis=1))
            kw_t[f"in_{name}"] = v
    if mul0:
        m_np, m = _bf16(rng, (B, D, H, W, cis[0]), 0.5)
        kw_j["in_mul0"] = _flat(m_np, J.input_plan(plan, 0))
        kw_t["in_mul0"] = T.pack_halo(m)
    res_j = J.ps2d_conv3d_flat_multi(
        xfs, _j(w_np), plan, cis=cis, interpret=True, in_relu=relu,
        emit_stats=stats, **kw_j)
    res_t = T.conv3d_halo([T.pack_halo(x) for _, x in xs], w,
                          in_relu=relu, emit_stats=stats, **kw_t)
    y_j, y_t = (res_j[0], res_t[0]) if stats else (res_j, res_t)
    ref = _np(J.flat_to_normal(y_j, plan))
    got = _np(T.halo_to_normal(y_t))
    d = np.abs(got - ref)
    assert d.max() <= 2 ** -7 * np.abs(ref).max(), (d.max(),
                                                     np.abs(ref).max())
    assert (_np(y_t) * (1 - _np(T.halo_mask(y_t)))).max() == 0
    if stats:
        for s_j, s_t, own in zip(res_j[1], res_t[1],
                                 (got.sum((1, 2, 3)),
                                  np.square(got).sum((1, 2, 3)))):
            s_j = np.asarray(s_j).reshape(B, 4, -1).sum(1)[:, :co]
            s_t = _np(s_t)
            np.testing.assert_allclose(s_t, own, rtol=1e-5, atol=1e-3)
            np.testing.assert_allclose(s_t, s_j, rtol=0,
                                       atol=1e-3 * np.abs(s_j).max())


def test_glue_ops_match_flat_glue():
    rng = np.random.default_rng(3)
    B, D, H, W, c = 2, 4, 8, 12, 32
    x_np, x = _bf16(rng, (B, D, H, W, c))
    u_np, u = _bf16(rng, (B, D, H, W, c))
    plan = J.make_ps2d_plan(H // 2, W // 2, c, c)
    xf, uf = _flat(x_np, plan), _flat(u_np, plan)
    xh, uh = T.pack_halo(x), T.pack_halo(u)

    def close(got_h, ref_f, ref_plan):
        got = _np(T.halo_to_normal(got_h))
        ref = _np(J.flat_to_normal(ref_f, ref_plan))
        d = np.abs(got - ref)
        assert d.max() <= 2 * _ulp(np.abs(ref).max()), d.max()
        assert (_np(got_h) * (1 - _np(T.halo_mask(got_h)))).max() == 0

    gamma = (rng.normal(size=(c,)) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    close(T.group_norm_halo(xh, torch.from_numpy(gamma),
                            torch.from_numpy(beta), 8),
          J.group_norm_flat(xf, jnp.asarray(gamma), jnp.asarray(beta), 8,
                            plan), plan)
    # two inputs, gate factors folded into input 0
    w_np, w = _bf16(rng, (1, 1, 1, 2 * c, 16), 0.2)
    b_np, b = _bf16(rng, (16,), 0.1)
    se_np, se = _bf16(rng, (B, c), 0.5)
    psi_np, psi = _bf16(rng, (B, D, H, W, 1), 0.5)
    ref = J.conv1x1_flat(
        (xf, uf), _j(w_np), _j(b_np), plan, cis=(c, c), se0=_j(se_np),
        psi0=J.pack_flat(space_to_depth_hw(_j(psi_np)),
                         plan._replace(C4=4)))
    close(T.conv1x1_halo((xh, uh), w, b, se0=se, psi0=T.pack_halo(psi)),
          ref, plan._replace(N4=64, co=16))
    np.testing.assert_allclose(
        _np(T.global_avg_pool_halo(xh)).reshape(B, c),
        _np(J.global_avg_pool_flat(xf, plan)).reshape(B, c), rtol=0,
        atol=_ulp(np.abs(x_np).mean(axis=(1, 2, 3)).max()))
    np.testing.assert_array_equal(
        _np(T.max_pool3d_from_halo(xh)),
        _np(J.max_pool3d_from_flat(xf, plan)))
