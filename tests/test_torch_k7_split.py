"""K7's f32 form computes on the tensor cores as six bf16 passes over an
exact split of its activations and of its weights
(``csrc/conv3d_same_f32.cu``). Here, on the CPU, the split's plain mirror
(``ops/conv.py::split3_bf16``) and the six-pass conv built on it
(``ops/conv.py::conv3d_split6``), at small widths (ci, co 32 or 64,
D, H, W <= 8), inputs made with numpy from a seed:

  * the split reconstructs K7's f32 weights bit for bit;
  * the six passes summed in float64 lie within 2^-22 * (|x| conv |w|) of
    the float64 conv, elementwise; without any one of the six the sum
    leaves that bound somewhere, so the bound pins the passes kept;
  * the share of a small pass in the error of an f32 sum against
    float64, beta = <err, d> / <d, d> for the pass's own conv d (the
    gate ``chip_smoke.py`` holds the kernel to), is ~0 for the six-pass
    sum and ~-1 for a sum without that pass;
  * summed in f32 pass by pass, they hold to JAX's f32 ``wtile_conv3d``
    (its Pallas kernel in interpret mode, with the plan
    ``tests/test_torch_wtile.py`` makes) within that file's f32
    tolerance, 1e-4 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas.conv3d import (
    wtile_conv3d as jax_wtile_conv3d)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv import (
    SPLIT6_PASSES, _conv3d, conv3d_split6, split3_bf16)

from test_torch_wtile import _close, _inputs, _jax_plan

SHAPES = [(32, 32, 4, 8, 8), (64, 32, 3, 8, 8), (32, 64, 3, 6, 8),
          (64, 64, 3, 8, 8)]


def _torch_inputs(ci, co, D, H, W):
    x, w = _inputs(ci, co, D, H, W, seed=ci + co + D)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.mark.parametrize("ci,co", [(32, 32), (32, 64), (64, 32), (64, 64)])
def test_split3_reconstructs_k7_weights_exactly(ci, co):
    _, w = _torch_inputs(ci, co, 1, 1, 1)
    hi, mid, lo = split3_bf16(w)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    got = hi.float() + mid.float() + lo.float()
    assert torch.equal(got.view(torch.int32), w.view(torch.int32))
    assert (mid != 0).any() and (lo != 0).any()     # f32 weights, not bf16


@pytest.mark.parametrize("ci,co,D,H,W", SHAPES)
def test_six_passes_within_2_to_minus_22_of_float64(ci, co, D, H, W):
    x, w = _torch_inputs(ci, co, D, H, W)
    ref = _conv3d(x, w, 1, torch.float64)
    bound = 2.0 ** -22 * _conv3d(x.abs(), w.abs(), 1, torch.float64)
    got = conv3d_split6(x, w, torch.float64)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert ((got - ref).abs() <= bound).all(), \
        ((got - ref).abs() / bound).max().item()
    # every kept pass is needed: without it the sum leaves the bound
    xs, ws = split3_bf16(x), split3_bf16(w)
    parts = {p: _conv3d(xs[p[0]], ws[p[1]], 1, torch.float64)
             for p in SPLIT6_PASSES}
    for drop in SPLIT6_PASSES:
        five = sum(v for p, v in parts.items() if p != drop)
        assert ((five - ref).abs() > bound).any(), drop


@pytest.mark.parametrize("drop", [None, (0, 2), (1, 1), (2, 0)])
@pytest.mark.parametrize("ci,co,D,H,W", SHAPES[::3])
def test_pass_share_in_the_f32_error_sees_a_dropped_pass(ci, co, D, H, W,
                                                          drop):
    x, w = _torch_inputs(ci, co, D, H, W)
    ref = _conv3d(x, w, 1, torch.float64)
    passes = tuple(p for p in SPLIT6_PASSES if p != drop)
    err = conv3d_split6(x, w, torch.float32, passes).double() - ref
    for p in ((0, 2), (1, 1), (2, 0)):
        d = conv3d_split6(x, w, torch.float32, (p,)).double()
        beta = ((err * d).sum() / (d * d).sum()).item()
        want = -1.0 if p == drop else 0.0
        assert abs(beta - want) <= 0.5, (p, beta)


@pytest.mark.parametrize("ci,co,D,H,W", SHAPES[1:3])
def test_six_passes_in_f32_match_jax_f32_wtile(ci, co, D, H, W):
    x, w = _torch_inputs(ci, co, D, H, W)
    want = jax_wtile_conv3d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            _jax_plan(ci, co, D, H, W), True)
    got = conv3d_split6(x, w, torch.float32)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), 1e-4)
