"""K2's f32 form computes on the tensor cores as six bf16 passes over an
exact split of its activations and of its phase weights
(``csrc/up_k2s2_into_halo_f32.cu``). Here, on the CPU, the split's plain
mirror (``ops/conv.py::split3_bf16``) and the six-pass transposed conv
built on it (``ops/ps2d.py::up_k2s2_into_halo_split6``), at small sizes
(B <= 2, D2, H2, W2 <= 8; (ci, co) (8, 8), (32, 16), (64, 32) and
(128, 64)), inputs made with numpy from a seed:

  * the split rebuilds x and K2's f32 phase weights bit for bit;
  * the six passes summed in float64 lie within 2^-22 * (|x| @ |w|) of
    the float64 product, elementwise; without any one of the six the sum
    leaves that bound somewhere, so the bound pins the passes kept;
  * the share of a small pass in the error of an f32 sum against
    float64, beta = <err, d> / <d, d> for the pass's own product d (the
    gate ``chip_smoke.py`` holds the kernel to), is ~0 for the six-pass
    sum and ~-1 for a sum without that pass;
  * summed in f32 pass by pass, plus the f32 bias, they hold to JAX's f32
    ``up_k2s2_into_flat`` (its Pallas kernel in interpret mode, as
    ``tests/test_torch_f32_region.py`` runs it) within that file's f32
    tolerance, 1e-5 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv import (
    SPLIT6_PASSES, split3_bf16)

F32, F64 = torch.float32, torch.float64
SMALL = ((0, 2), (1, 1), (2, 0))     # x_hi w_lo, x_mid w_mid, x_lo w_hi

# ((B, D2, H2, W2), ci, co)
CASES = [((2, 3, 4, 5), 8, 8), ((1, 2, 3, 8), 32, 16),
         ((2, 3, 4, 8), 64, 32), ((1, 2, 4, 4), 128, 64)]


def _inputs(shape, ci, co, seed):
    """f32 x (B, D2, H2, W2, ci), flax kernel w (2, 2, 2, ci, co) * 0.1
    and bias (co,) * 0.1, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, ci)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, ci, co)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    return x, w, b


def _torch_inputs(shape, ci, co):
    return [torch.from_numpy(a) for a in _inputs(shape, ci, co, ci + co)]


def _f64(x, w):
    """K2's function in float64 (no bias), into the halo layout."""
    return T._phases_into_halo(
        torch.matmul(x.double(), T._phase_matrix(w.double(), F64)), x.shape)


@pytest.mark.parametrize("shape,ci,co", CASES)
def test_split3_rebuilds_x_and_the_phase_weights_exactly(shape, ci, co):
    x, w, _ = _torch_inputs(shape, ci, co)
    for v in (x, T._phase_matrix(w, F32)):
        hi, mid, lo = split3_bf16(v)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        got = hi.float() + mid.float() + lo.float()
        assert torch.equal(got.view(torch.int32), v.view(torch.int32))
        assert (mid != 0).any() and (lo != 0).any()    # f32 values, not bf16


@pytest.mark.parametrize("shape,ci,co", CASES)
def test_six_passes_within_2_to_minus_22_of_float64(shape, ci, co):
    x, w, _ = _torch_inputs(shape, ci, co)
    ref = _f64(x, w)
    bound = 2.0 ** -22 * _f64(x.abs(), w.abs())
    got = T.up_k2s2_into_halo_split6(x, w)
    assert got.dtype == F64 and got.shape == ref.shape
    assert ((got - ref).abs() <= bound).all(), \
        ((got - ref).abs() / bound.clamp_min(1e-300)).max().item()
    # every kept pass is needed: without it the sum leaves the bound
    parts = {p: T.up_k2s2_into_halo_split6(x, w, passes=(p,))
             for p in SPLIT6_PASSES}
    for drop in SPLIT6_PASSES:
        five = sum(v for p, v in parts.items() if p != drop)
        assert ((five - ref).abs() > bound).any(), drop


@pytest.mark.parametrize("drop", [None, *SMALL])
@pytest.mark.parametrize("shape,ci,co", CASES[2:])
def test_pass_share_in_the_f32_error_sees_a_dropped_pass(shape, ci, co,
                                                          drop):
    x, w, _ = _torch_inputs(shape, ci, co)
    ref = _f64(x, w)
    passes = tuple(p for p in SPLIT6_PASSES if p != drop)
    err = T.up_k2s2_into_halo_split6(x, w, dtype=F32,
                                     passes=passes).double() - ref
    for p in SMALL:
        d = T.up_k2s2_into_halo_split6(x, w, dtype=F32, passes=(p,)).double()
        beta = ((err * d).sum() / (d * d).sum()).item()
        want = -1.0 if p == drop else 0.0
        assert abs(beta - want) <= 0.5, (p, beta)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape,ci,co", CASES[2:])
def test_six_passes_in_f32_match_jax_f32_up_k2s2(shape, ci, co, with_bias):
    x_np, w_np, b_np = _inputs(shape, ci, co, ci + co)
    B, D2, H2, W2 = shape
    plan = J.make_ps2d_plan(H2, W2, co, co)
    ref = np.asarray(J.flat_to_normal(J.up_k2s2_into_flat(
        jnp.asarray(x_np), jnp.asarray(w_np),
        jnp.asarray(b_np) if with_bias else None, plan, interpret=True),
        plan), np.float32)
    got = T.up_k2s2_into_halo_split6(
        torch.from_numpy(x_np), torch.from_numpy(w_np),
        torch.from_numpy(b_np) if with_bias else None, dtype=F32)
    assert got.dtype == F32
    assert (got * (1 - T.halo_mask(got))).abs().max() == 0
    got = T.halo_to_normal(got).numpy()
    assert got.shape == ref.shape
    d = np.abs(got - ref).max()
    assert d <= 1e-5 * np.abs(ref).max(), (d, np.abs(ref).max())
