"""K7 (``ops/conv3d.py::wtile_conv3d``) against the JAX package's
``wtile_conv3d`` and its custom VJP, on the CPU.

Here the port runs the kernel's plain version (CPU tensors) and the JAX
Pallas kernel runs in interpret mode with the plan JAX's own test makes
(``make_plan(ci, co, W, H, max_col_bytes=256 KiB)``), at
tests/test_pallas.py's six shapes. The same inputs, made with numpy from a
seed, go to both.

Tolerances, each against max|ref|:
  * forward, f32: 1e-4 (f32 sums of up to 27 * 128 products in another
    order; JAX's own test holds its kernel to 5e-3);
  * forward, bf16: 1 bf16 ulp (bf16 products, f32 sums, one rounding on
    both sides: an element near a rounding boundary differs by one ulp);
  * dx and dw of sum(y^2), f32: 1e-4 (JAX's own test allows 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas.conv3d import (
    make_plan, wtile_conv3d as jax_wtile_conv3d)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv3d import (
    conv3d_same, wtile_conv3d, wtile_conv3d_plain)

SHAPES = [                   # tests/test_pallas.py:66-73
    (32, 32, 4, 8, 16),
    (64, 32, 3, 8, 8),
    (32, 64, 3, 8, 8),
    (64, 64, 3, 8, 8),
    (128, 128, 2, 8, 4),
    (32, 32, 2, 7, 12),      # H not a multiple of 8
]


def _ulp(m):
    """One bf16 ulp at magnitude m."""
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


def _inputs(ci, co, D, H, W, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, D, H, W, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    return x, w


def _jax_plan(ci, co, D, H, W):
    plan = make_plan(ci, co, W, H, max_col_bytes=256 * 1024)
    assert plan is not None
    return plan


def _close(got, want, rel=None):
    """max |got - want| within ``rel`` * max|want|, or within 1 bf16 ulp
    of max|want| when ``rel`` is None."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d, m = np.abs(got - want).max(), np.abs(want).max()
    tol = _ulp(m) if rel is None else rel * m
    assert d <= tol, (d, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci,co,D,H,W", SHAPES)
def test_wtile_conv3d_matches_jax(ci, co, D, H, W, dtype):
    x, w = _inputs(ci, co, D, H, W)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_wtile_conv3d(jnp.asarray(x).astype(jd), jnp.asarray(w),
                            _jax_plan(ci, co, D, H, W), True)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = wtile_conv3d(torch.from_numpy(x).to(td), torch.from_numpy(w))
    assert got.dtype == td
    _close(got.float().numpy(), want,
           None if dtype == "bfloat16" else 1e-4)


def test_wtile_conv3d_grads_match_jax():
    """dx and dw of sum(y^2) against jax.grad through JAX's custom VJP
    (its data gradient on the kernel, its weight gradient in XLA), at the
    shape with H off JAX's 8-row tiling."""
    ci, co, D, H, W = SHAPES[5]
    x, w = _inputs(ci, co, D, H, W, seed=1)
    plan = _jax_plan(ci, co, D, H, W)
    gx, gw = jax.grad(
        lambda a, b: jnp.sum(jax_wtile_conv3d(a, b, plan, True) ** 2),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (wtile_conv3d(tx, tw) ** 2).sum().backward()
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == torch.float32
    _close(tx.grad.numpy(), gx, 1e-4)
    _close(tw.grad.numpy(), gw, 1e-4)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_wtile_conv3d_grads_match_autograd_through_plain_bf16(w_dtype):
    """bf16 activations, f32 or bf16 weights: the op's gradients against
    autograd through the plain version, within 2^-5 (JAX's rule for its
    kernels' VJPs; the data gradient is rounded to bf16 once more here).
    The weight gradient comes in the weights' dtype."""
    x, w = _inputs(32, 64, 3, 5, 9, seed=2)

    def grads(fn):
        tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
        tw = torch.from_numpy(w).to(w_dtype).requires_grad_()
        (fn(tx, tw).float() ** 2).sum().backward()
        return tx.grad, tw.grad

    (dx, dw), (rx, rw) = grads(wtile_conv3d), grads(wtile_conv3d_plain)
    assert dx.dtype == torch.bfloat16 and dw.dtype == w_dtype
    _close(dx.float().numpy(), rx.float().numpy(), 2 ** -5)
    _close(dw.float().numpy(), rw.float().numpy(), 2 ** -5)


@pytest.mark.parametrize("fn", [wtile_conv3d, conv3d_same,
                                wtile_conv3d_plain])
@pytest.mark.parametrize("ci,co", [(16, 32), (32, 48)])
def test_wtile_conv3d_refuses_widths_off_32(fn, ci, co):
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 2, 3, 4, ci)), torch.zeros((3, 3, 3, ci, co)))
