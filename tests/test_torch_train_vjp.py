"""K6 (``ops/ps2d.py::conv3d_halo_train``, the differentiable conv on
K1) against the JAX package's ``ps2d_conv3d_flat_train``, on the CPU.

Here the port's K1 runs its plain version inside K6's forward and data
gradient, and the JAX Pallas kernel runs in interpret mode. The loss
reads the conv's output in the normal layout against a seeded weight
tensor ``r``, and dx, dw are compared in the normal layout with JAX's
``_grad_close`` rule (``tests/test_ps2d.py:446-451``): max |d| <= 2^-5 *
max |ref| (bf16 operands on both sides; sums in another order).

Pad garbage: the output's halo is zero by construction, so a cotangent
that is not zero there (a consumer that reads the raw halo layout) must
change nothing: dx and dw move by at most 2^-10 of their size. Without
the identity on-load affine of the data gradient, the plain K1 would
read that garbage (the card's K1 never loads the halo), and this test
fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.s2d import (
    depth_to_space_hw, space_to_depth_hw)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

BF16 = torch.bfloat16


def _grad_close(a, b, name, rel=2 ** -5):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(np.abs(b).max(), 1e-3)
    assert np.abs(a - b).max() <= rel * scale, (
        name, np.abs(a - b).max(), scale)


def _jax_grads(xs, w, r):
    """dx per input and dw of sum(conv(xs, w) * r) through JAX's K6."""
    cis = tuple(x.shape[-1] for x in xs)
    H, W, co = xs[0].shape[2], xs[0].shape[3], w.shape[-1]
    if len(xs) == 1:
        plan = J.make_ps2d_plan(H // 2, W // 2, cis[0], co)
        plans = (plan,)
    else:
        plan = J.make_ps2d_plan_multi(H // 2, W // 2, cis, co)
        plans = tuple(J.input_plan(plan, i) for i in range(len(xs)))

    def loss(xs, w):
        xfs = tuple(J.pack_flat(space_to_depth_hw(x.astype(jnp.bfloat16)), p)
                    for x, p in zip(xs, plans))
        yf = J.ps2d_conv3d_flat_train(xfs, w.astype(jnp.bfloat16), plan,
                                      cis)
        y = depth_to_space_hw(J.unpack_flat(yf, plan))
        return jnp.sum(y.astype(jnp.float32) * r)

    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        tuple(jnp.asarray(x) for x in xs), jnp.asarray(w))
    return [np.asarray(g) for g in gx], np.asarray(gw)


def _port_grads(xs, w, r_halo, fn=T.conv3d_halo_train):
    """dx per input (normal layout) and dw of sum(y_halo * r_halo)."""
    xs_t = [torch.tensor(x, requires_grad=True) for x in xs]
    w_t = torch.tensor(w, requires_grad=True)
    y = fn([T.pack_halo_plain(x.to(BF16)) for x in xs_t], w_t)
    assert y.dtype == BF16 and y.shape[-1] == w.shape[-1]
    (y.float() * torch.from_numpy(r_halo)).sum().backward()
    return [x.grad.numpy() for x in xs_t], w_t.grad.numpy()


def _halo(r, garbage=0.0, rng=None):
    """The normal-layout cotangent weights in the halo layout, with
    ``garbage`` times a seeded normal on the halo."""
    rh = np.pad(r, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    if garbage:
        g = rng.normal(size=rh.shape).astype(np.float32) * garbage
        g[:, 1:-1, 1:-1, 1:-1] = 0
        rh = rh + g
    return rh


CASES = {
    # tests/test_ps2d.py:454-481: one input, 32 -> 32
    "single": (1, 3, 8, 12, (32,), 32),
    # tests/test_ps2d.py:484-535: two inputs 32 + 32 -> 32 (dec0.conv1)
    "two inputs": (1, 2, 8, 12, (32, 32), 32),
    # batch 2, the train step's; a 64 -> 32 input split
    "batch 2": (2, 2, 8, 8, (64,), 32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k6_matches_jax_train_vjp(case):
    B, D, H, W, cis, co = CASES[case]
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(B, D, H, W, c)).astype(np.float32) for c in cis]
    w = (rng.normal(size=(3, 3, 3, sum(cis), co)) * 0.1).astype(np.float32)
    r = rng.normal(size=(B, D, H, W, co)).astype(np.float32)
    gx_ref, gw_ref = _jax_grads(xs, w, r)
    gx, gw = _port_grads(xs, w, _halo(r))
    for i, (a, b) in enumerate(zip(gx, gx_ref)):
        assert a.shape == b.shape
        _grad_close(a, b, f"dx{i}")
    assert gw.shape == gw_ref.shape
    _grad_close(gw, gw_ref, "dw")


@pytest.mark.parametrize("case", list(CASES))
def test_k6_pad_garbage_changes_nothing(case):
    B, D, H, W, cis, co = CASES[case]
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(B, D, H, W, c)).astype(np.float32) for c in cis]
    w = (rng.normal(size=(3, 3, 3, sum(cis), co)) * 0.1).astype(np.float32)
    r = rng.normal(size=(B, D, H, W, co)).astype(np.float32)
    gx, gw = _port_grads(xs, w, _halo(r))
    gx_g, gw_g = _port_grads(xs, w, _halo(r, 100.0, rng))
    for i, (a, b) in enumerate(zip(gx_g, gx)):
        _grad_close(a, b, f"dx{i} (garbage)", rel=2 ** -10)
    _grad_close(gw_g, gw, "dw (garbage)", rel=2 ** -10)


def test_k6_matches_its_plain_version():
    """K6's structure (its own backward, on the plain K1 here) against
    autograd through the plain K1: the same function and gradients."""
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=(2, 3, 6, 10, 32)).astype(np.float32)
          for _ in range(2)]
    w = (rng.normal(size=(3, 3, 3, 64, 32)) * 0.1).astype(np.float32)
    r = _halo(rng.normal(size=(2, 3, 6, 10, 32)).astype(np.float32), 10.0,
              rng)
    gx, gw = _port_grads(xs, w, r)
    gx_p, gw_p = _port_grads(xs, w, r, T.conv3d_halo_train_plain)
    for i, (a, b) in enumerate(zip(gx, gx_p)):
        _grad_close(a, b, f"dx{i} vs plain")
    _grad_close(gw, gw_p, "dw vs plain")
    with torch.no_grad():
        xh = [T.pack_halo_plain(torch.from_numpy(x).to(BF16)) for x in xs]
        wt = torch.from_numpy(w)
        y = T.conv3d_halo_train(xh, wt)
        assert torch.equal(y, T.conv3d_halo(xh, wt))
        assert not y[:, 0].any() and not y[:, -1].any()


def test_k6_counts_only_card_launches():
    """On CPU tensors K6 runs the plain K1 and counts nothing."""
    T.reset_launch_counts()
    x = T.pack_halo_plain(torch.randn(1, 2, 4, 4, 32).to(BF16)).requires_grad_()
    w = torch.randn(3, 3, 3, 32, 32, requires_grad=True)
    T.conv3d_halo_train((x,), w).float().sum().backward()
    assert T.launch_counts() == dict.fromkeys(T.launch_counts(), 0)
    assert x.grad is not None and w.grad is not None
    assert not x.grad[:, 0].any()          # no gradient into the halo
