"""K5 (``ops/groupnorm.py::fused_group_norm``) against the JAX package's
``fused_group_norm``, on the CPU.

Here the port's wrapper runs its plain version (CPU tensors) and the JAX
Pallas kernels run in interpret mode, at tests/test_pallas.py's shapes
and flags: the three (shape, groups) cases (one with a ragged voxel count
against JAX's tiles), ReLU with the residual, and bf16 I/O. The same
inputs, made with numpy from a seed, go to both.

Tolerances, each against max|ref|: f32 within 1e-5 (f32 sums in another
order; JAX's own test allows 1e-4 against its reference op); bf16 within
1 bf16 ulp (one rounding of an f32 result on both sides: an element whose
f32 values straddle a rounding boundary differs by one ulp of itself).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import (
    fused_group_norm as jax_fused_group_norm)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.groupnorm import (
    fused_group_norm, fused_group_norm_plain)

SHAPES = [
    ((2, 4, 4, 4, 16), 8),
    ((1, 5, 3, 7, 32), 4),      # ragged M
    ((1, 8, 8, 8, 8), 1),
]


def _ulp(m):
    """One bf16 ulp at magnitude m."""
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    gamma = rng.normal(size=shape[-1]).astype(np.float32)
    beta = rng.normal(size=shape[-1]).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jax_in = (jnp.asarray(x).astype(jd), jnp.asarray(res).astype(jd),
              jnp.asarray(gamma), jnp.asarray(beta))
    torch_in = (torch.from_numpy(x).to(td), torch.from_numpy(res).to(td),
                torch.from_numpy(gamma), torch.from_numpy(beta))
    return jax_in, torch_in


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    m = np.abs(want).max()
    tol = _ulp(m) if dtype == "bfloat16" else 1e-5 * m
    d = np.abs(got - want).max()
    assert d <= tol, (d, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu,residual", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_fused_group_norm_matches_jax(shape, groups, relu, residual, dtype):
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _inputs(shape, 0, dtype)
    want = jax_fused_group_norm(jx, jg, jb, groups,
                                residual=jr if residual else None,
                                relu=relu, tile_m=16, interpret=True)
    got = fused_group_norm(tx, tg, tb, groups,
                           residual=tr if residual else None, relu=relu)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)


def test_fused_group_norm_residual_of_another_dtype():
    """An f32 residual added to a bf16 GroupNorm: the sum in f32, one
    rounding to bf16, as JAX's apply kernel takes it."""
    shape = (1, 4, 4, 4, 16)
    (jx, _, jg, jb), (tx, _, tg, tb) = _inputs(shape, 1, "bfloat16")
    r = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = jax_fused_group_norm(jx, jg, jb, 8, residual=jnp.asarray(r),
                                relu=True, tile_m=32, interpret=True)
    got = fused_group_norm(tx, tg, tb, 8, residual=torch.from_numpy(r),
                           relu=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("fn", [fused_group_norm, fused_group_norm_plain])
def test_fused_group_norm_refuses_ragged_groups(fn):
    x = torch.zeros((1, 2, 2, 2, 12))
    with pytest.raises(ValueError):
        fn(x, torch.ones(12), torch.zeros(12), 8)
