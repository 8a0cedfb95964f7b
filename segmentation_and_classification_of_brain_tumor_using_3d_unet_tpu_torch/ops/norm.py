"""Normalisation ops (NDHWC layout), counterparts of the JAX package's
``ops/norm.py`` and of the GroupNorm variants in its ``ops/s2d.py`` and
``ops/pallas/ps2d.py``.

All GroupNorms take one-pass f32 moments (mean of x and of x^2) with the
variance clamped at 0. That is not ``torch.nn.GroupNorm``'s two-pass
form: near-constant groups come out differently, and the port follows
the reference.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16


def group_affine(s1: torch.Tensor, s2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """Per-channel means of x and x^2, (N, C) f32 -> the per-channel
    (scale, shift) f32 pair with ``x * scale + shift`` == GroupNorm(x)."""
    n, c = s1.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    g1 = s1.reshape(n, num_groups, -1).mean(-1)
    g2 = s2.reshape(n, num_groups, -1).mean(-1)
    mean_c = g1.repeat_interleave(c // num_groups, dim=-1)
    var_c = torch.clamp(
        g2.repeat_interleave(c // num_groups, dim=-1) - mean_c.square(),
        min=0.0)
    rstd_c = torch.rsqrt(var_c + eps)
    gm = gamma.float()
    return rstd_c * gm, beta.float() - mean_c * rstd_c * gm


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (N, ..., C) as the JAX ``group_norm``: statistics
    and the affine in f32, one rounding to ``x.dtype`` at the end."""
    axes = tuple(range(1, x.ndim - 1))
    xf = x.float()
    scale, shift = group_affine(xf.mean(axes), xf.square().mean(axes),
                                gamma, beta, num_groups, eps)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (xf * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def bf16_moments(x: torch.Tensor, count: int):
    """Per-channel means of a bf16 (N, ..., C) tensor and of its square
    over ``count`` voxels: f32 accumulation of the bf16 values, and of
    the squares rounded to bf16 (the JAX ``group_norm_s2d`` and
    ``group_norm_flat`` statistics). ``count`` is the true voxel count,
    so zero padding in ``x`` does not change the result."""
    axes = tuple(range(1, x.ndim - 1))
    return (x.sum(axes, dtype=torch.float32) / count,
            x.square().sum(axes, dtype=torch.float32) / count)


def apply_affine_bf16(x: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor) -> torch.Tensor:
    """``x * scale + shift`` in bf16 with per-(N, C) factors, as the
    JAX package's s2d and flat GroupNorms apply it."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (x * scale.to(BF16).reshape(shape)
            + shift.to(BF16).reshape(shape))


def group_norm_bf16(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, num_groups: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with the arithmetic of the JAX ``group_norm_s2d``:
    ``bf16_moments`` statistics, affine applied in bf16."""
    count = x[0, ..., 0].numel()
    scale, shift = group_affine(*bf16_moments(x, count), gamma, beta,
                                num_groups, eps)
    return apply_affine_bf16(x, scale, shift)


def batch_norm_infer(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm from running statistics (JAX
    ``batch_norm_infer``; flax ``BatchNorm`` at eval computes the same):
    f32 arithmetic, result in ``x.dtype``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return ((x.float() - mean.float()) * scale + beta.float()).to(x.dtype)
