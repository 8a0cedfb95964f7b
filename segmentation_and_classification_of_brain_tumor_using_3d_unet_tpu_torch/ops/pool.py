"""Pooling ops (NDHWC), counterparts of the JAX package's ``ops/pool.py``."""

from __future__ import annotations

import torch


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 stride-2 max pool with VALID padding (odd trailing rows
    are dropped, as ``lax.reduce_window`` does)."""
    B, D, H, W, C = x.shape
    d2, h2, w2 = D // 2, H // 2, W // 2
    x = x[:, :2 * d2, :2 * h2, :2 * w2]
    return x.reshape(B, d2, 2, h2, 2, w2, 2, C).amax(dim=(2, 4, 6))


def global_avg_pool(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the spatial dims of (B, ..., C) with f32 accumulation,
    returned as (B, 1, 1, 1, C) in ``x.dtype``. ``group``: ``x`` is this
    rank's D slab of a volume sharded over that process group; the mean
    is the f32 sum over the group (a differentiable all-reduce) over the
    volume's voxel count."""
    axes = tuple(range(1, x.ndim - 1))
    if group is None:
        return x.mean(axes, keepdim=True, dtype=torch.float32).to(x.dtype)
    from ..parallel.mesh import all_reduce_sum
    s = x.sum(axes, keepdim=True, dtype=torch.float32)
    count = torch.full_like(s, float(x[0, ..., 0].numel()))
    s = all_reduce_sum(torch.stack([s, count]), group)
    return (s[0] / s[1]).to(x.dtype)
