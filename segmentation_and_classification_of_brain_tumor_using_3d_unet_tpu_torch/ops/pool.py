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


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims of (B, ..., C) with f32 accumulation,
    returned as (B, 1, 1, 1, C) in ``x.dtype``."""
    axes = tuple(range(1, x.ndim - 1))
    return x.mean(axes, keepdim=True, dtype=torch.float32).to(x.dtype)
