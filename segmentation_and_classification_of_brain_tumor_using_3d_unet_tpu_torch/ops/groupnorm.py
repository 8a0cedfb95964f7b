"""Fused GroupNorm (+ReLU, +residual): K5, a hand-written CUDA kernel
(``csrc/group_norm.cu``), with its plain PyTorch version beside it.

Counterpart of the JAX package's ``ops/pallas/groupnorm.py``. The
DoubleConv tail ``relu(norm(x)) + residual`` in two passes over the
activation: per-channel f32 sums of x and of x*x (the squares taken in
f32), folded into the group statistics by ``norm.group_affine`` (one-pass
moments, the variance clamped at 0, as JAX's XLA epilogue), then the
affine, the optional ReLU and the optional residual in f32 with one
rounding to ``x.dtype``. JAX's ``tile_m`` and lane packing shape its TPU
grid and lanes only, and are not carried over.

The wrapper takes its plain version for tensors on the CPU only; for a
CUDA tensor it launches the kernels or raises. ``fused_group_norm.launches``
counts the kernels launched: three a call (two for the statistics, one to
apply them).
"""

from __future__ import annotations

import math

import torch

from .norm import group_affine
from .ps2d import _aligned, _lib, _on_cpu, _ptr, _stream

# stats pass: about 8 blocks of 256 threads on each of the H100's 132 SMs
_STATS_BLOCKS = 1056
_MIN_CHUNK_ROWS = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_group_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, num_groups: int,
                           eps: float = 1e-5, residual: torch.Tensor = None,
                           relu: bool = False) -> torch.Tensor:
    """Plain version of K5: the same function as tensor ops."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, c)
    m = xf.shape[1]
    scale, shift = group_affine(xf.sum(1) / m, xf.square().sum(1) / m,
                                gamma, beta, num_groups, eps)
    y = xf * scale[:, None] + shift[:, None]
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.float().reshape(n, -1, c)
    return y.to(x.dtype).reshape(x.shape)


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, num_groups: int, eps: float = 1e-5,
                     residual: torch.Tensor = None,
                     relu: bool = False) -> torch.Tensor:
    """K5 (JAX ``fused_group_norm``): GroupNorm over (N, ..., C), then
    the optional ReLU, then the optional ``+ residual`` (the DoubleConv
    tail order ``relu(norm(x)) + residual``). x and the residual f32 or
    bf16; the result in ``x.dtype``."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} % groups {num_groups} != 0")
    if _on_cpu(x):
        return fused_group_norm_plain(x, gamma, beta, num_groups, eps,
                                      residual, relu)
    m = x.numel() // max(n * c, 1)
    if (x.dtype not in _DTYPES or x.ndim < 2 or x.numel() == 0
            or m * c >= 2 ** 31 or n > 65535):
        raise ValueError(f"fused_group_norm: needs a non-empty f32 or bf16 "
                         f"(N, ..., C) tensor with N <= 65535 and fewer than "
                         f"2^31 values a sample, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype not in _DTYPES
                                 or not residual.is_cuda):
        raise ValueError(f"fused_group_norm: the residual must be an f32 or "
                         f"bf16 CUDA tensor of x's shape, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    xc = _aligned(x)
    chunks = max(1, min(math.ceil(m / _MIN_CHUNK_ROWS),
                        math.ceil(_STATS_BLOCKS / n)))
    chunk_rows = math.ceil(m / chunks)
    chunks = math.ceil(m / chunk_rows)
    part = torch.empty((n, chunks, 2, c), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    lib = _lib()
    lib.check("group_norm_stats", lib.group_norm_stats(
        xc.data_ptr(), _DTYPES[x.dtype], part.data_ptr(), sums.data_ptr(),
        n, m, c, chunk_rows, chunks, _stream()))
    fused_group_norm.launches += 2
    scale, shift = group_affine(sums[:, 0] / m, sums[:, 1] / m,
                                gamma.to(x.device), beta.to(x.device),
                                num_groups, eps)
    scale, shift = scale.contiguous(), shift.contiguous()
    r = None if residual is None else _aligned(residual)
    y = torch.empty_like(xc)
    lib.check("group_norm_apply", lib.group_norm_apply(
        xc.data_ptr(), _DTYPES[x.dtype], scale.data_ptr(), shift.data_ptr(),
        _ptr(r), 0 if r is None else _DTYPES[r.dtype], int(relu), y.data_ptr(),
        n, m, c, _stream()))
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0
