"""Convolutions of the normal (NDHWC) layout.

Counterparts of the JAX package's ``ops/conv.py``. There these are XLA
ops, not Pallas kernels, so here they are library calls: cuDNN's conv3d
and cuBLAS's matmul on the card. Every op takes bf16 operands,
accumulates in f32 and rounds its result to bf16 once, as the JAX
functions do. Kernels are kept in flax's layouts (DHWIO), so parameters
move between the packages unchanged.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BF16 = torch.bfloat16

# convs with at most this many output channels take the ksplit
# formulation (JAX ops/conv.py KSPLIT_MAX_CO): its per-tap bf16 rounding
# is part of the reference's arithmetic for the head conv
KSPLIT_MAX_CO = 16


def f32_accumulate(fn, *args):
    """``fn`` on bf16 operands with f32 accumulation, result in bf16.

    cuDNN and cuBLAS accumulate bf16 products in f32 themselves; on the
    CPU the operands are widened first, which gives the same result."""
    if args[0].is_cuda:
        return fn(*args)
    return fn(*(a.float() for a in args)).to(BF16)


def matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in bf16 with f32 accumulation (``x`` (..., K),
    ``w`` (K, N) or batched (B, K, N) against ``x`` (B, ..., K))."""
    return f32_accumulate(torch.matmul, x.to(BF16), w.to(BF16))


def _conv3d(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """NDHWC ``x`` (bf16) with a DHWIO kernel -> NDHWC bf16."""
    xn = x.permute(0, 4, 1, 2, 3)                 # channels-last NCDHW view
    wn = w.to(BF16).permute(4, 3, 0, 1, 2).contiguous()
    y = f32_accumulate(lambda a, b: F.conv3d(a, b, padding=padding), xn, wn)
    return y.permute(0, 2, 3, 4, 1)


def conv3d_zcat(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor = None) -> torch.Tensor:
    """3x3x3 SAME conv (JAX ``conv3d_zcat``): x (B, D, H, W, Cin) bf16,
    w (3, 3, 3, Cin, Cout); bf16 out, bias added in bf16."""
    if tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d_zcat expects 3x3x3 kernels, got "
                         f"{tuple(w.shape)}")
    y = _conv3d(x, w, padding=1)
    if bias is not None:
        y = y + bias.to(BF16)
    return y.contiguous()


def conv3d_ksplit(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor = None) -> torch.Tensor:
    """3x3x3 SAME conv as the JAX ``conv3d_ksplit``: one 2-D conv per
    depth tap, each rounded to bf16, then a shifted three-slice sum in
    bf16."""
    B, D, H, W, _ = x.shape
    co = w.shape[-1]
    # (1, 3, 3, ci, 3*co): output block kz holds depth tap kz's 2-D kernel
    w2 = w.permute(1, 2, 3, 0, 4).reshape(1, 3, 3, w.shape[3], 3 * co)
    y = _conv3d(x, w2, padding=(0, 1, 1))         # (B, D, H, W, 3co)
    yp = F.pad(y, (0, 0, 0, 0, 0, 0, 1, 1))
    out = (yp[:, 0:D, ..., 0:co] + yp[:, 1:1 + D, ..., co:2 * co]
           + yp[:, 2:2 + D, ..., 2 * co:3 * co])
    if bias is not None:
        out = out + bias.to(BF16)
    return out.contiguous()


def conv3d_3x3x3(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor = None) -> torch.Tensor:
    """The formulation the JAX ``conv3d_3x3x3`` picks for this shape."""
    if w.shape[-1] <= KSPLIT_MAX_CO:
        return conv3d_ksplit(x, w, bias)
    return conv3d_zcat(x, w, bias)


def conv_transpose3d_k2s2(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor = None) -> torch.Tensor:
    """ConvTranspose(kernel 2^3, stride 2^3) as a matmul and a
    depth-to-space (JAX ``conv_transpose3d_k2s2``). x (B, D, H, W, Cin),
    w (2, 2, 2, Cin, Cout) in flax's convention, which applies the
    kernel spatially flipped: out[2d+a, 2h+p, 2w+q] = x[d, h, w] @
    w[1-a, 1-p, 1-q]."""
    B, D, H, W, _ = x.shape
    ci, co = w.shape[3], w.shape[4]
    wf = w.flip(0, 1, 2).reshape(8, ci, co).permute(1, 0, 2)
    y = matmul_bf16(x, wf.reshape(ci, 8 * co))    # (B, D, H, W, 8co)
    y = y.reshape(B, D, H, W, 2, 2, 2, co).permute(0, 1, 4, 2, 5, 3, 6, 7)
    y = y.reshape(B, 2 * D, 2 * H, 2 * W, co)
    if bias is not None:
        y = y + bias.to(BF16)
    return y.contiguous()


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor = None) -> torch.Tensor:
    """Pointwise conv as a channel matmul (JAX ``conv1x1``); w is
    (1, 1, 1, Cin, Cout) or (Cin, Cout)."""
    y = matmul_bf16(x, w.reshape(w.shape[-2], w.shape[-1]))
    if bias is not None:
        y = y + bias.to(BF16)
    return y


def _kaiming_fan_out(shape, generator) -> torch.Tensor:
    """flax ``variance_scaling(2.0, "fan_out", "normal")`` for a
    (..., in, out) kernel."""
    fan_out = math.prod(shape[:-2]) * shape[-1]
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_out)


class _ConvParams(nn.Module):
    """``kernel`` (flax layout, f32) and optional ``bias`` parameters."""

    def __init__(self, kernel_shape, use_bias: bool, generator=None,
                 init="kaiming"):
        super().__init__()
        if init == "kaiming":
            k = _kaiming_fan_out(kernel_shape, generator)
        else:   # flax lecun_normal: fan-in scaled
            fan_in = math.prod(kernel_shape[:-1])
            k = (torch.randn(kernel_shape, generator=generator)
                 * math.sqrt(1.0 / fan_in))
        self.kernel = nn.Parameter(k)
        self.bias = (nn.Parameter(torch.zeros(kernel_shape[-1]))
                     if use_bias else None)


class Conv1x1(_ConvParams):
    """Pointwise conv; parameters as flax ``nn.Conv(features, (1,1,1))``."""

    def __init__(self, cin: int, features: int, use_bias: bool = True,
                 generator=None):
        super().__init__((1, 1, 1, cin, features), use_bias, generator)

    def forward(self, x):
        return conv1x1(x, self.kernel, self.bias)


class FastConv3D(_ConvParams):
    """3x3x3 SAME conv; parameters as flax ``nn.Conv(features, (3,3,3))``."""

    def __init__(self, cin: int, features: int, use_bias: bool = False,
                 generator=None):
        super().__init__((3, 3, 3, cin, features), use_bias, generator)

    def forward(self, x):
        return conv3d_3x3x3(x, self.kernel, self.bias)


class FastConvTranspose3D(_ConvParams):
    """k=2, s=2 transposed conv; parameters as flax
    ``nn.ConvTranspose(features, (2,2,2), strides=(2,2,2))``."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__((2, 2, 2, cin, features), True, generator,
                         init="lecun")

    def forward(self, x):
        return conv_transpose3d_k2s2(x, self.kernel, self.bias)
