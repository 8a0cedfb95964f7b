"""Attention-gated residual 3-D U-Net, eval forward in bf16.

Counterpart of the JAX package's ``models/unet3d.py`` (``fast=True``):
NDHWC tensors, bf16 compute with f32 accumulation and f32 norm
statistics, the head BatchNorm applied in bf16 at eval. Module and
parameter names follow the flax tree (``down0.conv1.kernel``,
``head_bn.mean``, ...), so ``models.weights.load_unet3d_params`` moves
a JAX checkpoint in without a key map.

With ``ps2d_eval`` the level-0 extremities run in the halo layout on
the hand-written kernels (``ops/ps2d.py``): enc0's conv2, and the whole
decoder-last stage — the transposed conv, the attention gate folded
into the convs, both convs with the skip/up concat in K, and the
GroupNorm statistics emitted by the convs. That is the JAX package's
``ps2d_levels=1`` region; level 1 (``ps2d_levels=2``) is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.conv import BF16, Conv1x1, FastConv3D, FastConvTranspose3D
from ..ops.norm import batch_norm_infer, group_norm, group_norm_bf16
from ..ops.pool import global_avg_pool, max_pool3d
from ..ops.ps2d import (conv1x1_halo, conv3d_halo, global_avg_pool_halo,
                        group_norm_halo, group_norm_halo_affine,
                        halo_to_normal, max_pool3d_from_halo, pack_halo,
                        up_k2s2_into_halo)


class GroupNorm(nn.Module):
    """GroupNorm parameters (``scale``, ``bias``) and its variants."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        """The normal path (JAX ``group_norm``)."""
        return group_norm(x, self.scale, self.bias, self.num_groups, self.eps)

    def bf16(self, x):
        """The arithmetic of the JAX ``group_norm_s2d``."""
        return group_norm_bf16(x, self.scale, self.bias, self.num_groups,
                               self.eps)

    def halo(self, x, sums=None):
        """On a halo tensor (JAX ``group_norm_flat``)."""
        return group_norm_halo(x, self.scale, self.bias, self.num_groups,
                               self.eps, sums)

    def halo_affine(self, x, sums=None):
        """(scale, shift) for the next conv's on-load transform (JAX
        ``group_norm_flat_affine``)."""
        return group_norm_halo_affine(x, self.scale, self.bias,
                                      self.num_groups, self.eps, sums)


class BatchNorm(nn.Module):
    """Eval BatchNorm: ``scale``/``bias`` parameters and the running
    ``mean``/``var`` (flax ``batch_stats``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        return batch_norm_infer(x, self.scale, self.bias, self.mean,
                                self.var, self.eps)


class DoubleConv3D(nn.Module):
    """Conv3-GN8-ReLU x2 with a residual: identity when in == out, else
    a 1x1 conv + GN8 projection (JAX ``DoubleConv3D``)."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.conv1 = FastConv3D(in_ch, out_ch, generator=generator)
        self.gn1 = GroupNorm(out_ch, 8)
        self.conv2 = FastConv3D(out_ch, out_ch, generator=generator)
        self.gn2 = GroupNorm(out_ch, 8)
        if in_ch != out_ch:
            self.proj = Conv1x1(in_ch, out_ch, use_bias=False,
                                generator=generator)
            self.gn_proj = GroupNorm(out_ch, 8)

    def forward(self, x):
        out = torch.relu(self.gn1(self.conv1(x)))
        out = torch.relu(self.gn2(self.conv2(out)))
        if self.in_ch == self.out_ch:
            return out + x
        return out + self.gn_proj(self.proj(x))

    def forward_entry(self, x):
        """The region's entry block (enc0; JAX ``_ps2d_entry``): conv1
        and the projection stay library ops on the few-channel NDHWC
        input; their outputs are packed into the halo layout (K3) and
        conv2 runs on K1 with gn1's affine + ReLU applied on load.
        Returns the block's output in the halo layout."""
        if self.in_ch == self.out_ch:
            raise ValueError("the entry block needs a projection residual")
        out1 = pack_halo(self.conv1(x))
        sc1, sh1 = self.gn1.halo_affine(out1)
        out, st2 = conv3d_halo((out1,), self.conv2.kernel, in_scale=sc1,
                               in_shift=sh1, in_relu=True, emit_stats=True)
        out = torch.relu(self.gn2.halo(out, sums=st2))
        return out + pack_halo(self.gn_proj.bf16(self.proj(x)))

    def forward_halo(self, xs, gate=None):
        """The block on halo tensors (JAX ``_ps2d``): ``xs`` is a tuple
        whose channel concat is the input (folded into K1's K, never
        stored). ``gate`` = (psi (B, D+2, H+2, W+2, 1), se (B, c0)) from
        ``AttentionGate3D.fold_halo`` gates input 0 inside conv1's load
        and inside the projection's weights."""
        psi = se = mask0 = None
        if gate is not None:
            psi, se = gate
            mask0 = psi * se.to(BF16)[:, None, None, None, :]
        out, st1 = conv3d_halo(xs, self.conv1.kernel, in_mul0=mask0,
                               emit_stats=True)
        sc1, sh1 = self.gn1.halo_affine(out, sums=st1)
        out, st2 = conv3d_halo((out,), self.conv2.kernel, in_scale=sc1,
                               in_shift=sh1, in_relu=True, emit_stats=True)
        out = torch.relu(self.gn2.halo(out, sums=st2))
        if self.in_ch == self.out_ch:
            if len(xs) != 1 or gate is not None:
                raise ValueError("identity residual needs a single "
                                 "ungated input")
            return out + xs[0]
        res = conv1x1_halo(xs, self.proj.kernel, None, se0=se, psi0=psi)
        return out + self.gn_proj.halo(res)


class AttentionGate3D(nn.Module):
    """Additive spatial gate + squeeze-excite channel attention (JAX
    ``AttentionGate3D``); g is the decoder signal, x the skip."""

    def __init__(self, channels: int, f_int: int, generator=None):
        super().__init__()
        se_ch = max(channels // 8, 1)
        self.w_g = Conv1x1(channels, f_int, generator=generator)
        self.gn_g = GroupNorm(f_int, 4)
        self.w_x = Conv1x1(channels, f_int, generator=generator)
        self.gn_x = GroupNorm(f_int, 4)
        self.psi = Conv1x1(f_int, 1, generator=generator)
        self.gn_psi = GroupNorm(1, 1)
        self.se_down = Conv1x1(channels, se_ch, generator=generator)
        self.se_up = Conv1x1(se_ch, channels, generator=generator)

    def _se(self, pooled):
        return torch.sigmoid(self.se_up(torch.relu(self.se_down(pooled))))

    def forward(self, g, x):
        g1 = self.gn_g(self.w_g(g))
        x1 = self.gn_x(self.w_x(x))
        psi = torch.sigmoid(self.gn_psi(self.psi(torch.relu(g1 + x1))))
        return x * psi * self._se(global_avg_pool(x))

    def fold_halo(self, g, x):
        """On halo tensors, returning the factors instead of the gated
        skip (JAX ``_ps2d(fold=True)``): psi (B, D+2, H+2, W+2, 1) — 0.5
        on the halo, where x is zero — and se (B, C)."""
        if g.shape != x.shape:
            raise ValueError("the halo gate needs matching g/x shapes")

        def branch(conv, gn, t):
            return gn.halo(conv1x1_halo((t,), conv.kernel, conv.bias))

        psi = torch.relu(branch(self.w_g, self.gn_g, g)
                         + branch(self.w_x, self.gn_x, x))
        psi = torch.sigmoid(branch(self.psi, self.gn_psi, psi))
        se = self._se(global_avg_pool_halo(x))
        return psi, se.reshape(x.shape[0], x.shape[-1])


class UNet3D(nn.Module):
    """Segmentation U-Net (JAX ``UNet3D``), eval forward only.

    ``forward(x)``: x (B, D, H, W, in_channels) -> logits
    (B, D, H, W, out_channels) f32. Parameters are made from ``seed``
    with a ``torch.Generator`` (kaiming fan-out normal convs, as flax's
    initialisers; the values differ from JAX's) on ``device``."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 features: Sequence[int] = (32, 64, 128, 256, 512),
                 ps2d_eval: bool = False, ps2d_levels: int = 1,
                 seed: int = 0, device="cuda"):
        super().__init__()
        if ps2d_levels != 1:
            raise NotImplementedError(
                "ps2d_levels > 1 (the level-1 region and its fused pool "
                "kernel) is not ported yet")
        feats = tuple(features)
        self.features, self.ps2d_eval = feats, ps2d_eval
        gen = torch.Generator().manual_seed(seed)
        cin = in_channels
        for i, f in enumerate(feats):
            setattr(self, f"down{i}", DoubleConv3D(cin, f, gen))
            if i < len(feats) - 1:
                # deep-supervision heads: used in training only, kept so
                # the parameter tree matches the JAX model's
                setattr(self, f"deep{i}", Conv1x1(f, out_channels,
                                                  generator=gen))
            cin = f
        self.bottleneck = DoubleConv3D(feats[-1], 2 * feats[-1], gen)
        cin = 2 * feats[-1]
        for i, f in enumerate(reversed(feats)):
            setattr(self, f"up{i}", FastConvTranspose3D(cin, f, gen))
            setattr(self, f"att{i}", AttentionGate3D(f, max(f // 2, 1), gen))
            setattr(self, f"dec{i}", DoubleConv3D(2 * f, f, gen))
            cin = f
        self.head_conv = FastConv3D(feats[0], feats[0] // 2, use_bias=True,
                                    generator=gen)
        self.head_bn = BatchNorm(feats[0] // 2)
        self.head_out = Conv1x1(feats[0] // 2, out_channels, generator=gen)
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.features
        n = len(feats)
        x = x.to(BF16)
        full = tuple(x.shape[1:4])
        if min(full) < 2 ** n:
            raise ValueError(f"input spatial dims {full} too small for {n} "
                             f"encoder levels (need >= {2 ** n})")
        # the level-0 region needs a 32-multiple width (K1's channel
        # chunks; in JAX the GN parameter shapes) and even dims, so
        # the decoder-last up exactly doubles level 1 back
        region = (self.ps2d_eval and feats[0] % 32 == 0
                  and all(s % 2 == 0 for s in full))
        skips = []
        for i in range(n):
            block = getattr(self, f"down{i}")
            if region and i == 0:
                x = block.forward_entry(x)
                skips.append(x)                # stays in the halo layout
                x = max_pool3d_from_halo(x)
            else:
                x = block(x)
                skips.append(x)
                x = max_pool3d(x)
        x = self.bottleneck(x)
        for i in range(n):
            skip = skips[-(i + 1)]
            up, att, dec = (getattr(self, f"{p}{i}")
                            for p in ("up", "att", "dec"))
            want = tuple(s - 2 for s in skip.shape[1:4]) if (
                region and i == n - 1) else tuple(skip.shape[1:4])
            if tuple(2 * s for s in x.shape[1:4]) != want:
                raise ValueError(
                    f"decoder level {n - 1 - i}: upsampled {x.shape[1:4]} "
                    f"does not double to the skip's {want}; that needs "
                    f"resize_trilinear, which is not ported (pad the input "
                    f"to a multiple of 2**{n})")
            if region and i == n - 1:
                up_h = up_k2s2_into_halo(x, up.kernel, up.bias)
                gate = att.fold_halo(g=up_h, x=skip)
                x = halo_to_normal(dec.forward_halo((skip, up_h), gate))
            else:
                x = up(x)
                x = dec(torch.cat([att(g=x, x=skip), x], dim=-1))
        h = torch.relu(self.head_bn(self.head_conv(x)))
        return self.head_out(h).float()
