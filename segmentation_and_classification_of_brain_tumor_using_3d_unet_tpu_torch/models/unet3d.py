"""Attention-gated residual 3-D U-Net: the eval and train forwards.

Counterpart of the JAX package's ``models/unet3d.py`` (``fast=True``):
NDHWC tensors, computed in ``compute_dtype`` (bf16 by default, or f32;
JAX's ``dtype``) with f32 accumulation and f32 norm statistics, the
parameters f32 and cast at use, the head BatchNorm applied in the
compute dtype at eval and in f32 at train, the logits returned in f32.
Module and parameter names follow the flax tree (``down0.conv1.kernel``,
``head_bn.mean``, ...), so ``models.weights.load_flax_params`` moves
a JAX checkpoint in without a key map.

With ``ps2d_eval`` the level-0 extremities run in the halo layout on
the hand-written kernels (``ops/ps2d.py``): enc0's conv2, and the whole
decoder-last stage — the transposed conv, the attention gate folded
into the convs, both convs with the skip/up concat in K, and the
GroupNorm statistics emitted by the convs. That is the JAX package's
``ps2d_levels=1`` region. ``ps2d_levels=2`` adds the level-1 region:
enc0's output is pooled straight into the level-1 halo layout (K4),
enc1 and the dec1 stage run wholly on the kernels, and the level-1
skip stays in the halo layout between them.

``forward_train`` is the train forward (JAX ``__call__(train=True)``):
the deep-supervision heads, channel dropout after each pool, the head
BatchNorm on f32 batch statistics, and activation checkpointing of the
DoubleConv blocks under ``remat``. With ``ps2d_train`` its level-0
region runs in the halo layout on the differentiable conv K6
(``ops/ps2d.py::conv3d_halo_train``, K1 forwards and backwards): enc0's
conv2 and the dec0 stage's two convs; the glue between them stays plain
differentiable ops (no eval-only folds), as in JAX. Both regions run in
the compute dtype, on the kernels' bf16 or f32 forms, as JAX's kernels
compute in their input's dtype.

With a ``space_group`` (the ``space`` axis of a mesh, JAX's GSPMD
partition of D) every forward runs on this rank's D slab of each
activation: every 3x3x3 conv of the normal path on the slab extended by
one plane of each neighbour (``ops/conv.py::conv3d_slab``), every
GroupNorm's statistics and the gates' pooling summed over the group; the
transposed convs, the pools and the 1x1 convs need no neighbour while
each slab's depth is even at every level. The ps2d regions run on the
slab too, on the same kernels: each halo tensor's D halo planes are
filled from the neighbours (``parallel/spatial.py::halo_exchange_planes``)
just before the K1 / K6 that reads it, after the GroupNorm that made it,
and K1 loads them as live planes. Deep heads at full resolution resize
the slab extended by one edge-clamped plane of each neighbour and crop
it. The train step passes the whole mesh's group as ``bn_group``.
"""

from __future__ import annotations

import copy
import itertools
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.conv import (BF16, QUANT_MODES, Conv1x1, FastConv3D,
                        FastConvTranspose3D, set_compute_dtype)
from ..ops.dropout import dropout
from ..ops.norm import (batch_norm_infer, batch_norm_train, group_norm,
                        group_norm_s2d)
from ..ops.pool import global_avg_pool, max_pool3d
from ..ops.ps2d import (conv1x1_halo, conv3d_halo, conv3d_halo_train,
                        global_avg_pool_halo, group_norm_halo,
                        group_norm_halo_affine, halo_to_normal,
                        max_pool3d_from_halo, pack_halo, pack_halo_plain,
                        pool_into_halo, up_k2s2_into_halo)
from ..ops.resize import resize_trilinear
from ..parallel.spatial import halo_exchange_d, halo_exchange_planes


class GroupNorm(nn.Module):
    """GroupNorm parameters (``scale``, ``bias``) and its variants."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, space_group=None):
        """The normal path (JAX ``group_norm``), on a D slab with
        ``space_group``."""
        return group_norm(x, self.scale, self.bias, self.num_groups,
                          self.eps, space_group)

    def s2d(self, x, space_group=None):
        """The arithmetic of the JAX ``group_norm_s2d``."""
        return group_norm_s2d(x, self.scale, self.bias, self.num_groups,
                              self.eps, space_group)

    def halo(self, x, sums=None, space_group=None):
        """On a halo tensor (JAX ``group_norm_flat``)."""
        return group_norm_halo(x, self.scale, self.bias, self.num_groups,
                               self.eps, sums, space_group)

    def halo_affine(self, x, sums=None, space_group=None):
        """(scale, shift) for the next conv's on-load transform (JAX
        ``group_norm_flat_affine``)."""
        return group_norm_halo_affine(x, self.scale, self.bias,
                                      self.num_groups, self.eps, sums,
                                      space_group)


class BatchNorm(nn.Module):
    """BatchNorm: ``scale``/``bias`` parameters and the running
    ``mean``/``var`` (flax ``batch_stats``, momentum 0.9)."""

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

    def train_stats(self, x, stats=None, group=None):
        """Train mode on batch statistics: (y f32, (new mean, new
        var)); ``stats`` = the running (mean, var) to advance, the
        buffers when None (they are not written here); ``group``: the
        data-parallel ranks whose batches are one batch."""
        mean, var = stats if stats is not None else (self.mean, self.var)
        return batch_norm_train(x, self.scale, self.bias, mean, var,
                                eps=self.eps, group=group)


class DoubleConv3D(nn.Module):
    """Conv3-GN8-ReLU x2 with a residual: identity when in == out, else
    a 1x1 conv + GN8 projection (JAX ``DoubleConv3D``). ``quant_mode``
    goes to the two 3x3x3 convs only (``FastConv3D``)."""

    def __init__(self, in_ch: int, out_ch: int, generator=None,
                 quant_mode: str = "off"):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.conv1 = FastConv3D(in_ch, out_ch, generator=generator,
                                quant_mode=quant_mode)
        self.gn1 = GroupNorm(out_ch, 8)
        self.conv2 = FastConv3D(out_ch, out_ch, generator=generator,
                                quant_mode=quant_mode)
        self.gn2 = GroupNorm(out_ch, 8)
        if in_ch != out_ch:
            self.proj = Conv1x1(in_ch, out_ch, use_bias=False,
                                generator=generator)
            self.gn_proj = GroupNorm(out_ch, 8)

    def forward(self, x, space_group=None):
        g = space_group
        out = torch.relu(self.gn1(self.conv1(x, g), g))
        out = torch.relu(self.gn2(self.conv2(out, g), g))
        if self.in_ch == self.out_ch:
            return out + x
        return out + self.gn_proj(self.proj(x), g)

    def forward_entry(self, x, space_group=None):
        """The region's entry block (enc0; JAX ``_ps2d_entry``): conv1
        and the projection stay library ops on the few-channel NDHWC
        input; their outputs are packed into the halo layout (K3) and
        conv2 runs on K1 with gn1's affine + ReLU applied on load.
        Returns the block's output in the halo layout. ``space_group``:
        on this rank's D slab (the module's docstring)."""
        if self.in_ch == self.out_ch:
            raise ValueError("the entry block needs a projection residual")
        g = space_group
        out1 = pack_halo(self.conv1(x, g))
        sc1, sh1 = self.gn1.halo_affine(out1, space_group=g)
        out1, live = halo_exchange_planes(out1, g)
        out, st2 = conv3d_halo((out1,), self.conv2.kernel, in_scale=sc1,
                               in_shift=sh1, in_relu=True, emit_stats=True,
                               d_live=live)
        out = torch.relu(self.gn2.halo(out, sums=st2, space_group=g))
        return out + pack_halo(self.gn_proj.s2d(self.proj(x), g))

    def forward_entry_train(self, x, space_group=None):
        """The entry block at train (JAX ``_ps2d_entry(trainable=True)``):
        conv1's output packed by K3's plain version (JAX's XLA pad),
        gn1 + ReLU as plain ops, conv2 on K6; the projection residual on
        the NDHWC input, packed at the add."""
        if self.in_ch == self.out_ch:
            raise ValueError("the entry block needs a projection residual")
        g = space_group
        # GroupNorm.halo re-zeroes the halo after its affine: relu(gn(x))
        # would otherwise leave relu(shift) there, which the plain K1
        # reads and the card's K1 ignores (the CPU and card answers split)
        out = torch.relu(self.gn1.halo(pack_halo_plain(self.conv1(x, g)),
                                       space_group=g))
        out, live = halo_exchange_planes(out, g)
        out = conv3d_halo_train((out,), self.conv2.kernel, live)
        out = torch.relu(self.gn2.halo(out, space_group=g))
        return out + pack_halo_plain(self.gn_proj.s2d(self.proj(x), g))

    def forward_halo_train(self, xs, space_group=None):
        """The dec0 block on halo tensors at train (JAX ``_ps2d(trainable=
        True)``): both convs on K6 (the inputs' concat in its K), the
        GroupNorms and ReLUs as plain ops, the projection residual; the
        gate was applied by the caller."""
        g = space_group
        xs_live, live = _exchanged(xs, g)
        out = conv3d_halo_train(xs_live, self.conv1.kernel, live)
        out = torch.relu(self.gn1.halo(out, space_group=g))
        out, live = halo_exchange_planes(out, g)
        out = conv3d_halo_train((out,), self.conv2.kernel, live)
        out = torch.relu(self.gn2.halo(out, space_group=g))
        return out + self.gn_proj.halo(conv1x1_halo(xs, self.proj.kernel),
                                       space_group=g)

    def forward_halo(self, xs, gate=None, space_group=None):
        """The block on halo tensors (JAX ``_ps2d``): ``xs`` is a tuple
        whose channel concat is the input (folded into K1's K, never
        stored). ``gate`` = (psi (B, D+2, H+2, W+2, 1), se (B, c0)) from
        ``AttentionGate3D.fold_halo`` gates input 0 inside conv1's load
        and inside the projection's weights."""
        g = space_group
        psi = se = mask0 = None
        xs_live, live = _exchanged(xs, g)
        if gate is not None:
            psi, se = gate
            # K1 reads the mask on the live planes too: the neighbour's psi
            mask0 = (halo_exchange_planes(psi, g)[0]
                     * se.to(psi.dtype)[:, None, None, None, :])
        out, st1 = conv3d_halo(xs_live, self.conv1.kernel, in_mul0=mask0,
                               emit_stats=True, d_live=live)
        sc1, sh1 = self.gn1.halo_affine(out, sums=st1, space_group=g)
        out, live = halo_exchange_planes(out, g)
        out, st2 = conv3d_halo((out,), self.conv2.kernel, in_scale=sc1,
                               in_shift=sh1, in_relu=True, emit_stats=True,
                               d_live=live)
        out = torch.relu(self.gn2.halo(out, sums=st2, space_group=g))
        if self.in_ch == self.out_ch:
            if len(xs) != 1 or gate is not None:
                raise ValueError("identity residual needs a single "
                                 "ungated input")
            return out + xs[0]
        res = conv1x1_halo(xs, self.proj.kernel, None, se0=se, psi0=psi)
        return out + self.gn_proj.halo(res, space_group=g)


def _exchanged(xs, group):
    """Each halo tensor of ``xs`` with its D halo planes filled from the
    neighbours, and their ``d_live`` (the same for all)."""
    pairs = [halo_exchange_planes(x, group) for x in xs]
    return tuple(p[0] for p in pairs), pairs[0][1]


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

    def forward(self, g, x, space_group=None):
        sg = space_group
        g1 = self.gn_g(self.w_g(g), sg)
        x1 = self.gn_x(self.w_x(x), sg)
        if g1.shape[1:4] != x1.shape[1:4]:
            g1 = resize_trilinear(g1, x1.shape[1:4])
        psi = torch.sigmoid(self.gn_psi(self.psi(torch.relu(g1 + x1)), sg))
        return x * psi * self._se(global_avg_pool(x, sg))

    def fold_halo(self, g, x, space_group=None):
        """On halo tensors, returning the factors instead of the gated
        skip (JAX ``_ps2d(fold=True)``): psi (B, D+2, H+2, W+2, 1) — 0.5
        on the halo, where x is zero — and se (B, C). ``space_group``:
        on D slabs, the statistics and the pooling over the group."""
        if g.shape != x.shape:
            raise ValueError("the halo gate needs matching g/x shapes")
        sg = space_group

        def branch(conv, gn, t):
            return gn.halo(conv1x1_halo((t,), conv.kernel, conv.bias),
                           space_group=sg)

        psi = torch.relu(branch(self.w_g, self.gn_g, g)
                         + branch(self.w_x, self.gn_x, x))
        psi = torch.sigmoid(branch(self.psi, self.gn_psi, psi))
        se = self._se(global_avg_pool_halo(x, sg))
        return psi, se.reshape(x.shape[0], x.shape[-1])

    def forward_halo(self, g, x, space_group=None):
        """The gated skip on halo tensors (JAX ``_ps2d(fold=False)``, the
        train path): x * psi * se, zero on the halo."""
        psi, se = self.fold_halo(g, x, space_group)
        return x * psi * se[:, None, None, None, :]


class UNet3D(nn.Module):
    """Segmentation U-Net (JAX ``UNet3D``).

    ``forward(x)``: x (B, D, H, W, in_channels) -> logits
    (B, D, H, W, out_channels) f32; ``forward_with_bottleneck(x)`` also
    returns the bottleneck's output (the joint grade head reads it).
    Both are the eval forward, without gradients. ``forward_train`` is
    the train forward. Parameters are made from ``seed`` with a
    ``torch.Generator`` (kaiming fan-out normal convs, as flax's
    initialisers; the values differ from JAX's) on ``device``.
    ``ps2d_levels`` >= 2 turns the level-1 region on at eval, as in
    JAX; ``ps2d_train`` the level-0 region at train. ``compute_dtype``
    (a torch dtype, or "bfloat16" / "float32") is JAX's ``dtype``.

    ``quant_mode`` ("off", "calib" or "int8"; JAX's int8 serving,
    ``inference/quantize.py``) applies to the DoubleConv blocks' 3x3x3
    convs, of the blocks whose name starts with one of ``quant_blocks``
    where that is given (JAX's prefix filter); the head, the gates, the
    1x1 projections and the upsamplers stay in the compute dtype. Any
    mode but "off" turns the ps2d regions off (``halo_levels`` is 0), as
    in JAX, and is eval only: ``forward_train`` raises.
    ``with_quant_mode`` is JAX's ``model.clone(quant_mode=...)``.
    ``s2d_eval`` / ``s2d_train`` are accepted and run the normal path: the
    JAX package's space-to-depth layout (``ops/s2d.py``) fills the TPU's
    128 lanes and computes the same function."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 features: Sequence[int] = (32, 64, 128, 256, 512),
                 ps2d_eval: bool = False, ps2d_levels: int = 1,
                 seed: int = 0, device="cuda", dropout_rate: float = 0.2,
                 remat: bool = False, ps2d_train: bool = False,
                 deep_sup_full_res: bool = False, compute_dtype=BF16,
                 quant_mode: str = "off", quant_blocks=None,
                 s2d_eval: bool = False, s2d_train: bool = False):
        super().__init__()
        feats = tuple(features)
        self.features, self.ps2d_eval = feats, ps2d_eval
        self.ps2d_levels = ps2d_levels
        self.dropout_rate, self.remat = dropout_rate, remat
        self.ps2d_train = ps2d_train
        self.s2d_eval, self.s2d_train = s2d_eval, s2d_train
        # deep heads at full resolution (the reference model's written
        # behaviour) instead of their native scale
        self.deep_sup_full_res = deep_sup_full_res
        gen = torch.Generator().manual_seed(seed)
        cin = in_channels
        for i, f in enumerate(feats):
            setattr(self, f"down{i}", DoubleConv3D(cin, f, gen))
            if i < len(feats) - 1:
                # deep-supervision heads (forward_train only)
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
        self.compute_dtype = set_compute_dtype(self, compute_dtype)
        self._set_quant_mode(quant_mode, quant_blocks)
        self.to(resolve_device(device))

    def double_convs(self):
        """(name, DoubleConv3D) of every block, in the flax tree's names."""
        n = len(self.features)
        names = ([f"down{i}" for i in range(n)] + ["bottleneck"]
                 + [f"dec{i}" for i in range(n)])
        return [(name, getattr(self, name)) for name in names]

    def _set_quant_mode(self, quant_mode: str, quant_blocks=None) -> None:
        """Set ``quant_mode`` and ``quant_blocks`` in place: each block's
        two 3x3x3 convs get the mode, or "off" where ``quant_blocks``
        names no prefix of the block (JAX ``UNet3D.__call__``'s
        ``block``)."""
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode must be one of {QUANT_MODES}, got "
                             f"{quant_mode!r}")
        self.quant_mode = quant_mode
        self.quant_blocks = (None if quant_blocks is None
                             else tuple(quant_blocks))
        for name, block in self.double_convs():
            qm = quant_mode
            if self.quant_blocks is not None and not any(
                    name.startswith(p) for p in self.quant_blocks):
                qm = "off"
            block.conv1.set_quant_mode(qm)
            block.conv2.set_quant_mode(qm)

    def with_quant_mode(self, quant_mode: str, quant_blocks=...):
        """JAX's ``model.clone(quant_mode=...)``: a model with this one's
        parameters and buffers, the same tensors (nothing is copied, so a
        weight loaded into one is the other's), with ``quant_mode`` and
        its own ``act_scale`` buffers; ``quant_blocks`` as this model's
        unless given."""
        shared = {id(t): t for name, t in itertools.chain(
            self.named_parameters(), self.named_buffers())
            if not name.endswith((".act_scale", ".absmax"))}
        clone = copy.deepcopy(self, shared)
        clone._set_quant_mode(quant_mode, self.quant_blocks
                              if quant_blocks is ... else quant_blocks)
        return clone

    def halo_levels(self, shape) -> int:
        """How many levels (from 0) run in the halo layout for an input
        of spatial ``shape``: JAX's eligibility rule. Level 0 needs a
        32-multiple width (K1's channel chunks; in JAX the GN parameter
        shapes) and even dims, so the decoder-last up doubles level 1
        back exactly; level 1 also needs ``ps2d_levels`` >= 2, a
        32-multiple level-1 width, D % 4 == 0 and H, W % 8 == 0. (JAX
        also drops a level whose TPU kernel plan does not fit its
        on-chip memory budget; that limit has no counterpart here.) The
        gate is the same in bf16 and in f32. Any ``quant_mode`` but "off"
        gives 0, during calibration too."""
        return self._halo_levels(shape, self.ps2d_eval, self.ps2d_levels)

    def k1_kernel_names(self, levels: int) -> list:
        """The parameters of the convs that run on K1 when ``levels``
        levels (0-2) run in the halo layout: K1 rounds their values to
        bf16 in f32 too, so a normal-path model given these rounded
        computes the region's function (in exact arithmetic)."""
        n = len(self.features)
        names = []
        if levels >= 1:
            names += ["down0.conv2.kernel", f"dec{n - 1}.conv1.kernel",
                      f"dec{n - 1}.conv2.kernel"]
        if levels >= 2:
            names += ["down1.conv1.kernel", "down1.conv2.kernel",
                      f"dec{n - 2}.conv1.kernel", f"dec{n - 2}.conv2.kernel"]
        return names

    def _halo_levels(self, shape, on: bool, levels: int) -> int:
        feats, (D, H, W) = self.features, tuple(shape)
        if not (on and self.quant_mode == "off" and feats[0] % 32 == 0
                and D % 2 == 0 and H % 2 == 0 and W % 2 == 0):
            return 0
        if (levels >= 2 and len(feats) >= 2
                and feats[1] % 32 == 0 and D % 4 == 0 and H % 8 == 0
                and W % 8 == 0):
            return 2
        return 1

    @torch.no_grad()
    def forward(self, x: torch.Tensor, space_group=None) -> torch.Tensor:
        return self.forward_with_bottleneck(x, space_group)[0]

    @torch.no_grad()
    def forward_with_bottleneck(self, x: torch.Tensor, space_group=None):
        """(logits f32, bottleneck output in the compute dtype (B, ...,
        2 * features[-1])); with ``space_group``, of this rank's D slab
        ``x``."""
        out = self._forward(x, train=False, space_group=space_group)
        return out["logits"], out["bottleneck"]

    def forward_train(self, x: torch.Tensor, generator=None,
                      batch_stats=None, bn_group=None,
                      space_group=None) -> dict:
        """The train forward, with gradients: {"logits": f32, "deep":
        [one head per encoder level but the last, in the compute dtype,
        at its level's scale, or full resolution with
        ``deep_sup_full_res``], "bottleneck": in the compute dtype,
        "batch_stats": the head BatchNorm's new
        running (mean, var)}. ``generator`` (on x's device) draws the
        dropout masks; ``batch_stats`` is the running (mean, var) to
        advance, the buffers when None; ``bn_group``: the process group
        of the data-parallel ranks, over which the head BatchNorm takes
        its batch statistics (on a ``space`` mesh, the whole mesh's
        group); ``space_group``: ``x`` is this rank's D slab of the
        batch sharded over that group, every output this slab's (the
        dropout masks, one value per (sample, channel), must then be
        drawn alike on every rank of the group). Nothing of the module is
        written: the train step stores the new statistics. A model with a
        ``quant_mode`` other than "off" does not train (``ValueError``);
        JAX's trainer never builds one."""
        if self.quant_mode != "off":
            raise ValueError(f"quant_mode {self.quant_mode!r} is eval only")
        return self._forward(x, train=True, generator=generator,
                             bn_stats=batch_stats, bn_group=bn_group,
                             space_group=space_group)

    def _block(self, block, x, train: bool, space_group=None):
        if train and self.remat:
            # activation checkpointing (JAX nn.remat on each DoubleConv);
            # on a slab the backward replays the block's exchanges and
            # all-reduces, in the same order on every rank
            return checkpoint(block, x, space_group, use_reentrant=False)
        return block(x, space_group)

    def check_slab(self, depth: int, ranks: int) -> None:
        """Refuse what the slab forward cannot run: a slab ``depth`` whose
        pools would leave an odd depth before the bottleneck (the global
        depth must be a multiple of ``ranks * 2^len(features)``); the
        ps2d regions' pools and K2's doubling need no more."""
        n = len(self.features)
        if depth % 2 ** n:
            raise ValueError(
                f"a D slab of {depth} planes over {ranks} ranks: the global "
                f"depth {depth * ranks} must be a multiple of space * "
                f"2^{n} = {ranks * 2 ** n}")

    def _deep(self, i: int, x, full, space_group=None):
        """Deep-supervision head i (train only), at its level's scale or
        resized to the input's (``full``, the whole volume's shape). On
        a D slab the head at 1/f of the depth is extended by one
        edge-clamped plane of each neighbour, resized by f (JAX's
        half-pixel linear resize reads no further) and cropped by f
        planes each side: the slab of the whole volume's resize."""
        d = getattr(self, f"deep{i}")(x)
        if not self.deep_sup_full_res:
            return d
        if space_group is None:
            return resize_trilinear(d, full)
        n = d.shape[1]
        f = full[0] // (n * dist.get_world_size(space_group))
        if f == 1:
            return resize_trilinear(d, (n,) + tuple(full[1:]))
        ext = halo_exchange_d(d, 1, space_group, "edge")
        return resize_trilinear(ext, ((n + 2) * f,) + tuple(full[1:]))[
            :, f:-f]

    def _forward(self, x, train: bool, generator=None, bn_stats=None,
                 bn_group=None, space_group=None):
        feats = self.features
        n = len(feats)
        sg = space_group
        x = x.to(self.compute_dtype)
        full = tuple(x.shape[1:4])
        if sg is not None:
            k = dist.get_world_size(sg)
            self.check_slab(full[0], k)
            full = (full[0] * k,) + full[1:]
        if min(full) < 2 ** n:
            raise ValueError(f"input spatial dims {full} too small for {n} "
                             f"encoder levels (need >= {2 ** n})")
        # at train only level 0 can be a region (JAX: level 1 is
        # eval-only); its blocks are not checkpointed, as JAX's are not:
        # a checkpointed region would replay its three K1 forwards in the
        # backward (10 launches a step instead of 3 + 4)
        halo = (self._halo_levels(full, self.ps2d_train, 1) if train
                else self.halo_levels(full))
        skips, deep = [], []
        for i in range(n):
            block = getattr(self, f"down{i}")
            if i < halo and train:
                x = block.forward_entry_train(x, sg)
                skips.append(x)
                x = halo_to_normal(x)
                if i < n - 1:
                    deep.append(self._deep(i, x, full, sg))
                x = max_pool3d(x)
            elif i < halo:
                # the skip stays in the halo layout until its decoder
                # stage; level 0 pools straight into the level-1 halo
                # layout (K4) when level 1 is a region too
                x = (block.forward_entry(x, sg) if i == 0
                     else block.forward_halo((x,), space_group=sg))
                skips.append(x)
                x = (pool_into_halo(x) if i + 1 < halo
                     else max_pool3d_from_halo(x))
            else:
                x = self._block(block, x, train, sg)
                skips.append(x)
                if train and i < n - 1:
                    deep.append(self._deep(i, x, full, sg))
                x = max_pool3d(x)
            if train:
                # channel dropout: one mask value per (batch, channel)
                x = dropout(x, self.dropout_rate, generator, (1, 2, 3))
        x = self._block(self.bottleneck, x, train, sg)
        bottleneck = x
        for i in range(n):
            skip = skips[-(i + 1)]
            up, att, dec = (getattr(self, f"{p}{i}")
                            for p in ("up", "att", "dec"))
            if n - 1 - i < halo and train:
                # the library up into the halo layout; the gate applied
                # as plain ops, then both convs on K6
                up_h = up.halo_train(x)
                skip_g = att.forward_halo(g=up_h, x=skip, space_group=sg)
                x = halo_to_normal(dec.forward_halo_train((skip_g, up_h),
                                                          sg))
            elif n - 1 - i < halo:
                # halo_levels' gate makes the up double back exactly
                up_h = up_k2s2_into_halo(x, up.kernel, up.bias)
                gate = att.fold_halo(g=up_h, x=skip, space_group=sg)
                x = halo_to_normal(dec.forward_halo((skip, up_h), gate, sg))
            else:
                x = up(x)
                x_att = att(g=x, x=skip, space_group=sg)
                if x.shape[1:4] != skip.shape[1:4]:
                    x = resize_trilinear(x, skip.shape[1:4])
                x = self._block(dec, torch.cat([x_att, x], dim=-1), train,
                                sg)
        h = self.head_conv(x, sg)
        new_stats = None
        if train:
            # f32 batch statistics (JAX: BatchNorm in f32 at train)
            h, new_stats = self.head_bn.train_stats(h, bn_stats, bn_group)
            h = torch.relu(h).to(self.compute_dtype)
        else:
            h = torch.relu(self.head_bn(h))
        return {"logits": self.head_out(h).float(), "deep": deep,
                "bottleneck": bottleneck, "batch_stats": new_stats}
