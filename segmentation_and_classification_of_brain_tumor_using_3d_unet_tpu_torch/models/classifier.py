"""3-D CNN tumour classifier (counterpart of the JAX package's
``models/classifier.py``): three 3x3x3 convs 4->32->64->128 with ReLU, a
2x2x2 max pool after the first two, an adaptive average pool to 4^3,
then fc 8192->512 (ReLU) -> Dropout(0.5) in train mode -> num_classes,
computed in ``compute_dtype`` (bf16 by default, or f32; JAX's ``dtype``).

Tensors are NDHWC, as in JAX, so the flatten before ``fc1`` takes the
(d, h, w, c) order that ``fc1``'s weights were made for.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.conv import (BF16, FastConv3D, conv3d_zcat, matmul,
                        set_compute_dtype)
from ..ops.dropout import dropout
from ..ops.pool import max_pool3d
from ..ops.resize import adaptive_avg_pool


class Dense(nn.Module):
    """Fully connected layer (flax ``nn.Dense``) in ``compute_dtype``:
    f32 accumulation, one rounding, bias added in that dtype. ``weight`` is
    (out, in), as ``torch.nn.Linear`` keeps it (the weight bridge
    transposes flax's (in, out) kernel); made lecun-normal from
    ``generator``, bias zero, as flax initialises."""

    compute_dtype = BF16

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn((features, cin), generator=generator)
            * math.sqrt(1.0 / cin))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dt = self.compute_dtype
        return matmul(x, self.weight.t(), dt) + self.bias.to(dt)


class BrainTumorClassifier(nn.Module):
    """``forward(x)``: x (B, D, H, W, in_channels), D, H, W at least
    16 -> logits (B, num_classes) f32 (eval, no gradients);
    ``forward_train(x, generator)`` the same with dropout, with
    gradients."""

    dropout_rate = 0.5

    def __init__(self, in_channels: int = 4, num_classes: int = 4,
                 seed: int = 0, device="cuda", compute_dtype=BF16):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = FastConv3D(in_channels, 32, use_bias=True,
                                generator=gen)
        self.conv2 = FastConv3D(32, 64, use_bias=True, generator=gen)
        self.conv3 = FastConv3D(64, 128, use_bias=True, generator=gen)
        self.fc1 = Dense(4 * 4 * 4 * 128, 512, gen)
        self.fc2 = Dense(512, num_classes, gen)
        self.compute_dtype = set_compute_dtype(self, compute_dtype)
        self.to(resolve_device(device))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x)

    def forward_train(self, x: torch.Tensor, generator) -> torch.Tensor:
        return self._forward(x, generator, train=True)

    def _forward(self, x, generator=None, train: bool = False):
        dt = self.compute_dtype
        x = x.to(dt)
        for i, conv in enumerate((self.conv1, self.conv2, self.conv3)):
            # flax nn.Conv: a plain SAME conv with its bias, never the
            # ksplit formulation FastConv3D picks for narrow outputs
            x = torch.relu(conv3d_zcat(x, conv.kernel, conv.bias, dt))
            if i < 2:
                x = max_pool3d(x)
        x = adaptive_avg_pool(x, (4, 4, 4))
        x = torch.relu(self.fc1(x.reshape(x.shape[0], -1)))
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return self.fc2(x).float()
