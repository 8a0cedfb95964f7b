"""Joint segmentation + tumour-grade model, eval forward (counterpart
of the JAX package's ``models/joint.py``): the ``UNet3D`` trunk, then a
grade head on the global-average-pooled bottleneck and the log of the
trunk's own predicted tumour burden.

The trunk runs the normal path, as the JAX joint model's does (it sets
no ps2d flag). The joint loss and ``grade_from_volume`` belong to
training and come with it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.pool import global_avg_pool
from .classifier import Dense
from .unet3d import UNet3D


class UNet3DWithClassifier(nn.Module):
    """``forward(x)`` -> {"logits": (B, D, H, W, out) f32,
    "grade_logits": (B, num_grades) f32}."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 num_grades: int = 4,
                 features: Sequence[int] = (32, 64, 128, 256, 512),
                 seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.unet = UNet3D(in_channels, out_channels, features, seed=seed,
                           device=dev)
        gen = torch.Generator().manual_seed(seed + 1)
        # GAP'd bottleneck (2 * features[-1]) + log burden of each
        # tumour class (out - 1) + log foreground fraction (1)
        self.grade_fc1 = Dense(2 * features[-1] + out_channels, 256, gen)
        self.grade_out = Dense(256, num_grades, gen)
        self.to(dev)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits, bottleneck = self.unet.forward_with_bottleneck(x)
        h = global_avg_pool(bottleneck).reshape(x.shape[0], -1)   # bf16
        probs = torch.softmax(logits, dim=-1)
        burden = probs[..., 1:].mean((1, 2, 3))                   # (B, C-1)
        # foreground fraction of the trunk's own argmax mask
        hard = (logits.argmax(-1) > 0).float().mean((1, 2, 3))[:, None]
        feats = torch.log(torch.cat([burden, hard], dim=-1) + 1e-6)
        h = torch.cat([h, feats.to(h.dtype)], dim=-1)
        grade = self.grade_out(torch.relu(self.grade_fc1(h)))
        return {"logits": logits, "grade_logits": grade.float()}
