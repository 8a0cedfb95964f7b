"""Joint segmentation + tumour-grade model (counterpart of the JAX
package's ``models/joint.py``): the ``UNet3D`` trunk, then a grade head
on the global-average-pooled bottleneck and the log of the trunk's own
predicted tumour burden; ``joint_loss`` and ``grade_from_volume``.

The trunk runs the normal path, as the JAX joint model's does (it sets
no ps2d flag); ``compute_dtype`` is the trunk's and the head's (JAX's
``dtype``). With a ``space_group`` the trunk runs on this rank's D slab
and the head's pooling and burden features are the whole volume's, the
same on every rank of the group.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.conv import BF16, set_compute_dtype
from ..ops.dropout import dropout
from ..ops.pool import global_avg_pool
from ..parallel.mesh import all_reduce_
from .classifier import Dense
from .unet3d import UNet3D


class UNet3DWithClassifier(nn.Module):
    """``forward(x)`` -> {"logits": (B, D, H, W, out) f32,
    "grade_logits": (B, num_grades) f32} (eval, no gradients);
    ``forward_train(x, generator)`` the trunk's train outputs plus
    "grade_logits", with the grade head's Dropout(0.3)."""

    grade_dropout = 0.3

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 num_grades: int = 4,
                 features: Sequence[int] = (32, 64, 128, 256, 512),
                 seed: int = 0, device="cuda", dropout_rate: float = 0.2,
                 remat: bool = False, compute_dtype=BF16):
        super().__init__()
        dev = resolve_device(device)
        self.unet = UNet3D(in_channels, out_channels, features, seed=seed,
                           device=dev, dropout_rate=dropout_rate,
                           remat=remat, compute_dtype=compute_dtype)
        gen = torch.Generator().manual_seed(seed + 1)
        # GAP'd bottleneck (2 * features[-1]) + log burden of each
        # tumour class (out - 1) + log foreground fraction (1)
        self.grade_fc1 = Dense(2 * features[-1] + out_channels, 256, gen)
        self.grade_out = Dense(256, num_grades, gen)
        self.compute_dtype = set_compute_dtype(self, compute_dtype)
        self.to(dev)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, space_group=None
                ) -> Dict[str, torch.Tensor]:
        logits, bottleneck = self.unet.forward_with_bottleneck(x,
                                                               space_group)
        grade = self._grade(logits, bottleneck, space_group=space_group)
        return {"logits": logits, "grade_logits": grade}

    def forward_train(self, x: torch.Tensor, generator,
                      batch_stats=None, bn_group=None, space_group=None
                      ) -> Dict[str, torch.Tensor]:
        out = self.unet.forward_train(x, generator, batch_stats, bn_group,
                                      space_group)
        # the burden features read the logits without their gradient
        # (JAX stop_gradient): grade-CE reaches the trunk through the
        # pooled bottleneck only
        out["grade_logits"] = self._grade(out["logits"].detach(),
                                          out["bottleneck"], True, generator,
                                          space_group)
        return out

    def _grade(self, logits, bottleneck, train=False, generator=None,
               space_group=None):
        """Grade logits f32; at train, dropout on the hidden layer."""
        h = global_avg_pool(bottleneck, space_group).reshape(
            logits.shape[0], -1)
        probs = torch.softmax(logits, dim=-1)
        # foreground fraction of the trunk's own argmax mask
        fg = (logits.argmax(-1) > 0).float()
        if space_group is None:
            burden = probs[..., 1:].mean((1, 2, 3))               # (B, C-1)
            hard = fg.mean((1, 2, 3))[:, None]
        else:
            s = torch.cat([probs[..., 1:].sum((1, 2, 3)),
                           fg.sum((1, 2, 3))[:, None]], dim=-1)
            count = float(fg[0].numel()
                          * torch.distributed.get_world_size(space_group))
            s = all_reduce_(s, space_group) / count
            burden, hard = s[:, :-1], s[:, -1:]
        feats = torch.log(torch.cat([burden, hard], dim=-1) + 1e-6)
        h = torch.cat([h, feats.to(h.dtype)], dim=-1)
        h = torch.relu(self.grade_fc1(h))
        if train:
            h = dropout(h, self.grade_dropout, generator)
        return self.grade_out(h).float()


def joint_loss(out: Dict, seg_targets: torch.Tensor,
               grade_targets: torch.Tensor, seg_loss_fn: Callable,
               cls_weight: float = 0.3):
    """seg loss (deep supervision included) + ``cls_weight`` * grade CE
    -> (loss, {"seg_loss", "grade_ce"})."""
    seg_loss = seg_loss_fn(out, seg_targets)
    logp = torch.log_softmax(out["grade_logits"], dim=-1)
    ids = torch.arange(logp.shape[-1], device=logp.device)
    onehot = (grade_targets[..., None] == ids).to(logp.dtype)
    ce = -(logp * onehot).sum(-1).mean()
    return seg_loss + cls_weight * ce, {"seg_loss": seg_loss,
                                        "grade_ce": ce}


def grade_from_volume(tumor_voxels, total_voxels) -> torch.Tensor:
    """Synthetic grade label from the tumour burden (the clinical volume
    ladder): 0 none/benign .. 3 high-grade, int32."""
    t = torch.as_tensor(tumor_voxels)
    frac = t / max(int(total_voxels), 1)
    return ((frac > 0.001).int() + (frac > 0.01).int()
            + (frac > 0.05).int())
