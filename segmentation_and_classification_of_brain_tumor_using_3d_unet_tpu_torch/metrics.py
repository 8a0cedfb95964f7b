"""Segmentation metrics on the device: the Dice parts of the JAX
package's ``metrics.py`` (the train and eval steps' metrics). Every
function returns a float32 tensor on its input's device, with no host
synchronisation.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from .config import BRATS_REGIONS


def _binarize(x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return (x > threshold).float()


def dice_coefficient(pred: torch.Tensor, target: torch.Tensor,
                     smooth: float = 1e-6) -> torch.Tensor:
    """Binary Dice at threshold 0.5."""
    p, t = _binarize(pred), _binarize(target)
    inter = (p * t).sum()
    return (2.0 * inter + smooth) / (p.sum() + t.sum() + smooth)


def per_class_dice(pred_labels: torch.Tensor, target_labels: torch.Tensor,
                   num_classes: int = 4, eps: float = 1e-8) -> torch.Tensor:
    """Hard Dice per class id, (num_classes,) (index 0 = background)."""
    ids = torch.arange(num_classes, device=pred_labels.device)
    p = (pred_labels.reshape(-1, 1) == ids).float()
    t = (target_labels.reshape(-1, 1) == ids).float()
    inter = (p * t).sum(0)
    return (2.0 * inter) / (p.sum(0) + t.sum(0) + eps)


def mean_foreground_dice(logits_or_labels: torch.Tensor,
                         target_labels: torch.Tensor,
                         num_classes: int = 4) -> torch.Tensor:
    """Mean hard Dice over classes 1..num_classes-1; takes channels-last
    logits (argmaxed here) or integer labels."""
    x = logits_or_labels
    if x.ndim == target_labels.ndim + 1:
        x = x.argmax(-1)
    return per_class_dice(x, target_labels, num_classes)[1:].mean()


def region_dice(pred_labels: torch.Tensor, target_labels: torch.Tensor,
                regions: Mapping[str, Sequence[int]] = BRATS_REGIONS
                ) -> Dict[str, torch.Tensor]:
    """Composite region Dice (WT / TC / ET over the remapped labels)."""
    def member(labels, ids):
        m = torch.zeros_like(labels, dtype=torch.bool)
        for i in ids:
            m |= labels == i
        return m.float()

    return {name: dice_coefficient(member(pred_labels, ids),
                                   member(target_labels, ids))
            for name, ids in regions.items()}
