"""Segmentation metrics (counterpart of the JAX package's ``metrics.py``).

The binary metrics (Dice, IoU, sensitivity, specificity at threshold
0.5, smooth 1e-6), the per-class and region Dice of the train and eval
steps each return a float32 tensor on their input's device, with no
host synchronisation. The Hausdorff distances run on the host, on
scipy's exact Euclidean distance transform, as JAX's do, and return
Python floats.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
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


def iou_score(pred: torch.Tensor, target: torch.Tensor,
              smooth: float = 1e-6) -> torch.Tensor:
    p, t = _binarize(pred), _binarize(target)
    inter = (p * t).sum()
    union = p.sum() + t.sum() - inter
    return (inter + smooth) / (union + smooth)


def sensitivity(pred: torch.Tensor, target: torch.Tensor,
                smooth: float = 1e-6) -> torch.Tensor:
    p, t = _binarize(pred), _binarize(target)
    tp = (p * t).sum()
    fn = ((1.0 - p) * t).sum()
    return (tp + smooth) / (tp + fn + smooth)


def specificity(pred: torch.Tensor, target: torch.Tensor,
                smooth: float = 1e-6) -> torch.Tensor:
    p, t = _binarize(pred), _binarize(target)
    tn = ((1.0 - p) * (1.0 - t)).sum()
    fp = (p * (1.0 - t)).sum()
    return (tn + smooth) / (tn + fp + smooth)


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


# ---------------------------------------------------------------------------
# Hausdorff distance: exact EDT on the host (scipy), HD95 included
# ---------------------------------------------------------------------------

def _host_mask(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x) > 0.5


def _edt(mask: np.ndarray, spacing: Sequence[float]) -> np.ndarray:
    """Exact Euclidean distance to ``mask`` (host, scipy)."""
    from scipy import ndimage
    if not mask.any():
        return np.full(mask.shape, np.inf, np.float32)
    return ndimage.distance_transform_edt(~mask, sampling=spacing)


def hausdorff_distance(pred, target,
                       spacing: Sequence[float] = (1.0, 1.0, 1.0),
                       percentile: float = 100.0) -> float:
    """Symmetric (percentile-)Hausdorff distance between binary masks
    (tensors or arrays): percentile 100 is the max of the directed
    distances, 95 the BraTS HD95; ``inf`` when either mask is empty."""
    p, t = _host_mask(pred), _host_mask(target)
    if not p.any() or not t.any():
        return float("inf")
    if len(tuple(spacing)) != p.ndim:
        spacing = (1.0,) * p.ndim   # e.g. batched masks: isotropic default
    d_t = _edt(t, spacing)[p]      # distances from pred surface to target
    d_p = _edt(p, spacing)[t]
    if percentile >= 100.0:
        return float(max(d_t.max(), d_p.max()))
    return float(max(np.percentile(d_t, percentile),
                     np.percentile(d_p, percentile)))


def hausdorff_distance_95(pred, target,
                          spacing: Sequence[float] = (1.0, 1.0, 1.0)
                          ) -> float:
    return hausdorff_distance(pred, target, spacing, percentile=95.0)


def compute_all_metrics(pred: torch.Tensor, target: torch.Tensor
                        ) -> Dict[str, float]:
    """The five binary metrics as Python floats (JAX
    ``compute_all_metrics``)."""
    return {
        "dice": float(dice_coefficient(pred, target)),
        "iou": float(iou_score(pred, target)),
        "sensitivity": float(sensitivity(pred, target)),
        "specificity": float(specificity(pred, target)),
        "hausdorff": hausdorff_distance(pred, target),
    }
