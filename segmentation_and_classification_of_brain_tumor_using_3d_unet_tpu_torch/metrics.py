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


def class_counts(pred_labels: torch.Tensor, target_labels: torch.Tensor,
                 num_classes: int = 4) -> torch.Tensor:
    """(3, num_classes) f32: per class id, the voxels of the intersection,
    of the prediction and of the target. Counts of a batch split over
    ranks add up to the whole batch's."""
    ids = torch.arange(num_classes, device=pred_labels.device)
    p = (pred_labels.reshape(-1, 1) == ids).float()
    t = (target_labels.reshape(-1, 1) == ids).float()
    return torch.stack([(p * t).sum(0), p.sum(0), t.sum(0)])


def dice_of_counts(counts: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Hard Dice per class from ``class_counts``."""
    return (2.0 * counts[0]) / (counts[1] + counts[2] + eps)


def per_class_dice(pred_labels: torch.Tensor, target_labels: torch.Tensor,
                   num_classes: int = 4, eps: float = 1e-8) -> torch.Tensor:
    """Hard Dice per class id, (num_classes,) (index 0 = background)."""
    return dice_of_counts(class_counts(pred_labels, target_labels,
                                       num_classes), eps)


def mean_foreground_dice(logits_or_labels: torch.Tensor,
                         target_labels: torch.Tensor,
                         num_classes: int = 4) -> torch.Tensor:
    """Mean hard Dice over classes 1..num_classes-1; takes channels-last
    logits (argmaxed here) or integer labels."""
    x = logits_or_labels
    if x.ndim == target_labels.ndim + 1:
        x = x.argmax(-1)
    return per_class_dice(x, target_labels, num_classes)[1:].mean()


def region_counts(pred_labels: torch.Tensor, target_labels: torch.Tensor,
                  regions: Mapping[str, Sequence[int]] = BRATS_REGIONS
                  ) -> torch.Tensor:
    """(3, len(regions)) f32: per composite region, the voxels of the
    intersection, of the prediction and of the target."""
    def member(labels, ids):
        m = torch.zeros_like(labels, dtype=torch.bool)
        for i in ids:
            m |= labels == i
        return m.float()

    cols = []
    for ids in regions.values():
        p, t = member(pred_labels, ids), member(target_labels, ids)
        cols.append(torch.stack([(p * t).sum(), p.sum(), t.sum()]))
    return torch.stack(cols, dim=1)


def region_dice_of_counts(counts: torch.Tensor,
                          regions: Mapping[str, Sequence[int]]
                          = BRATS_REGIONS,
                          smooth: float = 1e-6) -> Dict[str, torch.Tensor]:
    """Region Dice from ``region_counts`` (``dice_coefficient``'s
    smoothing)."""
    dice = (2.0 * counts[0] + smooth) / (counts[1] + counts[2] + smooth)
    return dict(zip(regions, dice))


def region_dice(pred_labels: torch.Tensor, target_labels: torch.Tensor,
                regions: Mapping[str, Sequence[int]] = BRATS_REGIONS
                ) -> Dict[str, torch.Tensor]:
    """Composite region Dice (WT / TC / ET over the remapped labels)."""
    return region_dice_of_counts(
        region_counts(pred_labels, target_labels, regions), regions)


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


class LossMetrics:
    """Sigmoid-based binary loss variants (JAX ``LossMetrics``); logits
    and one-hot targets are channels-last (B, D, H, W, C) arrays or
    tensors."""

    @staticmethod
    def dice_loss(logits, targets, smooth: float = 1e-6) -> torch.Tensor:
        p = torch.sigmoid(torch.as_tensor(logits).float())
        t = torch.as_tensor(targets).float()
        axes = tuple(range(1, p.ndim - 1))
        inter = (p * t).sum(axes)
        union = p.sum(axes) + t.sum(axes)
        return 1.0 - ((2.0 * inter + smooth) / (union + smooth)).mean()

    @staticmethod
    def focal_loss(logits, targets, alpha: float = 0.25,
                   gamma: float = 2.0) -> torch.Tensor:
        from .losses import focal_loss
        return focal_loss(torch.as_tensor(logits),
                          torch.as_tensor(targets).long(), alpha, gamma)

    @staticmethod
    def combined_loss(logits, targets, dice_weight: float = 0.5,
                      focal_weight: float = 0.5,
                      focal_targets=None) -> torch.Tensor:
        """dice_weight * sigmoid Dice + focal_weight * focal;
        ``focal_targets`` (integer labels) defaults to the argmax of the
        one-hot targets."""
        d = LossMetrics.dice_loss(logits, targets)
        ft = (torch.as_tensor(targets).argmax(-1) if focal_targets is None
              else focal_targets)
        return dice_weight * d + focal_weight * LossMetrics.focal_loss(
            logits, ft)


def _float_of(fn):
    """A binary metric on arrays or tensors, as a Python float."""
    return staticmethod(lambda pred, target, smooth=1e-6: float(fn(
        torch.as_tensor(pred), torch.as_tensor(target), smooth)))


class SegmentationMetrics:
    """Static-method facade of the binary metrics (JAX
    ``SegmentationMetrics``), each returning a Python float."""

    dice_coefficient = _float_of(dice_coefficient)
    iou_score = _float_of(iou_score)
    sensitivity = _float_of(sensitivity)
    specificity = _float_of(specificity)
    hausdorff_distance = staticmethod(hausdorff_distance)
    compute_all_metrics = staticmethod(
        lambda pred, target: compute_all_metrics(torch.as_tensor(pred),
                                                 torch.as_tensor(target)))
