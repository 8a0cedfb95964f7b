"""Segmentation losses, counterparts of the JAX package's ``losses.py``.

Logits are channels-last ``(B, D, H, W, C)`` (any float type; every loss
computes in float32), targets integer ``(B, D, H, W)``. Every term
reduces as a per-sample mean, so a loss over microbatches averages to
the loss over their batch (train/loop.py's ``grad_accum``).

``combined_loss``, ``boundary_loss``, ``combined_loss3d`` and
``deep_supervision_loss`` take a ``group`` (the ``space`` group of a
mesh): the logits and targets are then this rank's D slabs, and the Dice
sums, the cross-entropy, focal and boundary sums and the voxel count are
summed over the group by ``parallel.mesh.replica_sum``, so every rank
holds the whole volume's loss, and each rank's backward of it gives that
rank's share of the gradient (summed over the group by the train step).
The boundary term's D difference at a slab's last plane takes the next
slab's first plane (``parallel.spatial.halo_exchange_d``).

  * ``combined_loss`` — the trainer criterion, 0.5 dice + 0.3 CE + 0.2
    focal, all three from ONE log-softmax;
  * ``combined_loss3d`` — 0.5 dice + 0.3 focal(0.25, 2) + 0.2 boundary,
    returning ``(loss, parts)``; ``tversky_loss``;
  * ``deep_supervision_loss`` — the main output and the deep heads,
    weighted; a head at its native scale is held against the targets
    nearest-resized to it (bit-exact with JAX's resize);
  * the class shims of the JAX module.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from .ops.resize import resize_nearest

SPATIAL = (1, 2, 3)   # D, H, W of (B, D, H, W, C)


def _one_hot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in float32: a comparison with every class id,
    so an id outside [0, num_classes) is an all-zero row."""
    ids = torch.arange(num_classes, device=targets.device)
    return (targets[..., None] == ids).float()


def softmax_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                      smooth: float = 1e-6) -> torch.Tensor:
    """1 - mean over (batch, class) of the soft Dice over D, H, W."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _one_hot(targets, logits.shape[-1])
    inter = (probs * onehot).sum(SPATIAL)
    union = probs.sum(SPATIAL) + onehot.sum(SPATIAL)
    return 1.0 - ((2.0 * inter + smooth) / (union + smooth)).mean()


def _ce_map(logp: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Per-voxel cross-entropy from log-probabilities: a dense pick
    through the one-hot, as JAX takes it."""
    return -(logp * onehot).sum(-1)


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _ce_map(logp, _one_hot(targets, logits.shape[-1])).mean()


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 1.0, gamma: float = 2.0) -> torch.Tensor:
    """``alpha * (1 - pt)^gamma * CE``, averaged."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = _ce_map(logp, _one_hot(targets, logits.shape[-1]))
    pt = torch.exp(-ce)
    return (alpha * (1.0 - pt) ** gamma * ce).mean()


def combined_loss(logits: torch.Tensor, targets: torch.Tensor,
                  weights: Sequence[float] = (0.5, 0.3, 0.2),
                  focal_alpha: float = 1.0,
                  focal_gamma: float = 2.0, group=None) -> torch.Tensor:
    """w0 * dice + w1 * CE + w2 * focal from one log-softmax: the dice
    probabilities are exp(logp), the focal term reuses the CE map.
    ``group``: over D slabs (the module's docstring)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    probs = torch.exp(logp)
    onehot = _one_hot(targets, logits.shape[-1])
    inter = (probs * onehot).sum(SPATIAL)
    union = probs.sum(SPATIAL) + onehot.sum(SPATIAL)
    ce_map = _ce_map(logp, onehot)
    pt = torch.exp(-ce_map)
    focal_map = focal_alpha * (1.0 - pt) ** focal_gamma * ce_map
    if group is None:
        ce, focal = ce_map.mean(), focal_map.mean()
    else:
        from .parallel.mesh import replica_sum
        n = inter.numel()
        count = torch.full((1,), float(ce_map.numel()), device=ce_map.device)
        s = replica_sum(torch.cat([inter.reshape(-1), union.reshape(-1),
                                   ce_map.sum()[None], focal_map.sum()[None],
                                   count]), group)
        inter, union = s[:n].view_as(inter), s[n:2 * n].view_as(union)
        ce, focal = s[2 * n] / s[-1], s[2 * n + 1] / s[-1]
    dice = 1.0 - ((2.0 * inter + 1e-6) / (union + 1e-6)).mean()
    return weights[0] * dice + weights[1] * ce + weights[2] * focal


def _boundary_sq(probs: torch.Tensor, onehot: torch.Tensor,
                 group=None) -> torch.Tensor:
    """The map boundary_loss averages: the squared difference of the
    gradient magnitudes of the softmax and of the one-hot (this rank's
    slab of it over a ``group``). Each axis's forward difference takes
    one plane past the end: along D the next slab's first plane, past
    the volume's end the last plane repeated ("edge"), as along H and W,
    whose difference is 0, as JAX's pad of the whole volume's."""
    from .parallel.spatial import halo_exchange_d
    both = torch.cat([probs, onehot], dim=-1)
    total = torch.zeros_like(both)
    for ax in SPATIAL:
        if ax == 1:
            ext = halo_exchange_d(both, 1, group, "edge")[:, 1:]
        else:
            ext = torch.cat([both, both.narrow(ax, both.shape[ax] - 1, 1)],
                            dim=ax)
        total = total + torch.diff(ext, dim=ax).abs()
    gp, go = total.split(probs.shape[-1], dim=-1)
    return (gp - go).square()


def boundary_loss(logits: torch.Tensor, targets: torch.Tensor,
                  group=None) -> torch.Tensor:
    """MSE between the forward-difference gradient magnitudes of the
    softmax and of the one-hot targets (the last row of each axis gets
    a zero difference). ``group``: over D slabs (the module's
    docstring)."""
    probs = torch.softmax(logits.float(), dim=-1)
    sq = _boundary_sq(probs, _one_hot(targets, logits.shape[-1]), group)
    if group is None:
        return sq.mean()
    from .parallel.mesh import replica_sum
    s = replica_sum(torch.stack([sq.sum(), torch.tensor(
        float(sq.numel()), device=sq.device)]), group)
    return s[0] / s[1]


def combined_loss3d(logits: torch.Tensor, targets: torch.Tensor,
                    alpha: float = 0.5, beta: float = 0.3,
                    gamma: float = 0.2, smooth: float = 1e-5, group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """alpha * dice + beta * focal(0.25, 2) + gamma * boundary, and the
    parts, each the value of its own function. ``group``: over D slabs
    (the module's docstring), the three terms' sums in one
    ``replica_sum``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _one_hot(targets, logits.shape[-1])
    inter = (probs * onehot).sum(SPATIAL)
    union = probs.sum(SPATIAL) + onehot.sum(SPATIAL)
    ce = _ce_map(logp, onehot)
    focal_map = 0.25 * (1.0 - torch.exp(-ce)) ** 2.0 * ce
    sq = _boundary_sq(probs, onehot, group)
    if group is None:
        focal, boundary = focal_map.mean(), sq.mean()
    else:
        from .parallel.mesh import replica_sum
        n = inter.numel()
        count = torch.full((1,), float(ce.numel()), device=ce.device)
        s = replica_sum(torch.cat([inter.reshape(-1), union.reshape(-1),
                                   focal_map.sum()[None], sq.sum()[None],
                                   count]), group)
        inter, union = s[:n].view_as(inter), s[n:2 * n].view_as(union)
        focal = s[2 * n] / s[-1]
        boundary = s[2 * n + 1] / (s[-1] * logits.shape[-1])
    dice = 1.0 - ((2.0 * inter + smooth) / (union + smooth)).mean()
    total = alpha * dice + beta * focal + gamma * boundary
    return total, {"dice_loss": dice, "focal_loss": focal,
                   "boundary_loss": boundary, "total_loss": total}


def tversky_loss(logits: torch.Tensor, targets: torch.Tensor,
                 alpha: float = 0.7, beta: float = 0.3,
                 smooth: float = 1e-5) -> torch.Tensor:
    """Tversky index loss; alpha weights false positives, beta false
    negatives."""
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _one_hot(targets, logits.shape[-1])
    tp = (probs * onehot).sum(SPATIAL)
    fp = (probs * (1.0 - onehot)).sum(SPATIAL)
    fn = ((1.0 - probs) * onehot).sum(SPATIAL)
    tv = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return 1.0 - tv.mean()


def deep_supervision_loss(logits: torch.Tensor, deep_logits,
                          targets: torch.Tensor,
                          weights: Sequence[float] = (1.0, 0.8, 0.6, 0.4),
                          loss_fn: Callable = combined_loss
                          ) -> torch.Tensor:
    """``weights[0]`` times the main loss plus ``weights[i + 1]`` times
    deep head i's; heads past the weights get none (the fourth head of
    a five-level net is computed but unweighted). A head whose spatial
    shape is not the targets' is held against the targets
    nearest-resized to it. On D slabs (``loss_fn`` reducing over a
    ``space`` group) the slab's targets are resized: a halving resize
    picks, for each output plane, a plane of its own pair, so the
    resized slab is the slab of the resized targets while every slab's
    depth is even."""
    total = weights[0] * loss_fn(logits, targets)
    for i, d in enumerate(deep_logits):
        if i + 1 >= len(weights):
            break
        t = targets
        if tuple(d.shape[1:-1]) != tuple(targets.shape[1:]):
            t = resize_nearest(targets[..., None], d.shape[1:-1])[..., 0]
        total = total + weights[i + 1] * loss_fn(d, t)
    return total


# ---------------------------------------------------------------------------
# Class-style shims of the JAX module's public surface.
# ---------------------------------------------------------------------------

class DiceLoss:
    def __init__(self, smooth: float = 1e-6):
        self.smooth = smooth

    def __call__(self, logits, targets):
        return softmax_dice_loss(logits, targets, self.smooth)


class FocalLoss:
    def __init__(self, alpha: float = 1.0, gamma: float = 2.0):
        self.alpha, self.gamma = alpha, gamma

    def __call__(self, logits, targets):
        return focal_loss(logits, targets, self.alpha, self.gamma)


class CombinedLoss:
    def __init__(self, weights: Sequence[float] = (0.5, 0.3, 0.2)):
        self.weights = tuple(weights)

    def __call__(self, logits, targets):
        return combined_loss(logits, targets, self.weights)


class CombinedLoss3D:
    def __init__(self, alpha=0.5, beta=0.3, gamma=0.2, smooth=1e-5):
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.smooth = smooth

    def __call__(self, logits, targets):
        return combined_loss3d(logits, targets, self.alpha, self.beta,
                               self.gamma, self.smooth)


class TverskyLoss3D:
    def __init__(self, alpha=0.7, beta=0.3, smooth=1e-5):
        self.alpha, self.beta, self.smooth = alpha, beta, smooth

    def __call__(self, logits, targets):
        return tversky_loss(logits, targets, self.alpha, self.beta,
                            self.smooth)


class DeepSupervisionLoss3D:
    def __init__(self, weights: Sequence[float] = (1.0, 0.8, 0.6, 0.4),
                 loss_fn: Callable = None):
        self.weights = tuple(weights)
        inner = loss_fn or CombinedLoss3D()
        # CombinedLoss3D returns (loss, parts); the weighted sum takes
        # the loss
        self._fn = (lambda lg, tg: inner(lg, tg)[0]) if isinstance(
            inner, CombinedLoss3D) else inner

    def __call__(self, predictions, targets):
        if isinstance(predictions, dict):
            return deep_supervision_loss(
                predictions["logits"], predictions.get("deep", []),
                targets, self.weights, self._fn)
        if isinstance(predictions, tuple):
            return deep_supervision_loss(
                predictions[0], predictions[1], targets, self.weights,
                self._fn)
        return self._fn(predictions, targets)
