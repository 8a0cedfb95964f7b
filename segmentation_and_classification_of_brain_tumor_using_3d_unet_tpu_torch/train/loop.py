"""Train, joint-train and eval steps (counterpart of the JAX package's
``train/loop.py``).

One step: the train forward (``forward_train``, in the model's compute
dtype), the deep-supervision combined loss, the backward, the AdamW
update, the new BatchNorm statistics and the on-device Dice; the metrics
stay tensors on the device, so a step never waits on the host. JAX jits
the step; here it runs eagerly, and on a CUDA model nothing of it
touches the CPU. An f32 model's steps run with TF32 off, backward
included (``ops.conv.full_f32``).

With a ``mesh`` (``parallel.mesh``), each rank runs the step on its rows
of the global batch, as JAX's partitioned program does on its shard:
the weights are broadcast from the first rank when a step first sees a
model; the head BatchNorm takes its statistics over the ``data`` group;
the gradients are averaged over the group (a few flat buckets) before
the clip, AdamW and EMA, so every rank applies the same update; and the
metrics are the global batch's: every loss term is a per-sample mean and
each rank holds an equal share, so the mean of the ranks' losses is the
global loss, and the Dice scores come from voxel counts summed over the
group. The eval step's labels and Hausdorff distances stay this rank's
rows.

On a mesh whose ``space`` axis is longer than 1 (JAX's
``P("data", "space")``), each rank holds its rows' D slab: the model runs
its slab forward over the ``space`` group, and the losses reduce over
that group (``losses.combined_loss``), so every rank of a ``space``
group holds its rows' whole loss and its backward gives its slab's share
of the gradient. The shares are summed over ``space`` and averaged over
``data`` (one reduction over the whole mesh, divided by the ``data``
size); the head BatchNorm takes its statistics over the whole mesh; the
metrics' counts are summed and the losses averaged over it. The eval
step's Hausdorff distances are the whole volumes' (labels and targets
gathered along D over ``space``); its labels stay this rank's slab.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import Config
from ..ops.conv import BF16, full_f32
from ..losses import combined_loss, deep_supervision_loss
from ..metrics import (class_counts, dice_of_counts, region_counts,
                       region_dice_of_counts)
from ..parallel.mesh import all_gather, all_reduce_, mean_over, replicated
from .state import TrainState, global_norm


def make_loss_fn(config: Config, group=None) -> Callable:
    """``loss_fn(out, targets)``: the combined loss of ``out["logits"]``,
    with deep supervision over ``out["deep"]`` when configured and
    present; ``group``: the ``space`` group of D slabs, over which every
    term reduces."""
    lw = (config.loss.dice_weight, config.loss.ce_weight,
          config.loss.focal_weight)
    base = functools.partial(
        combined_loss, weights=lw, focal_alpha=config.loss.focal_alpha,
        focal_gamma=config.loss.focal_gamma, group=group)

    def loss_fn(out: Dict, targets: torch.Tensor) -> torch.Tensor:
        if config.loss.use_deep_supervision and out["deep"]:
            return deep_supervision_loss(
                out["logits"], out["deep"], targets,
                config.loss.deep_supervision_weights, base)
        return base(out["logits"], targets)

    return loss_fn


def precision(model: torch.nn.Module):
    """The context a step of ``model`` runs in: ``full_f32`` for an f32
    model, none for bf16. The ops open their own sections for the
    forward; autograd's backward runs after those have closed, so the
    step holds one open across it (the ops' sections nested inside only
    count)."""
    if getattr(model, "compute_dtype", BF16) == BF16:
        return contextlib.nullcontext()
    return full_f32()


@dataclass(frozen=True)
class _Groups:
    """A step's groups on a mesh: ``reduce``, the group over which the
    gradients, the metrics and the head BatchNorm's statistics reduce
    (the ``data`` group, or the whole mesh when ``space`` > 1);
    ``space``, the group of a row's D slabs; ``data``, the number of
    data-parallel replicas, which the gradients' sum is divided by."""

    reduce: object = None
    space: object = None
    data: int = 1

    @property
    def replicas(self) -> int:
        """The ranks that hold a replica of each row's loss."""
        return (1 if self.space is None
                else torch.distributed.get_world_size(self.space))

    @property
    def slab(self) -> dict:
        """The model's keyword for the slab forward (none without one)."""
        return {} if self.space is None else {"space_group": self.space}


def _data_parallel(mesh):
    """(``_Groups``, ``sync(state)``): ``sync`` broadcasts the weights
    (and the EMA) of a state's model from the mesh's first rank the first
    time it sees that model."""
    if mesh is None or mesh.whole is None:
        return _Groups(), lambda state: None
    groups = _Groups(mesh.whole, mesh.group("space"),
                     mesh.shape.get("data", 1))
    seen = weakref.WeakSet()

    def sync(state: TrainState) -> None:
        if state.model in seen:
            return
        with torch.no_grad():
            replicated(mesh).place(
                list(state.model.parameters()) + list(state.model.buffers())
                + list((state.ema_params or {}).values()))
        seen.add(state.model)

    return groups, sync


def _reduce_metrics(group, means: Dict[str, torch.Tensor],
                    counts: torch.Tensor):
    """``means`` averaged and ``counts`` summed over ``group`` in one
    collective (unchanged without a group)."""
    if group is None:
        return means, counts
    keys = list(means)
    flat = torch.cat([torch.stack([means[k].float() for k in keys]),
                      counts.reshape(-1).float()])
    all_reduce_(flat, group)
    n = torch.distributed.get_world_size(group)
    return ({k: flat[i] / n for i, k in enumerate(keys)},
            flat[len(keys):].view_as(counts))


def _foreground_dice(counts: torch.Tensor) -> torch.Tensor:
    """Mean hard Dice over classes 1.. of ``class_counts``."""
    return dice_of_counts(counts)[1:].mean()


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d params, zeros for a parameter the loss does not reach
    (the last deep head: computed, unweighted), as JAX's gradient tree
    holds zeros there, so AdamW still decays it."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


def make_train_step(config: Config, num_classes: int = 4,
                    grad_accum: Optional[int] = None,
                    mesh=None) -> Callable:
    """``step(state, batch, generator) -> (state, metrics)``; batch =
    {"image": (B, D, H, W, C), "mask": (B, D, H, W) int}, ``generator``
    on the model's device draws the dropout masks.

    ``grad_accum`` > 1 (default ``config.grad_accum``) runs the batch as
    that many microbatches, one after another: every loss term is a
    per-sample mean and GroupNorm is per sample, so the averaged gradient
    is the full batch's (up to the head BatchNorm's batch statistics,
    which are per microbatch); the BatchNorm statistics advance once per
    microbatch. Activations are held for one microbatch at a time.

    ``mesh``: ``batch`` is this rank's rows of the global batch (see the
    module's docstring); with ``grad_accum`` each rank accumulates its
    microbatches and the gradients are reduced once."""
    groups, sync = _data_parallel(mesh)
    group = groups.reduce
    loss_fn = make_loss_fn(config, groups.space)
    accum = config.grad_accum if grad_accum is None else grad_accum

    def micro_grads(state, images, targets, generator, bn_stats):
        params = list(state.model.parameters())
        out = state.model.forward_train(images, generator,
                                        batch_stats=bn_stats, bn_group=group,
                                        **groups.slab)
        loss = loss_fn(out, targets)
        return (loss.detach(), _grads(loss, params),
                out["logits"].detach(), out["batch_stats"])

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        sync(state)
        images, targets = batch["image"], batch["mask"]
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum "
                             f"{accum}")
        mb = b // accum
        bn_stats, gsum, lsum, counts = None, None, 0.0, []
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            with precision(state.model):
                loss, grads, logits, bn_stats = micro_grads(
                    state, images[sl], targets[sl], generator, bn_stats)
            gsum = grads if gsum is None else [
                a + g for a, g in zip(gsum, grads)]
            lsum = lsum + loss
            counts.append(class_counts(logits.argmax(-1), targets[sl],
                                       num_classes))
        grads = mean_over([g / accum for g in gsum] if accum > 1 else gsum,
                          group, groups.data)
        means, counts = _reduce_metrics(group, {"loss": lsum / accum},
                                        torch.stack(counts))
        dsum = sum(_foreground_dice(c) for c in counts)
        metrics = {"loss": means["loss"], "dice": dsum / accum,
                   "grad_norm": global_norm(grads)}
        state.apply_gradients(grads, batch_stats=bn_stats)
        return state, metrics

    return step


def make_joint_train_step(config: Config, num_classes: int = 4,
                          cls_weight: float = 0.3, mesh=None) -> Callable:
    """Train step of ``UNet3DWithClassifier``: ``step(state, batch,
    generator)``, the batch's integer ``grade`` labels taken from the
    burden of its masks when absent; ``mesh`` as ``make_train_step``'s."""
    from ..models.joint import grade_from_volume, joint_loss
    groups, sync = _data_parallel(mesh)
    group, k = groups.reduce, groups.replicas
    seg_loss_fn = make_loss_fn(config, groups.space)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        sync(state)
        images, targets = batch["image"], batch["mask"]
        if "grade" in batch:
            grades = batch["grade"]
        else:
            tumour = all_reduce_((targets > 0).sum((1, 2, 3)), groups.space)
            grades = grade_from_volume(tumour, targets[0].numel() * k)
        params = list(state.model.parameters())
        with precision(state.model):
            out = state.model.forward_train(images, generator,
                                            bn_group=group, **groups.slab)
            loss, parts = joint_loss(out, targets, grades, seg_loss_fn,
                                     cls_weight)
            # on slabs the grade head runs alike on the k ranks of a row
            # from the pooled bottleneck (whose all-reduce sums their k
            # equal cotangents): its term is differentiated once
            grad_loss = (loss if k == 1 else parts["seg_loss"]
                         + cls_weight * parts["grade_ce"] / k)
            grads = mean_over(_grads(grad_loss, params), group, groups.data)
        state.apply_gradients(grads, batch_stats=out["batch_stats"])
        grade_acc = (out["grade_logits"].detach().argmax(-1) == grades
                     ).float().mean()
        metrics, counts = _reduce_metrics(group, {
            "loss": loss.detach(), "seg_loss": parts["seg_loss"].detach(),
            "grade_ce": parts["grade_ce"].detach(), "grade_acc": grade_acc,
        }, class_counts(out["logits"].detach().argmax(-1), targets,
                        num_classes))
        metrics["dice"] = _foreground_dice(counts)
        return state, metrics

    return step


def make_eval_step(config: Config, num_classes: int = 4,
                   with_hausdorff: bool = False,
                   hd_percentile: float = 95.0, mesh=None) -> Callable:
    """``eval_step(state, batch) -> metrics``: the eval forward's loss
    (no deep heads), mean foreground Dice, WT/TC/ET region Dice, the
    argmax labels and, with ``with_hausdorff``, each sample's
    (percentile-)Hausdorff distance through the exact EDT
    (``ops/edt.py``) — all on the device. With a ``mesh`` the scalars
    are the global batch's, the labels and distances this rank's rows."""
    from ..ops.edt import hausdorff_distance_device
    groups, sync = _data_parallel(mesh)
    group = groups.reduce
    loss_fn = make_loss_fn(config, groups.space)

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        sync(state)
        images, targets = batch["image"], batch["mask"]
        with precision(state.model):
            res = state.model(images, **groups.slab)
        out = dict(res) if isinstance(res, dict) else {"logits": res}
        out["deep"] = []
        labels = out["logits"].argmax(-1)
        cc = class_counts(labels, targets, num_classes)
        means, counts = _reduce_metrics(
            group, {"loss": loss_fn(out, targets)},
            torch.cat([cc, region_counts(labels, targets)], dim=1))
        metrics = {"loss": means["loss"],
                   "dice": _foreground_dice(counts[:, :num_classes]),
                   "pred_labels": labels}
        for name, val in region_dice_of_counts(
                counts[:, num_classes:]).items():
            metrics[f"dice_{name}"] = val
        if with_hausdorff:
            if groups.space is not None:
                # whole volumes: every rank of a row computes its rows'
                labels, targets = (torch.cat(all_gather(t.contiguous(),
                                                        groups.space), 1)
                                   for t in (labels, targets))
            metrics["hausdorff"] = torch.stack([
                hausdorff_distance_device(p > 0, t > 0,
                                          percentile=hd_percentile)
                for p, t in zip(labels, targets)])
        return metrics

    return step
