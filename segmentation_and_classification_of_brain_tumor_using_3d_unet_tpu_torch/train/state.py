"""Train state and optimizer (counterpart of the JAX package's
``train/state.py``).

AdamW (lr 1e-4, weight decay 1e-4, betas (0.9, 0.999)) with the SGDR
schedule ``cosine_warm_restarts`` evaluated per optimizer step and
constant within an epoch, optionally after ``clip_by_global_norm``: the
optax chain JAX builds, in torch. ``torch.optim.AdamW`` decays the
parameter by (1 - lr * wd) before the Adam step, optax adds wd * p to
the Adam direction before scaling by -lr: the same update up to f32
rounding (``tests/test_torch_train_state.py`` holds them to 1e-6). Both
add eps outside the square root, after bias correction.

Unlike flax's immutable ``TrainState``, this one updates the model's
parameters, its BatchNorm statistics and the optimizer state in place
(no second copy of the weights): ``apply_gradients`` returns the same
object.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..config import Config, OptimizerConfig


def cosine_warm_restarts(base_lr: float, t_0: int, t_mult: int,
                         eta_min: float, steps_per_epoch: int
                         ) -> Callable[[int], float]:
    """SGDR over optimizer steps, constant within an epoch (epoch =
    step // steps_per_epoch): cycle k lasts t_0 * t_mult^k epochs and
    the rate falls from base_lr to eta_min along a half cosine in each.
    The cycle is found in integers, not through a float log."""
    t_0 = max(int(t_0), 1)
    t_mult = int(t_mult)
    steps_per_epoch = max(int(steps_per_epoch), 1)

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if t_mult == 1:
            frac = (epoch % t_0) / t_0
        else:
            start, length = 0, t_0
            while epoch >= start + length:
                start, length = start + length, length * t_mult
            frac = (epoch - start) / length
        frac = min(max(frac, 0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * frac))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax
    ``global_norm``), f32, on the tensors' device."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """The optax chain of ``build_optimizer``: optional
    ``clip_by_global_norm``, then AdamW at ``schedule(count)`` where
    count is the number of updates made so far."""

    def __init__(self, params: Sequence[nn.Parameter], cfg: OptimizerConfig,
                 schedule: Callable[[int], float]):
        self.params = list(params)
        self.schedule = schedule
        self.clip_norm = float(cfg.grad_clip_norm or 0.0)
        fused = all(p.is_cuda for p in self.params)
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(cfg.beta1, cfg.beta2),
            eps=cfg.eps, weight_decay=cfg.weight_decay,
            fused=True if fused else None)

    def update(self, grads: Sequence[torch.Tensor], count: int) -> None:
        """One update of every parameter from its gradient (in place)."""
        if self.clip_norm > 0:
            # optax: g when the norm is below the limit, else
            # (g / norm) * limit
            norm = global_norm(grads)
            keep = norm < self.clip_norm
            grads = [torch.where(keep, g, (g / norm) * self.clip_norm)
                     for g in grads]
        for p, g in zip(self.params, grads):
            # the fused AdamW wants each gradient in its parameter's
            # layout; a weight-grad conv may return another
            p.grad = g.to(p.dtype).contiguous()
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(count)
        self.adamw.step()
        for p in self.params:
            p.grad = None


def build_optimizer(cfg: OptimizerConfig, params: Sequence[nn.Parameter],
                    steps_per_epoch: int = 1,
                    learning_rate: Optional[float] = None) -> Optimizer:
    lr = learning_rate if learning_rate is not None else cfg.learning_rate
    if cfg.scheduler == "cosine_warm_restarts":
        schedule = cosine_warm_restarts(lr, cfg.t_0, cfg.t_mult,
                                        cfg.eta_min, steps_per_epoch)
    elif cfg.scheduler == "constant":
        schedule = lambda step: float(lr)      # noqa: E731
    else:
        raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
    return Optimizer(params, cfg, schedule)


def batch_norm_of(model: nn.Module):
    """The model's one BatchNorm (the U-Net's head; the joint model's
    trunk's), whose running statistics are the train state's
    ``batch_stats``."""
    from ..models.unet3d import BatchNorm
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if len(bns) != 1:
        raise ValueError(f"expected one BatchNorm, found {len(bns)}")
    return bns[0]


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer,
    the count of updates and, when ``Config.ema_decay`` > 0, the EMA of
    the parameters (name -> tensor)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0

    def apply_gradients(self, grads: Sequence[torch.Tensor],
                        batch_stats=None) -> "TrainState":
        """One optimizer update (gradients in ``model.parameters()``
        order), the new BatchNorm statistics stored, the EMA advanced."""
        with torch.no_grad():
            self.optimizer.update(grads, self.step)
            self.step += 1
            if batch_stats is not None:
                bn = batch_norm_of(self.model)
                bn.mean.copy_(batch_stats[0])
                bn.var.copy_(batch_stats[1])
            if self.ema_params is not None:
                d = self.ema_decay
                for name, p in self.model.named_parameters():
                    e = self.ema_params[name]
                    e.copy_(d * e + (1.0 - d) * p)
        return self


def valid_ema_decay(decay: float) -> float:
    """0 = off; otherwise strictly inside (0, 1): a decay of 1 or more
    would freeze the EMA at the initial weights."""
    decay = float(decay)
    if decay != 0.0 and not (0.0 < decay < 1.0):
        raise ValueError(f"ema_decay must be 0 (off) or in (0, 1); "
                         f"got {decay}")
    return decay


def create_train_state(model: nn.Module, config: Config,
                       steps_per_epoch: int = 1,
                       learning_rate: Optional[float] = None) -> TrainState:
    """A train state around an initialised model (the port's models
    make their weights from a seed at construction)."""
    decay = valid_ema_decay(getattr(config, "ema_decay", 0.0))
    opt = build_optimizer(config.optimizer, list(model.parameters()),
                          steps_per_epoch, learning_rate)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if decay > 0 else None)
    return TrainState(model=model, optimizer=opt, ema_params=ema,
                      ema_decay=decay)


def ema_eval_state(state: TrainState) -> TrainState:
    """The state to evaluate: the EMA weights when tracked (in a copy of
    the model; BatchNorm statistics stay live), else ``state``."""
    if state.ema_params is None:
        return state
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return TrainState(model=model, optimizer=state.optimizer,
                      step=state.step, ema_params=state.ema_params,
                      ema_decay=state.ema_decay)


def current_lr(state: TrainState, cfg: OptimizerConfig,
               steps_per_epoch: int,
               learning_rate: Optional[float] = None) -> float:
    lr = learning_rate if learning_rate is not None else cfg.learning_rate
    if cfg.scheduler == "constant":
        return float(lr)
    return cosine_warm_restarts(lr, cfg.t_0, cfg.t_mult, cfg.eta_min,
                                steps_per_epoch)(state.step)
