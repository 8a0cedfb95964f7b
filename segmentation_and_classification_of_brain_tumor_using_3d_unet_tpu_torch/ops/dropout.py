"""Dropout in train mode (flax ``nn.Dropout``), with an explicit
``torch.Generator``.

``F.dropout3d`` takes no generator, and a train step must be repeatable
from a seed, so the mask is drawn here with ``torch.bernoulli``. JAX's
PRNG and torch's give different masks from the same seed: tests hold
the two packages to each other at rate 0 and check the mask by its
shape and keep rate.
"""

from __future__ import annotations

from typing import Sequence

import torch


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            broadcast_dims: Sequence[int] = ()) -> torch.Tensor:
    """Zero each element of ``x`` with probability ``rate`` and scale the
    kept ones by 1 / (1 - rate) (in ``x``'s dtype, as flax divides); the
    mask has size 1 on ``broadcast_dims`` (the U-Net drops whole
    channels: dims (1, 2, 3) of NDHWC, a (B, 1, 1, 1, C) mask). Rate 0
    returns ``x``. ``generator`` lives on ``x``'s device."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if generator is None:
        raise ValueError("dropout needs a torch.Generator in train mode")
    shape = [1 if i in broadcast_dims else n for i, n in enumerate(x.shape)]
    probs = torch.full(shape, keep, dtype=torch.float32, device=x.device)
    mask = torch.bernoulli(probs, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
