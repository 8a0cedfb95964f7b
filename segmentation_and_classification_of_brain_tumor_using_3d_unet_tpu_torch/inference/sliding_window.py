"""Gaussian-blended sliding-window inference over full-resolution
volumes (counterpart of the JAX package's ``inference/sliding_window.py``).

The volume is covered by a grid of ROI windows, forwarded in groups of
``sw_batch_size``, weighted by a Gaussian importance map and
normalised, all in f32 on the volume's device. The JAX version pads the
last group with zero-weight copies of window 0 to keep its shapes
static; here the last group is simply shorter, which gives the same
blend.
"""

from __future__ import annotations

from typing import (Callable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch


def compute_patch_starts(dim: int, roi: int, overlap: float) -> List[int]:
    """Start offsets covering [0, dim) with ``roi``-sized windows and at
    least ``overlap`` fractional overlap; the last window is flush with
    the volume edge."""
    if dim <= roi:
        return [0]
    step = max(int(roi * (1.0 - overlap)), 1)
    starts = list(range(0, dim - roi + 1, step))
    if starts[-1] != dim - roi:
        starts.append(dim - roi)
    return starts


def gaussian_importance_map(roi_size: Sequence[int],
                            sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian window, peak-normalised to 1 and clipped at
    1e-4, as (*roi, 1) float32."""
    maps = []
    for s in roi_size:
        coords = np.arange(s, dtype=np.float64)
        center = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-3)
        maps.append(np.exp(-0.5 * ((coords - center) / sigma) ** 2))
    g = maps[0][:, None, None] * maps[1][None, :, None] * \
        maps[2][None, None, :]
    g = np.clip(g / g.max(), 1e-4, None)
    return g.astype(np.float32)[..., None]


def _pad_to_roi(vol: torch.Tensor, roi: Sequence[int]
                ) -> Tuple[torch.Tensor, List[int]]:
    """Edge-pad (D, H, W, C) up to ``roi``, centred (JAX ``_pad_to_roi``)."""
    pads = [max(r - s, 0) for s, r in zip(vol.shape[:3], roi)]
    for axis, p in enumerate(pads):
        if p:
            n = vol.shape[axis]
            idx = torch.arange(-(p // 2), n + p - p // 2,
                               device=vol.device).clamp(0, n - 1)
            vol = vol.index_select(axis, idx)
    return vol, pads


def sliding_window_inference(volume: torch.Tensor,
                             apply_fn: Callable[[torch.Tensor], torch.Tensor],
                             roi_size: Tuple[int, int, int] = (128, 128, 128),
                             overlap: float = 0.5, sw_batch_size: int = 4,
                             blend_mode: str = "gaussian",
                             sigma_scale: float = 0.125,
                             out_channels: int = 4) -> torch.Tensor:
    """Blend ``apply_fn`` logits over a volume.

    volume: (D, H, W, C) float on the device to run on; ``apply_fn``
    maps (B, *roi, C) -> (B, *roi, out_channels). Returns (D, H, W,
    out_channels) f32 blended logits."""
    roi_size = tuple(roi_size)
    orig = tuple(volume.shape[:3])
    volume, _ = _pad_to_roi(volume, roi_size)
    dims = tuple(volume.shape[:3])
    starts = [compute_patch_starts(d, r, overlap)
              for d, r in zip(dims, roi_size)]
    grid = [(a, b, c) for a in starts[0] for b in starts[1]
            for c in starts[2]]
    off = [(p - o) // 2 for p, o in zip(dims, orig)]
    crop = tuple(slice(o, o + s) for o, s in zip(off, orig))

    if len(grid) == 1 and roi_size == dims:
        # one window covering the (padded) volume: the blend is the
        # identity, so skip it
        return apply_fn(volume[None]).float()[0][crop]

    if blend_mode == "gaussian":
        imp = torch.from_numpy(gaussian_importance_map(
            roi_size, sigma_scale)).to(volume.device)
    else:
        imp = torch.ones((*roi_size, 1), device=volume.device)
    acc = torch.zeros((*dims, out_channels), dtype=torch.float32,
                      device=volume.device)
    wsum = torch.zeros((*dims, 1), dtype=torch.float32,
                       device=volume.device)
    for g0 in range(0, len(grid), sw_batch_size):
        group = grid[g0:g0 + sw_batch_size]
        wins = [tuple(slice(s, s + r) for s, r in zip(st, roi_size))
                for st in group]
        logits = apply_fn(torch.stack([volume[w] for w in wins])).float()
        for w, lg in zip(wins, logits):
            acc[w] += lg * imp
            wsum[w] += imp
    return (acc / wsum.clamp_min(1e-8))[crop]


def make_sw_predictor(model: torch.nn.Module,
                      variables: Optional[Mapping] = None,
                      roi_size: Tuple[int, int, int] = (128, 128, 128),
                      overlap: float = 0.5, sw_batch_size: int = 4,
                      blend_mode: str = "gaussian",
                      sigma_scale: float = 0.125) -> Callable:
    """``predict(volume) -> logits``: ``sliding_window_inference`` bound
    to ``model`` (JAX ``make_sw_predictor``). ``variables`` (a flax-layout
    tree, optional) is loaded into the model; ``predict.set_variables(v)``
    swaps the weights in place, through the weight bridge."""
    from ..models.weights import load_flax_params

    def set_variables(v: Mapping) -> None:
        model.load_state_dict(load_flax_params(v))

    if variables is not None:
        set_variables(variables)

    def predict(volume: torch.Tensor) -> torch.Tensor:
        return sliding_window_inference(
            volume, model, roi_size=tuple(roi_size), overlap=overlap,
            sw_batch_size=sw_batch_size, blend_mode=blend_mode,
            sigma_scale=sigma_scale,
            out_channels=getattr(model, "out_channels", 4))

    predict.set_variables = set_variables
    return predict
