"""The deterministic half of the preprocessing chain, on the tensor's
device (counterpart of the JAX package's ``data/preprocess.py``):
percentile clip (1, 99) -> z-score (eps 1e-8) -> trilinear resize, and
the label chain (BraTS label 4 -> 3, nearest resize). The random
augmentations come with the port's data pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.resize import resize_nearest, resize_trilinear
from ..ops.stats import percentile_clip, zscore_normalize


def preprocess_image(vol: torch.Tensor,
                     out_size: Optional[Tuple[int, int, int]] = (128, 128,
                                                                 128),
                     clip: Tuple[float, float] = (1.0, 99.0)
                     ) -> torch.Tensor:
    """clip -> z-score -> resize of (D, H, W) or (D, H, W, C), float32
    out. A (D, H, W, C) volume is clipped and z-scored as one tensor
    across all its channels, as JAX does. ``out_size=None`` keeps the
    native resolution."""
    squeeze = vol.ndim == 3
    if squeeze:
        vol = vol[..., None]
    vol = zscore_normalize(percentile_clip(vol, *clip))
    if out_size is not None and tuple(out_size) != tuple(vol.shape[:3]):
        vol = resize_trilinear(vol[None], out_size)[0]
    return vol[..., 0] if squeeze else vol


def preprocess_multimodal(vols: torch.Tensor,
                          out_size: Tuple[int, int, int] = (128, 128, 128),
                          clip: Tuple[float, float] = (1.0, 99.0)
                          ) -> torch.Tensor:
    """(D, H, W, M) stack, each modality normalised on its own."""
    return torch.stack([preprocess_image(vols[..., m], out_size, clip)
                        for m in range(vols.shape[-1])], dim=-1)


def preprocess_segmentation(seg: torch.Tensor,
                            out_size: Optional[Tuple[int, int, int]]
                            = (128, 128, 128)) -> torch.Tensor:
    """BraTS label 4 -> 3, nearest resize, int32. ``out_size=None``
    keeps the native resolution."""
    seg = torch.where(seg == 4, 3, seg).to(torch.int32)
    if out_size is None:
        return seg
    return resize_nearest(seg[None, ..., None], out_size)[0, ..., 0]
