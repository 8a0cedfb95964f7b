"""Segmentation predictor (counterpart of the JAX package's
``inference/predictor.py``): the serving path's
``segment_tumor(volume, mode="cropped")`` and the plain
``sliding_window`` mode.

Classification, mirror TTA and the ``whole_volume`` mode are not ported
yet.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.unet3d import UNet3D
from ..models.weights import load_unet3d_params
from . import cropping
from .sliding_window import sliding_window_inference

logger = logging.getLogger(__name__)


class Predictor:
    """Owns a ``UNet3D`` and its weights on one device.

    ``seg_variables``: the JAX model's variables (``{"params": ...,
    "batch_stats": ...}``, nested dicts of numpy arrays); without them
    the weights are made from ``seed``."""

    def __init__(self, config: Optional[Config] = None,
                 seg_variables: Optional[Mapping] = None, seed: int = 0,
                 device="cuda"):
        self.config = config or Config()
        self.device = resolve_device(device)
        mc = self.config.model
        if mc.compute_dtype != "bfloat16":
            raise NotImplementedError("the port computes in bfloat16 only")
        self.seg_model = UNet3D(
            in_channels=mc.in_channels, out_channels=mc.out_channels,
            features=mc.features, ps2d_eval=mc.ps2d_eval,
            ps2d_levels=mc.ps2d_levels, seed=seed, device=self.device)
        self.seg_model.eval()
        if seg_variables is not None:
            self.load_seg_params(seg_variables["params"],
                                 seg_variables.get("batch_stats"))

    # -------------------- segmentation --------------------

    def _canon(self, volume: np.ndarray) -> np.ndarray:
        """(D,H,W[,C]) host array -> (D,H,W,in_channels) float32;
        missing modalities tile the available ones cyclically (JAX
        ``Predictor._canon``)."""
        vol = np.asarray(volume, np.float32)
        if vol.ndim == 3:
            vol = vol[..., None]
        want_c = self.config.model.in_channels
        c = vol.shape[-1]
        if c != want_c:
            if c > 1:
                logger.warning(
                    "input has %d of %d expected modalities; tiling "
                    "the available channels (quality may degrade)",
                    c, want_c)
            reps = -(-want_c // c)
            vol = np.concatenate([vol] * reps, axis=-1)[..., :want_c]
        return vol

    def _sliding_window(self, vol: np.ndarray) -> torch.Tensor:
        ic = self.config.inference
        return sliding_window_inference(
            torch.from_numpy(np.ascontiguousarray(vol)).to(self.device),
            self.seg_model, roi_size=tuple(ic.roi_size), overlap=ic.overlap,
            sw_batch_size=ic.sw_batch_size, blend_mode=ic.blend_mode,
            sigma_scale=ic.gaussian_sigma_scale,
            out_channels=self.config.model.out_channels)

    def segment_tumor(self, volume: np.ndarray,
                      mode: str = "sliding_window") -> np.ndarray:
        """Volume (D,H,W) or (D,H,W,C) -> int8 label map at input res.

        ``cropped``: segment the foreground bounding box, rounded up to
        a bucket of the ladder, and paste the labels into a background
        map (the serving path); ``sliding_window``: the whole volume."""
        vol = self._canon(volume)
        if mode == "cropped":
            ic = self.config.inference
            offs, bucket = cropping.plan_crop(
                vol, multiple=16, min_size=min(ic.roi_size),
                ladder=ic.crop_bucket_ladder)
            logits = self._sliding_window(
                cropping.extract_crop(vol, offs, bucket))
            labels = logits.argmax(-1).to(torch.int8).cpu().numpy()
            return cropping.paste_full(labels, offs, vol.shape[:3], fill=0)
        if mode == "sliding_window":
            return self._sliding_window(vol).argmax(-1).to(
                torch.int8).cpu().numpy()
        raise NotImplementedError(f"segmentation mode {mode!r} is not "
                                  f"ported yet")

    # -------------------- weights --------------------

    def load_seg_params(self, params: Mapping, batch_stats=None) -> None:
        """Adopt the JAX model's params (and optionally its
        batch_stats), through the weight bridge."""
        state = load_unet3d_params({"params": params,
                                    "batch_stats": batch_stats or {}})
        missing, unexpected = self.seg_model.load_state_dict(state,
                                                             strict=False)
        stats = {"head_bn.mean", "head_bn.var"}
        if unexpected or set(missing) - (stats if batch_stats is None
                                         else set()):
            raise KeyError(f"parameter tree does not match the model: "
                           f"missing {missing}, unexpected {unexpected}")
