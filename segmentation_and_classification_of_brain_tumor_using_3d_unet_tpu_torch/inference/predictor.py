"""Segmentation and tumour classification (counterpart of the JAX
package's ``inference/predictor.py``): what the server asks of one
upload — ``segment_with_confidence``, ``classify_tumor`` and
``classify_grade`` — and ``segment_tumor``; and ``preprocess_image``,
the upload's decode and intensity chain in front of them.

Segmentation modes:
  * ``cropped``: the foreground bounding box, rounded up to a bucket of
    the ladder, through the Gaussian sliding window (the serving path);
  * ``sliding_window``: the whole volume through the sliding window;
  * ``whole_volume``: resize to the model size, one forward, logits
    resized back (the reference's semantics).
``tta`` averages the probabilities over the 8 mirror flips; in
``whole_volume`` mode the 8 flips go through one batch-8 forward.

Work on the volume runs on the predictor's device; the crop plan and
the paste of a cropped result into the full map run on the host, as in
JAX. The models compute in ``ModelConfig.compute_dtype`` (bf16 or f32).
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import CLASS_NAMES, Config
from ..device import resolve_device
from ..models.classifier import BrainTumorClassifier
from ..models.joint import UNet3DWithClassifier
from ..models.unet3d import UNet3D
from ..models.weights import load_flax_params
from ..ops.resize import resize_trilinear
from . import cropping
from .sliding_window import sliding_window_inference

logger = logging.getLogger(__name__)


def whole_volume_logits(model: torch.nn.Module, vols: torch.Tensor,
                        size) -> torch.Tensor:
    """(B, D, H, W, C) f32 on the model's device -> the segmentation
    logits at the input resolution: resize to ``size``, one forward,
    resize back (JAX ``_whole_volume_logits``)."""
    out = model(resize_trilinear(vols, tuple(size)))
    logits = out["logits"] if isinstance(out, dict) else out
    return resize_trilinear(logits, vols.shape[1:4])


def _load(model: torch.nn.Module, variables: Mapping,
          optional=frozenset()) -> None:
    """Load a flax variable tree into ``model``; every key must match,
    except the ``optional`` ones, which may be missing."""
    missing, unexpected = model.load_state_dict(
        load_flax_params(variables), strict=False)
    if unexpected or set(missing) - set(optional):
        raise KeyError(f"parameter tree does not match the model: "
                       f"missing {missing}, unexpected {unexpected}")


class Predictor:
    """Owns the segmentation ``UNet3D``, the classifier and (after
    ``load_joint_grade``) the joint grade model on one device.

    ``seg_variables`` / ``cls_variables``: the JAX models' variables
    (``{"params": ..., "batch_stats": ...}``, nested dicts of numpy
    arrays); without them the weights are made from ``seed``."""

    _FLIP_COMBOS = ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2),
                    (0, 1, 2))

    def __init__(self, config: Optional[Config] = None,
                 seg_variables: Optional[Mapping] = None,
                 cls_variables: Optional[Mapping] = None, seed: int = 0,
                 device="cuda"):
        self.config = config or Config()
        self.device = resolve_device(device)
        mc = self.config.model
        self.seg_model = UNet3D(
            in_channels=mc.in_channels, out_channels=mc.out_channels,
            features=mc.features, ps2d_eval=mc.ps2d_eval,
            ps2d_levels=mc.ps2d_levels, seed=seed, device=self.device,
            compute_dtype=mc.compute_dtype, s2d_eval=mc.s2d_eval,
            s2d_train=mc.s2d_train)
        self.seg_model.eval()
        if seg_variables is not None:
            self.load_seg_params(seg_variables["params"],
                                 seg_variables.get("batch_stats"))
        self.cls_model = BrainTumorClassifier(
            in_channels=4, num_classes=4, seed=seed + 1, device=self.device,
            compute_dtype=mc.compute_dtype)
        self.cls_model.eval()
        if cls_variables is not None:
            _load(self.cls_model, cls_variables)
        self.joint_model: Optional[UNet3DWithClassifier] = None
        self.window_mesh = None
        if self.config.inference.window_parallel:
            from ..parallel.mesh import _world, create_mesh
            if _world()[0] > 1:
                self.enable_window_parallel(create_mesh())

    def enable_window_parallel(self, mesh) -> None:
        """Route the ``sliding_window`` and ``cropped`` modes through
        ``parallel.infer.sliding_window_inference_mp``: the window grid
        splits over the mesh's ``data`` axis and one all-reduce merges
        the accumulators. Every rank calls with the same volume; the
        weights are broadcast from the mesh's first rank now, and weights
        adopted later (``load_seg_params``, on every rank) are used."""
        from ..parallel.mesh import replicate_module
        replicate_module(self.seg_model, mesh)
        self.window_mesh = mesh

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

    def _to_device(self, vol: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(vol)).to(self.device)

    def _sliding_window(self, vol: np.ndarray) -> torch.Tensor:
        ic = self.config.inference
        kw = dict(roi_size=tuple(ic.roi_size), overlap=ic.overlap,
                  sw_batch_size=ic.sw_batch_size, blend_mode=ic.blend_mode,
                  sigma_scale=ic.gaussian_sigma_scale,
                  out_channels=self.config.model.out_channels)
        if self.window_mesh is not None:
            from ..parallel.infer import sliding_window_inference_mp
            return sliding_window_inference_mp(
                self._to_device(vol), self.seg_model, self.window_mesh, **kw)
        return sliding_window_inference(self._to_device(vol),
                                        self.seg_model, **kw)

    def _whole_volume_logits(self, vols: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) f32 on the device -> logits at the input
        resolution (``whole_volume_logits`` at the model size)."""
        return whole_volume_logits(self.seg_model, vols,
                                   self.config.data.image_size)

    def _segment_logits(self, vol: np.ndarray, mode: str
                        ) -> Tuple[torch.Tensor, Optional[Tuple]]:
        """One canonical volume -> (logits (D, H, W, C) f32 on the
        device, crop plan): the plan is (offsets, full shape) when the
        logits cover only the foreground window, else None."""
        if mode == "cropped":
            ic = self.config.inference
            offs, bucket = cropping.plan_crop(
                vol, multiple=16, min_size=min(ic.roi_size),
                ladder=ic.crop_bucket_ladder)
            crop = cropping.extract_crop(vol, offs, bucket)
            return self._sliding_window(crop), (offs, vol.shape[:3])
        if mode == "sliding_window":
            return self._sliding_window(vol), None
        # any other mode is whole_volume, as in JAX
        return self._whole_volume_logits(self._to_device(vol)[None])[0], None

    def _probs_full(self, vol: np.ndarray, mode: str) -> torch.Tensor:
        """Canonical volume -> full-resolution class probabilities
        (D, H, W, C) f32 on the device; outside a crop window, background
        with certainty (JAX ``_probs_full``)."""
        logits, plan = self._segment_logits(vol, mode)
        probs = torch.softmax(logits, dim=-1)
        if plan is None:
            return probs
        offs, full = plan
        out = torch.zeros((*full, probs.shape[-1]), dtype=probs.dtype,
                          device=probs.device)
        out[..., 0] = 1.0
        sl = tuple(slice(o, min(o + c, f))
                   for o, c, f in zip(offs, probs.shape[:3], full))
        out[sl] = probs[tuple(slice(0, s.stop - s.start) for s in sl)]
        return out

    def _tta_probs(self, vol: np.ndarray, mode: str) -> torch.Tensor:
        """Mirror TTA: probabilities averaged over the 8 flips."""
        if mode == "whole_volume":
            # the 8 flipped copies through ONE batch-8 forward
            v = self._to_device(vol)[None]
            vols = torch.cat([v.flip([a + 1 for a in ax]) if ax else v
                              for ax in self._FLIP_COMBOS])
            probs = torch.softmax(self._whole_volume_logits(vols), dim=-1)
            back = [p.flip(list(ax)) if ax else p
                    for p, ax in zip(probs, self._FLIP_COMBOS)]
            return torch.stack(back).mean(0)
        acc = None
        for ax in self._FLIP_COMBOS:
            v = np.ascontiguousarray(np.flip(vol, axis=ax)) if ax else vol
            p = self._probs_full(v, mode)
            if ax:
                p = p.flip(list(ax))
            acc = p if acc is None else acc + p
        return acc / 8.0

    def segment_tumor(self, volume: np.ndarray,
                      mode: str = "sliding_window",
                      tta: bool = False) -> np.ndarray:
        """Volume (D,H,W) or (D,H,W,C) -> int8 label map at input res.
        ``cropped`` pastes the window's labels into background."""
        if tta:
            return self.segment_with_confidence(volume, mode, tta=True)[0]
        vol = self._canon(volume)
        logits, plan = self._segment_logits(vol, mode)
        labels = logits.argmax(-1).to(torch.int8).cpu().numpy()
        if plan is not None:
            labels = cropping.paste_full(labels, plan[0], plan[1], fill=0)
        return labels

    def segment_with_confidence(self, volume: np.ndarray,
                                mode: str = "sliding_window",
                                tta: bool = False
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """(labels int8, per-voxel max-softmax confidence float32) at
        input res. In ``cropped`` mode voxels outside the window are
        background with confidence 1.0."""
        vol = self._canon(volume)
        if tta:
            probs = self._tta_probs(vol, mode)
            conf, labels = probs.max(-1)
            return (labels.to(torch.int8).cpu().numpy(),
                    conf.cpu().numpy())
        logits, plan = self._segment_logits(vol, mode)
        conf, labels = torch.softmax(logits, dim=-1).max(-1)
        labels = labels.to(torch.int8).cpu().numpy()
        conf = conf.cpu().numpy()
        if plan is not None:
            labels = cropping.paste_full(labels, plan[0], plan[1], fill=0)
            conf = cropping.paste_full(conf, plan[0], plan[1], fill=1.0)
        return labels, conf

    # -------------------- classification --------------------

    def _model_input(self, vol: np.ndarray) -> torch.Tensor:
        """(D, H, W, C) host volume -> (1, *image_size, C) f32 on the
        device."""
        return resize_trilinear(self._to_device(vol)[None],
                                self.config.data.image_size)

    def classify_tumor(self, volume: np.ndarray,
                       segmentation: Optional[np.ndarray] = None
                       ) -> Tuple[str, float]:
        """(class name, confidence). A segmentation without tumour
        short-circuits to ("No Tumor Detected", 0.95); the volume's
        modalities are tiled cyclically to the classifier's 4."""
        if segmentation is not None and not (np.asarray(segmentation) > 0
                                             ).any():
            return "No Tumor Detected", 0.95
        vol = self._canon(np.asarray(volume))
        if vol.shape[-1] != 4:
            reps = -(-4 // vol.shape[-1])
            vol = np.concatenate([vol] * reps, axis=-1)[..., :4]
        probs = torch.softmax(self.cls_model(self._model_input(vol)),
                              dim=-1)[0].cpu().numpy()
        idx = int(np.argmax(probs))
        return CLASS_NAMES[idx], float(probs[idx])

    # -------------------- grade head (joint checkpoints) --------------------

    def load_joint_grade(self, joint_params: Mapping,
                         joint_batch_stats: Mapping,
                         num_grades: int = 4) -> None:
        """Enable grade prediction from a joint (``UNet3DWithClassifier``)
        checkpoint's params and batch_stats (numpy trees)."""
        mc = self.config.model
        model = UNet3DWithClassifier(
            in_channels=mc.in_channels, out_channels=mc.out_channels,
            num_grades=num_grades, features=mc.features,
            device=self.device, compute_dtype=mc.compute_dtype)
        model.eval()
        _load(model, {"params": joint_params,
                      "batch_stats": joint_batch_stats})
        self.joint_model = model

    def classify_grade(self, volume: np.ndarray
                       ) -> Optional[Tuple[int, float]]:
        """(grade 0..3, softmax confidence) from the joint grade head at
        the model resolution, or None when no joint checkpoint was
        loaded."""
        if self.joint_model is None:
            return None
        x = self._model_input(self._canon(volume))
        probs = torch.softmax(self.joint_model(x)["grade_logits"],
                              dim=-1)[0].cpu().numpy()
        idx = int(np.argmax(probs))
        return idx, float(probs[idx])

    # -------------------- weights --------------------

    def load_seg_params(self, params: Mapping, batch_stats=None) -> None:
        """Adopt the JAX model's params (and optionally its
        batch_stats), through the weight bridge."""
        _load(self.seg_model, {"params": params,
                               "batch_stats": batch_stats or {}},
              optional={"head_bn.mean", "head_bn.var"}
              if batch_stats is None else ())


def preprocess_image(path_or_array, target_size=(128, 128, 128),
                     device="cuda") -> np.ndarray:
    """File (.nii / .nii.gz / .npy / 2D image) or array -> the clipped,
    z-scored (and, with ``target_size``, resized) float32 volume on the
    host (JAX ``preprocess_image``). ``target_size=None`` keeps the
    native resolution for the sliding window. The decode runs on the
    host, the chain on ``device``."""
    from ..data.dataset import load_any_volume
    from ..data.preprocess import preprocess_image as chain
    dev = resolve_device(device)
    vol = (load_any_volume(path_or_array)
           if isinstance(path_or_array, str) else
           np.asarray(path_or_array, np.float32))
    out = chain(torch.from_numpy(np.ascontiguousarray(vol)).to(dev),
                None if target_size is None else tuple(target_size))
    return out.cpu().numpy().astype(np.float32, copy=False)
