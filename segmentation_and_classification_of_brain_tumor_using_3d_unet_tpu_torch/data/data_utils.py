"""Standalone volumetric data utilities (counterpart of the JAX package's
``data/data_utils.py``, the reference's ``data_utils.py``; NumPy on the
host, the random draws from numpy generators as in JAX, so that a seed
gives the same draws).

  * ``preprocess_volume``: a real trilinear resample (``dataset._zoom_to``,
    the half-pixel resample of ``native.zoom``) and a z-score; the
    reference's ``np.resize`` tiles and truncates.
  * ``get_2d_augmentations``: a self-contained NumPy pipeline with the
    reference's albumentations transform set (flips, rot90, elastic,
    brightness, noise).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import nifti

logger = logging.getLogger(__name__)


def load_nifti_volume(path: str) -> np.ndarray:
    """NIfTI -> float32 array (reference ``data_utils.py:11-19``)."""
    return nifti.load_volume(path)


def preprocess_volume(volume: np.ndarray,
                      target_shape: Tuple[int, int, int] = (128, 128, 128),
                      normalize: bool = True) -> np.ndarray:
    """Trilinear resample + z-score (fixes the reference's ``np.resize``
    tiling bug, ``data_utils.py:21-31``)."""
    from .dataset import _zoom_to
    vol = np.asarray(volume, np.float32)
    vol = _zoom_to(vol, tuple(target_shape))
    if normalize:
        std = vol.std()
        vol = (vol - vol.mean()) / (std + 1e-8)
    return vol


def augment_volume_3d(volume: np.ndarray,
                      segmentation: Optional[np.ndarray] = None,
                      rng: Optional[np.random.Generator] = None,
                      flip_prob: float = 0.5, rot_prob: float = 0.5,
                      noise_prob: float = 0.3):
    """Host-side 3D augmentation (reference ``data_utils.py:33-59``).
    The on-device path is ``preprocess.augment_pair``; this NumPy variant
    serves host-only tooling."""
    rng = rng or np.random.default_rng()
    vol = np.asarray(volume).copy()
    seg = None if segmentation is None else np.asarray(segmentation).copy()
    for ax in range(3):
        if rng.random() < flip_prob:
            vol = np.flip(vol, axis=ax)
            if seg is not None:
                seg = np.flip(seg, axis=ax)
    if rng.random() < rot_prob:
        k = int(rng.integers(1, 4))
        vol = np.rot90(vol, k, axes=(1, 2))
        if seg is not None:
            seg = np.rot90(seg, k, axes=(1, 2))
    if rng.random() < noise_prob:
        vol = vol + rng.normal(0, 0.05, vol.shape).astype(vol.dtype)
    vol = np.ascontiguousarray(vol)
    if seg is not None:
        return vol, np.ascontiguousarray(seg)
    return vol


def create_2d_slices_from_3d(volume: np.ndarray,
                             segmentation: Optional[np.ndarray] = None,
                             axis: int = 0, min_foreground: int = 0
                             ) -> List[Dict[str, np.ndarray]]:
    """3D -> list of 2D slices for memory-constrained 2D training
    (reference ``data_utils.py:61-79``)."""
    vol = np.asarray(volume)
    out = []
    for i in range(vol.shape[axis]):
        sl = np.take(vol, i, axis=axis)
        item = {"image": sl, "index": i}
        if segmentation is not None:
            seg_sl = np.take(np.asarray(segmentation), i, axis=axis)
            if min_foreground and (seg_sl > 0).sum() < min_foreground:
                continue
            item["segmentation"] = seg_sl
        out.append(item)
    return out


def elastic_transform_2d(image: np.ndarray,
                         mask: Optional[np.ndarray] = None,
                         alpha: float = 40.0, sigma: float = 6.0,
                         rng: Optional[np.random.Generator] = None):
    """Elastic deformation (Simard 2003): a Gaussian-smoothed random
    displacement field of magnitude ``alpha`` warps the image
    (bilinear) and mask (nearest). Parity with the albumentations
    ``ElasticTransform`` in the reference 2D pipeline
    (``data_utils.py:81-93``)."""
    from scipy import ndimage
    rng = rng or np.random.default_rng()
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    dx = ndimage.gaussian_filter(
        rng.uniform(-1, 1, (h, w)), sigma, mode="constant") * alpha
    dy = ndimage.gaussian_filter(
        rng.uniform(-1, 1, (h, w)), sigma, mode="constant") * alpha
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = [yy + dy, xx + dx]

    def warp(a, order):
        if a.ndim == 2:
            return ndimage.map_coordinates(a, coords, order=order,
                                           mode="reflect")
        return np.stack([ndimage.map_coordinates(
            a[..., c], coords, order=order, mode="reflect")
            for c in range(a.shape[-1])], axis=-1)

    out = warp(img, 1)
    if mask is None:
        return out
    return out, warp(np.asarray(mask, np.float32), 0).astype(
        np.asarray(mask).dtype)


def get_2d_augmentations(flip_prob: float = 0.5, rot_prob: float = 0.5,
                         brightness: float = 0.2, noise_sigma: float = 0.03,
                         elastic_prob: float = 0.3,
                         elastic_alpha: float = 40.0,
                         elastic_sigma: float = 6.0) -> Callable:
    """2D augmentation pipeline incl. elastic deformation
    (self-contained; reference relies on albumentations,
    ``data_utils.py:81-93``). Returns ``fn(image, mask=None, rng=None)``."""

    def apply(image, mask=None, rng=None):
        rng = rng or np.random.default_rng()
        img = np.asarray(image).copy()
        m = None if mask is None else np.asarray(mask).copy()
        if rng.random() < flip_prob:
            img = np.fliplr(img)
            m = None if m is None else np.fliplr(m)
        if rng.random() < flip_prob:
            img = np.flipud(img)
            m = None if m is None else np.flipud(m)
        if rng.random() < rot_prob:
            k = int(rng.integers(1, 4))
            img = np.rot90(img, k)
            m = None if m is None else np.rot90(m, k)
        if elastic_prob and rng.random() < elastic_prob:
            if m is None:
                img = elastic_transform_2d(
                    img, alpha=elastic_alpha, sigma=elastic_sigma,
                    rng=rng)
            else:
                img, m = elastic_transform_2d(
                    img, m, alpha=elastic_alpha, sigma=elastic_sigma,
                    rng=rng)
        if brightness:
            img = img * float(1.0 + rng.uniform(-brightness, brightness))
        if noise_sigma:
            img = img + rng.normal(0, noise_sigma, img.shape)
        img = np.ascontiguousarray(img)
        if mask is None:
            return img
        return img, np.ascontiguousarray(m)

    return apply


def calculate_class_weights(segmentations: Sequence[np.ndarray],
                            num_classes: int = 4) -> np.ndarray:
    """Inverse-frequency class weights (reference
    ``data_utils.py:95-104``)."""
    counts = np.zeros(num_classes, np.float64)
    for seg in segmentations:
        seg = np.asarray(seg)
        for c in range(num_classes):
            counts[c] += (seg == c).sum()
    total = counts.sum()
    with np.errstate(divide="ignore"):
        weights = np.where(counts > 0,
                           total / (num_classes * np.maximum(counts, 1)),
                           0.0)
    return (weights / weights.max()).astype(np.float32) if (
        weights.max() > 0) else np.ones(num_classes, np.float32)


def validate_data_integrity(image_paths: Sequence[str],
                            seg_paths: Sequence[str]
                            ) -> Dict[str, List[str]]:
    """Shape-match pre-flight (reference ``data_utils.py:106-130``)."""
    from .dataset import load_any_volume
    report = {"valid": [], "shape_mismatch": [], "load_error": []}
    for ip, sp in zip(image_paths, seg_paths):
        try:
            img = load_any_volume(ip)
            seg = load_any_volume(sp)
            if img.shape[:3] == seg.shape[:3]:
                report["valid"].append(ip)
            else:
                report["shape_mismatch"].append(
                    f"{ip} {img.shape} vs {sp} {seg.shape}")
        except Exception as e:
            report["load_error"].append(f"{ip}: {e}")
    return report


def create_train_val_split(items: Sequence, val_fraction: float = 0.2,
                           seed: int = 42) -> Tuple[list, list]:
    """Deterministic shuffled split (reference ``data_utils.py:132-146``,
    sklearn seed 42)."""
    idx = np.arange(len(items))
    np.random.default_rng(seed).shuffle(idx)
    n_val = int(round(len(items) * val_fraction))
    val_idx = set(idx[:n_val].tolist())
    train = [items[i] for i in range(len(items)) if i not in val_idx]
    val = [items[i] for i in range(len(items)) if i in val_idx]
    return train, val


def get_dataset_statistics(volumes: Sequence[np.ndarray]) -> Dict:
    """Intensity/shape stats (reference ``data_utils.py:148-177``)."""
    stats = {"count": len(volumes), "shapes": [], "mean": [], "std": [],
             "min": [], "max": []}
    for v in volumes:
        v = np.asarray(v)
        stats["shapes"].append(tuple(v.shape))
        stats["mean"].append(float(v.mean()))
        stats["std"].append(float(v.std()))
        stats["min"].append(float(v.min()))
        stats["max"].append(float(v.max()))
    if volumes:
        stats["global_mean"] = float(np.mean(stats["mean"]))
        stats["global_std"] = float(np.mean(stats["std"]))
    return stats
