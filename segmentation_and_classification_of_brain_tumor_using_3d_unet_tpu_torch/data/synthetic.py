"""Synthetic BraTS-style data generators — the framework's test fixtures
(the port's own copy of the JAX package's ``data/synthetic.py``: the
same draws from the same seed, written through the port's NIfTI codec).

Three tiers, mirroring the reference's fixture ladder (SURVEY.md section 4):

  1. ``create_synthetic_data`` — simple 128^3 single-modality sphere brains
     saved as ``.npy`` (reference ``utils/data_loader.py:94-122``).
  2. ``create_enhanced_synthetic_data`` — full BraTS layout: 240x240x155,
     4 modalities with per-modality contrast physics, nested 3-region
     tumors with the raw BraTS label 4 for enhancing tumor (reference
     ``train_model.py:25-118``). Unlike the reference (which writes ``.npy``
     that its own dataset then cannot find — ``training.py:53`` vs
     ``train_model.py:111``), the format is selectable and defaults to
     ``.nii.gz`` so the dataset ingests it directly; ``.npy`` is also
     accepted by the dataset for backwards compatibility.
  3. ``synthesize_volume`` — one in-memory volume + segmentation, the seed
     of the web demo path (reference ``main.py:654-708``).

All generators take an explicit NumPy ``Generator`` (functional analog of
the reference's global ``np.random`` seeding, ``environment.py:16-21``).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import BRATS_MODALITIES
from . import nifti

FULL_SHAPE = (240, 240, 155)


def _sphere_mask(shape: Sequence[int], center: Sequence[float],
                 radius: float) -> np.ndarray:
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    d2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    return d2 < radius ** 2


def create_synthetic_data(num_samples: int = 10,
                          save_dir: str = "data/raw",
                          shape: Tuple[int, int, int] = (128, 128, 128),
                          seed: int = 42) -> list:
    """Tier 1: N random brains + one bright sphere tumor each, saved .npy
    (reference ``utils/data_loader.py:94-122``)."""
    rng = np.random.default_rng(seed)
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for i in range(num_samples):
        vol = rng.normal(0.5, 0.1, shape).astype(np.float32)
        brain = _sphere_mask(shape, [s / 2 for s in shape],
                             min(shape) * 0.4)
        vol[brain] += 0.2
        center = [rng.integers(s // 4, 3 * s // 4) for s in shape]
        tumor = _sphere_mask(shape, center, rng.integers(8, 20))
        vol[tumor] += 0.5
        vol = np.clip(vol, 0.0, 1.0)
        p = os.path.join(save_dir, f"synthetic_brain_{i:03d}.npy")
        np.save(p, vol)
        paths.append(p)
    return paths


def synthesize_volume(shape: Tuple[int, int, int] = (128, 128, 128),
                      seed: Optional[int] = None, with_tumor: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Tier 3: one in-memory (volume, segmentation) pair with nested
    core(3)/edema(2)/necrotic(1) regions (reference ``main.py:684-701``)."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.5, 0.1, shape).astype(np.float32)
    brain = _sphere_mask(shape, [s / 2 for s in shape], min(shape) * 0.42)
    vol[brain] += 0.25
    seg = np.zeros(shape, np.uint8)
    if with_tumor:
        center = [rng.integers(int(s * 0.35), int(s * 0.65)) for s in shape]
        r = rng.integers(int(min(shape) * 0.08), int(min(shape) * 0.16))
        seg[_sphere_mask(shape, center, r)] = 2          # edema
        seg[_sphere_mask(shape, center, r * 0.65)] = 1   # necrotic
        seg[_sphere_mask(shape, center, r * 0.35)] = 3   # enhancing core
        vol[seg == 2] += 0.3
        vol[seg == 1] += 0.15
        vol[seg == 3] += 0.5
    vol += rng.normal(0, 0.03, shape).astype(np.float32)
    return np.clip(vol, 0, 1), seg


def create_enhanced_synthetic_data(num_samples: int = 100,
                                   save_dir: str = "data/synthetic/BraTS2024",
                                   shape: Tuple[int, int, int] = FULL_SHAPE,
                                   fmt: str = "nii.gz",
                                   seed: int = 42,
                                   tumor_prob: float = 0.8,
                                   skull_stripped: bool = False,
                                   size_range: Optional[Tuple[int, int]]
                                   = None,
                                   start_index: int = 0) -> str:
    """Tier 2: BraTS-layout synthetic cohort (reference
    ``train_model.py:25-118``).

    Layout: ``save_dir/{train,val}/BraTS-Synth-XXXX/<pid>_{t1c,t1n,t2f,
    t2w,seg}.<fmt>`` with an 80/20 split by index. Enhancing tumor uses raw
    BraTS label 4 (remapped to 3 at load time, reference
    ``training.py:136-138``).

    ``skull_stripped=True`` zeroes everything outside the brain mask —
    real BraTS volumes are skull-stripped the same way — enabling the
    nnU-Net foreground-cropping path (``inference/cropping.py``).

    ``size_range=(lo, hi)`` overrides the default tumor-radius draw
    (voxels, hi exclusive) — the default (reference geometry) yields
    tumor burdens of only ~0.1-0.7% of the volume, so cohorts needing
    the full clinical grade ladder (``models/joint.py:
    grade_from_volume``: >0.1/1/5%) mix several calls with different
    ranges. ``start_index`` offsets the patient ids so multiple calls
    can fill ONE cohort dir without colliding.
    """
    assert fmt in ("nii.gz", "nii", "npy")
    rng = np.random.default_rng(seed)
    save_dir_p = Path(save_dir)
    for split in ("train", "val"):
        (save_dir_p / split).mkdir(parents=True, exist_ok=True)

    D, H, W = shape
    brain = _sphere_mask(shape, (D / 2, H / 2, W / 2), min(shape) * 0.42)

    for i in range(start_index, start_index + num_samples):
        pid = f"BraTS-Synth-{i:04d}"
        split = ("train"
                 if (i - start_index) < num_samples * 0.8 else "val")
        pdir = save_dir_p / split / pid
        pdir.mkdir(exist_ok=True)

        base = rng.normal(0.5, 0.1, shape).astype(np.float32)
        seg = np.zeros(shape, np.uint8)
        if rng.random() < tumor_prob:
            tc = (rng.integers(D // 3, 2 * D // 3),
                  rng.integers(H // 3, 2 * H // 3),
                  rng.integers(W // 4, 3 * W // 4))
            lo, hi = (size_range if size_range is not None
                      else (max(6, min(shape) // 16),
                            max(10, min(shape) // 6)))
            size = rng.integers(lo, hi)
            seg[_sphere_mask(shape, tc, size)] = 2            # edema
            seg[_sphere_mask(shape, tc, size * 0.6)] = 1      # necrotic
            seg[_sphere_mask(shape, tc, size * 0.3)] = 4      # enhancing

        for modality in BRATS_MODALITIES:
            vol = base.copy()
            vol[brain] += rng.uniform(0.2, 0.6)
            # modality-specific contrast physics
            if modality == "t1c":
                vol[seg == 4] += 0.8
                vol[seg == 1] -= 0.3
            elif modality == "t1n":
                vol[seg > 0] += rng.uniform(0.1, 0.3)
            elif modality == "t2f":
                vol[seg == 2] += 0.6
                vol[seg == 1] += 0.4
            elif modality == "t2w":
                vol[seg > 0] += rng.uniform(0.3, 0.5)
            vol += rng.normal(0, 0.05, shape).astype(np.float32)
            vol = np.clip(vol, 0, 1).astype(np.float32)
            if skull_stripped:
                vol[~brain] = 0.0
            _save(pdir / f"{pid}_{modality}", vol, fmt)
        _save(pdir / f"{pid}_seg", seg, fmt)

    return str(save_dir)


def _save(stem: Path, arr: np.ndarray, fmt: str) -> None:
    if fmt == "npy":
        np.save(str(stem) + ".npy", arr)
    else:
        nifti.save(str(stem) + "." + fmt, arr)
