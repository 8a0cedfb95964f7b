"""Datasets on the host (counterpart of the JAX package's
``data/dataset.py``): the upload decoder ``load_any_volume``, the BraTS
cohort ``BraTS2024Dataset`` and the single-file ``BrainTumorDataset``.

The host side stays thin (file scan, decode, cache); the numerics run on
the device (``preprocess.py``). NIfTI is decoded by the port's NumPy
codec, JAX's reference path (its native reader is not ported), and the
zoom of ``BrainTumorDataset`` is SciPy's, JAX's fallback branch.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import BRATS_MODALITIES
from . import nifti

_VOLUME_EXTS = (".nii.gz", ".nii", ".npy")

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _decode_pool() -> ThreadPoolExecutor:
    """The shared decode pool (2 to 8 workers by the host's cores), made
    on first use."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            workers = max(2, min(8, os.cpu_count() or 2))
            _POOL = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="nifti-decode")
    return _POOL


def load_any_volume(path: str) -> np.ndarray:
    """Decode .nii / .nii.gz (the port's NumPy codec), .npy, or a 2D image
    (through PIL, stacked into a 128-slice fake volume) to float32."""
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p).astype(np.float32)
    if p.endswith(".nii") or p.endswith(".nii.gz"):
        return nifti.load_volume(p)
    # 2D image: grayscale stacked into a fake volume
    from PIL import Image
    img = np.asarray(Image.open(p).convert("L"), np.float32)
    return np.repeat(img[None, :, :], 128, axis=0)


class BraTS2024Dataset:
    """A multi-modal BraTS cohort: ``data_dir/<split>/<patient>/`` holding
    one file per modality (matched by name) and a ``seg`` file, or a flat
    ``data_dir/<patient>/`` layout split 80/20 by index.

    Yields raw stacked volumes, ``{"image": (D, H, W, 4) float32, "mask":
    (D, H, W) uint8, "patient_id": str}``, at native resolution; a small
    LRU cache keeps the last ``cache_size`` samples."""

    def __init__(self, data_dir: str, mode: str = "train",
                 augment: Optional[bool] = None, cache_size: int = 8,
                 modalities: Sequence[str] = BRATS_MODALITIES):
        self.data_dir = str(data_dir)
        self.mode = mode
        self.augment = augment if augment is not None else (mode == "train")
        self.modalities = tuple(modalities)
        self.cache_size = cache_size
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.samples = self._load_sample_list()

    def _load_sample_list(self) -> List[Dict[str, str]]:
        root = Path(self.data_dir)
        split_dir = root / self.mode
        if split_dir.is_dir():
            return self._scan(split_dir)
        if (root / "train").is_dir() or (root / "val").is_dir():
            # a split layout without this split
            return []
        # flat layout: the first 80% train, the rest val / test
        samples = self._scan(root)
        n_train = int(len(samples) * 0.8)
        if self.mode == "train":
            return samples[:n_train]
        if self.mode in ("val", "test"):
            return samples[n_train:]
        return samples

    def _scan(self, sroot: Path) -> List[Dict[str, str]]:
        samples: List[Dict[str, str]] = []
        for pdir in sorted(p for p in sroot.iterdir() if p.is_dir()):
            if pdir.name in ("train", "val", "test"):
                continue
            files = [f for f in pdir.iterdir()
                     if f.name.endswith(_VOLUME_EXTS)]
            entry: Dict[str, str] = {}
            for m in self.modalities:
                match = [f for f in files
                         if m in f.name and "seg" not in f.name]
                if match:
                    entry[m] = str(sorted(match)[0])
            seg = [f for f in files if "seg" in f.name]
            if len(entry) == len(self.modalities) and seg:
                entry["seg"] = str(sorted(seg)[0])
                entry["patient_id"] = pdir.name
                samples.append(entry)
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        with self._lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                return self._cache[idx]
        entry = self.samples[idx]
        # the modalities and the seg decode concurrently (zlib releases
        # the GIL)
        paths = [entry[m] for m in self.modalities] + [entry["seg"]]
        decoded = list(_decode_pool().map(load_any_volume, paths))
        item = {
            "image": np.stack(decoded[:-1], axis=-1),      # (D, H, W, M)
            "mask": decoded[-1].astype(np.uint8),          # raw, incl. 4
            "patient_id": entry["patient_id"],
        }
        with self._lock:
            self._cache[idx] = item
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return item

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class BrainTumorDataset:
    """Single files for inference: each decoded, min-max normalised and
    zoomed (linear) to ``target_size``, with an all-zero segmentation and
    its path. A file that does not decode gives zeros."""

    def __init__(self, file_paths: Sequence[str],
                 target_size: Tuple[int, int, int] = (128, 128, 128)):
        self.file_paths = [str(p) for p in file_paths]
        self.target_size = tuple(target_size)

    def __len__(self) -> int:
        return len(self.file_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.file_paths[idx]
        try:
            vol = load_any_volume(path)
        except Exception:
            vol = np.zeros(self.target_size, np.float32)
        lo, hi = float(vol.min()), float(vol.max())
        if hi > lo:
            vol = (vol - lo) / (hi - lo)
        vol = _zoom_to(vol, self.target_size)
        return {
            "image": vol.astype(np.float32),
            "segmentation": np.zeros(self.target_size, np.uint8),
            "path": path,
        }


def _zoom_to(vol: np.ndarray, size: Tuple[int, int, int],
             order: int = 1) -> np.ndarray:
    """``scipy.ndimage.zoom`` to exactly ``size`` (its rounding may miss
    by a voxel: cropped or zero-padded)."""
    if vol.shape == tuple(size):
        return vol
    from scipy import ndimage
    factors = [t / s for t, s in zip(size, vol.shape)]
    out = ndimage.zoom(vol, factors, order=order)
    out = out[tuple(slice(0, s) for s in size)]
    pad = [(0, s - o) for s, o in zip(size, out.shape)]
    if any(p[1] for p in pad):
        out = np.pad(out, pad)
    return out
