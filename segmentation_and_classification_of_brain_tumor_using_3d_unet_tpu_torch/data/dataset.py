"""Decoding an uploaded file (counterpart of the JAX package's
``data/dataset.py::load_any_volume``). The cohort datasets come with the
port's data pipeline."""

from __future__ import annotations

import numpy as np

from . import nifti


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
