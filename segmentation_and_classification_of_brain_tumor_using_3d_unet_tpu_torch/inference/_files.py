"""Volume-file discovery helpers shared by the predict CLI and the cohort
scorer (counterpart of the JAX package's ``inference/_files.py``): one
definition of "what is a volume file" and of "what is its case stem", so
case ids holding dots (BIDS-style ``sub-01.ses-01``) survive.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

VOLUME_EXTS = (".nii", ".nii.gz", ".npy")


def is_volume(p: Union[str, Path]) -> bool:
    return str(p).endswith(VOLUME_EXTS)


def volume_stem(name: Union[str, Path]) -> str:
    """The file name without its volume extension only
    (``sub-01.ses-01_seg.nii.gz`` -> ``sub-01.ses-01_seg``)."""
    name = Path(name).name
    for ext in sorted(VOLUME_EXTS, key=len, reverse=True):
        if name.endswith(ext):
            return name[:-len(ext)]
    return name
