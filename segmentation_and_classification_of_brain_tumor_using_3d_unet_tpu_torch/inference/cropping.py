"""Foreground (nonzero-bbox) cropping for full-resolution inference.

Real BraTS volumes are skull-stripped: every voxel outside the brain is
exactly zero in all four modalities (the reference inherits this from the
dataset and normalizes accordingly, ``main.py:382-398``). Segmenting air
is pure waste — nnU-Net's production pipeline crops each case to its
nonzero bounding box before inference, which on typical BraTS extents
(~150 x 185 x 140 of 240 x 240 x 155) halves the voxel count.

The crop extent is rounded UP to a *bucket* (multiples of ``multiple``,
floored at ``min_size``, capped at the volume), so a serving process
sees a handful of window shapes whatever the brain sizes. The bucket
is centred on the bounding box and clamped inside the volume, so the
network always sees the full foreground plus a small margin of real
context.

A numpy-only copy of the JAX package's ``inference/cropping.py``: the
port must not import that package (its ``__init__`` imports JAX), and
the tests hold the two copies to bit-exact agreement.

The label map outside the crop is background by construction (the
network's response to exact-zero input carries no information about the
patient), so the full-size output is materialized by scattering the
cropped labels into zeros — the same semantics nnU-Net's
``revert_cropping`` step applies.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Box = Tuple[Tuple[int, int, int], Tuple[int, int, int]]


def nonzero_bbox(vol: np.ndarray, tol: float = 0.0,
                 background: str = "corner") -> Box:
    """Inclusive-exclusive (lo, hi) foreground bounds over the three
    spatial axes. ``vol`` is (D, H, W) or (D, H, W, C); a volume with no
    foreground returns the full extent.

    ``background="corner"`` treats the per-channel value at voxel
    (0, 0, 0) as background — air in BraTS layouts. This matches
    ``|vol| > 0`` on raw skull-stripped volumes (corner is 0) AND stays
    correct after z-score normalization, which maps the zero background
    to a nonzero constant. ``background="zero"`` is the strict raw-zeros
    rule. Volumes without a constant background (e.g. noise everywhere)
    degrade gracefully to the full extent."""
    a = np.asarray(vol)
    if tol == 0.0:
        # |a - c| > 0 == (a != c): skips the float temps (|.|, max) —
        # a 228 MB f32 volume costs seconds of pure memory traffic on a
        # 1-CPU host, and this is the serving hot path (plan_crop)
        ref = a[0, 0, 0] if background == "corner" else 0
        neq = a != ref
        mask = neq.any(axis=-1) if neq.ndim == 4 else neq
    else:
        if background == "corner":
            d = np.abs(a - a[0, 0, 0])
        else:
            d = np.abs(a)
        mask = d.max(axis=-1) if d.ndim == 4 else d
        mask = mask > tol
    lo, hi = [], []
    for axis in range(3):
        other = tuple(j for j in range(3) if j != axis)
        proj = mask.any(axis=other)
        idx = np.flatnonzero(proj)
        if idx.size == 0:
            lo.append(0)
            hi.append(mask.shape[axis])
        else:
            lo.append(int(idx[0]))
            hi.append(int(idx[-1]) + 1)
    return tuple(lo), tuple(hi)


def bucket_shape(extent: Sequence[int], full: Sequence[int],
                 multiple: int = 16, min_size: int = 64,
                 ladder: Sequence[int] = None) -> Tuple[int, int, int]:
    """Round each extent up to ``multiple`` (>= ``min_size``), capped at
    the full volume dimension rounded up to ``multiple`` (the sliding
    window pads past the volume edge when the cap exceeds it).

    ``ladder``: optional ascending canonical sizes (e.g. ``(96, 128,
    160, 192, 224, 256)``). Each axis rounds up to the smallest ladder
    rung instead of the next ``multiple`` — bounding the number of
    distinct window shapes a serving process can see to
    ``len(ladder)^3`` (2-3 in practice for BraTS brains) at the cost of
    ~10% extra voxels. Extents past the last rung fall back to
    ``multiple`` rounding; the full-volume cap still applies."""
    out = []
    for e, f in zip(extent, full):
        e = max(int(e), min_size)
        b = int(np.ceil(e / multiple)) * multiple
        if ladder:
            for rung in sorted(ladder):
                if rung >= e:
                    b = int(rung)
                    break
        cap = int(np.ceil(f / multiple)) * multiple
        out.append(min(b, cap))
    return tuple(out)


def crop_offsets(box: Box, bucket: Sequence[int], full: Sequence[int]
                 ) -> Tuple[int, int, int]:
    """Start offsets of a ``bucket``-shaped window centred on ``box`` and
    clamped inside ``full`` (where the bucket fits; a bucket dim larger
    than the volume yields offset 0 and is padded downstream)."""
    lo, hi = box
    offs = []
    for l, h, b, f in zip(lo, hi, bucket, full):
        c = (l + h) // 2
        offs.append(max(0, min(c - b // 2, f - b)))
    return tuple(offs)


def plan_crop(vol: np.ndarray, multiple: int = 16, min_size: int = 64,
              tol: float = 0.0, background: str = "corner",
              ladder: Sequence[int] = None
              ) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """(offsets, bucket shape) for one volume — the host-side plan that
    keeps device shapes static."""
    full = vol.shape[:3]
    lo, hi = nonzero_bbox(vol, tol, background)
    bucket = bucket_shape([h - l for l, h in zip(lo, hi)], full,
                          multiple=multiple, min_size=min_size,
                          ladder=ladder)
    return crop_offsets((lo, hi), bucket, full), bucket


def extract_crop(vol: np.ndarray, offsets: Sequence[int],
                 bucket: Sequence[int]) -> np.ndarray:
    """Slice the planned window out of the host volume, EDGE-padding at
    the far edge where the bucket exceeds the volume — the same pad
    mode as the sliding-window engine's ``_pad_to_roi``, so crop-mode
    and sliding-window-mode boundary voxels see identical context
    (after z-scoring, air is a nonzero constant; exact zeros would be a
    value the network never sees elsewhere)."""
    full = vol.shape[:3]
    sl = tuple(slice(o, min(o + b, f))
               for o, b, f in zip(offsets, bucket, full))
    crop = vol[sl]
    pads = [(0, b - (s.stop - s.start)) for b, s in zip(bucket, sl)]
    if vol.ndim == 4:
        pads.append((0, 0))
    if any(p[1] for p in pads):
        crop = np.pad(crop, pads, mode="edge")
    return crop


def paste_full(cropped: np.ndarray, offsets: Sequence[int],
               full: Sequence[int], fill=0) -> np.ndarray:
    """Scatter a cropped per-voxel result back into a full-size array
    filled with ``fill`` (background)."""
    out_shape = tuple(full) + tuple(cropped.shape[3:])
    out = np.full(out_shape, fill, dtype=cropped.dtype)
    sl = tuple(slice(o, min(o + c, f))
               for o, c, f in zip(offsets, cropped.shape[:3], full))
    src = tuple(slice(0, s.stop - s.start) for s in sl)
    out[sl] = cropped[src]
    return out
