"""Euclidean distance transform and Hausdorff distance on the device
(counterpart of the JAX package's ``ops/edt.py``).

The exact squared EDT is separable: along each axis
``f'(i) = min_j f(j) + (i - j)^2``, a min-plus convolution with a
parabola, computed here as JAX computes it: a chunked broadcast-minimum
in float32, static shapes, no data-dependent loop. The same float32
operations in the same order give the same values as JAX's.
"""

from __future__ import annotations

import torch

_BIG = 1e12


def _minplus_axis(f: torch.Tensor, axis: int, chunk: int = 32
                  ) -> torch.Tensor:
    """One exact 1-D squared-EDT pass along ``axis``."""
    n = f.shape[axis]
    f = f.movedim(axis, -1)
    out = torch.full_like(f, _BIG)
    idx = torch.arange(n, dtype=torch.float32, device=f.device)
    for j0 in range(0, n, chunk):
        j = idx[j0:j0 + chunk]
        par = (idx[None, :] - j[:, None]).square()        # (cj, n)
        cand = f[..., j0:j0 + chunk, None] + par          # (..., cj, n)
        out = torch.minimum(out, cand.amin(-2))
    return out.movedim(-1, axis)


def edt_squared(mask: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """Squared Euclidean distance of every voxel to the nearest True
    voxel of ``mask`` (0 inside; unit spacing), float32."""
    f = torch.where(mask.bool(), 0.0, _BIG).float()
    for ax in range(f.ndim):
        f = _minplus_axis(f, ax, chunk)
    return f


def hausdorff_distance_device(pred: torch.Tensor, target: torch.Tensor,
                              percentile: float = 100.0,
                              chunk: int = 32) -> torch.Tensor:
    """Symmetric (percentile-)Hausdorff distance between two binary
    masks, a 0-d float32 tensor; +inf when either mask is empty. The
    percentile interpolates linearly over the surface distances, as
    ``np.percentile`` does."""
    p, t = pred.bool(), target.bool()
    d_to_t = torch.sqrt(edt_squared(t, chunk))
    d_to_p = torch.sqrt(edt_squared(p, chunk))

    def directed(dist, src):
        vals = torch.where(src, dist, -1.0)
        if percentile >= 100.0:
            return vals.max()
        flat = vals.reshape(-1).sort().values        # -1 entries first
        n_src = src.sum()
        pos = ((flat.shape[0] - n_src).float()
               + (percentile / 100.0) * (n_src - 1).float())
        k0 = pos.floor().long()
        frac = pos - k0.float()
        last = flat.shape[0] - 1
        v0 = flat[k0.clamp(0, last)]
        v1 = flat[(k0 + 1).clamp(0, last)]
        return v0 * (1.0 - frac) + v1 * frac

    hd = torch.maximum(directed(d_to_t, p), directed(d_to_p, t))
    empty = ~p.any() | ~t.any()
    return torch.where(empty, torch.full_like(hd, float("inf")), hd)
