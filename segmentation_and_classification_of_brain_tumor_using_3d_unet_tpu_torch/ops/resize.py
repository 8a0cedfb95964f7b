"""Volumetric resize ops (NDHWC), counterparts of the JAX package's
``ops/resize.py``.

``resize_trilinear`` computes what ``jax.image.resize(method=
"trilinear")`` computes, and that is not ``F.interpolate``: when it
downsamples, JAX antialiases — its triangle kernel is widened by
1/scale and the weights are renormalised where the kernel leaves the
input (``jax.image.scale_and_translate``). ``F.interpolate`` has no
antialiasing for 3-D. So the per-axis weight matrices are built as JAX
builds them (float32, half-pixel centres) and applied as three
separable products along D, H and W in float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def trilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 matrix of one axis of the resize
    (JAX ``compute_weight_mat`` with the triangle kernel and
    antialiasing), in float32 arithmetic as JAX computes it."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
              - f32(0.5))
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(dist / kernel_scale))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_trilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Trilinear (half-pixel) resize of NDHWC ``x`` to spatial ``size``,
    antialiased when downsampling; computed in float32, returned in
    ``x.dtype``. Axes whose size does not change are left alone."""
    size = tuple(int(s) for s in size)
    if x.ndim != 5:
        raise ValueError(f"expected an NDHWC tensor, got {tuple(x.shape)}")
    if tuple(x.shape[1:4]) == size:
        return x
    y = x.float()
    for axis, (n_in, n_out) in enumerate(zip(x.shape[1:4], size), start=1):
        if n_in == n_out:
            continue
        w = torch.from_numpy(trilinear_weights(n_in, n_out)).to(y.device)
        y = torch.tensordot(y, w, dims=([axis], [0])).movedim(-1, axis)
    return y.contiguous().to(x.dtype)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of NDHWC ``x`` (labels, masks) to spatial
    ``size``: bit-exact with ``jax.image.resize(..., "nearest")``, which
    takes source index ``floor((i + 0.5) * n_in / n_out)`` per axis,
    computed in float32."""
    size = tuple(int(s) for s in size)
    if x.ndim != 5:
        raise ValueError(f"expected an NDHWC tensor, got {tuple(x.shape)}")
    for axis, (n_in, n_out) in enumerate(zip(x.shape[1:4], size), start=1):
        if n_in == n_out:
            continue
        src = ((torch.arange(n_out, dtype=torch.float32, device=x.device)
                + 0.5) * n_in / n_out).floor().long()
        x = x.index_select(axis, src)
    return x


def adaptive_avg_pool(x: torch.Tensor, out_size: Sequence[int]
                      ) -> torch.Tensor:
    """AdaptiveAvgPool over the spatial dims of NDHWC ``x`` (JAX
    ``adaptive_avg_pool``): block means when each dim divides evenly,
    else torch's bins (start floor(i*s/o), end ceil((i+1)*s/o)) one
    axis at a time. Means accumulate in float32 and are returned in
    ``x.dtype``, as ``jnp.mean`` does."""
    spatial = tuple(x.shape[1:-1])
    out_size = tuple(out_size)
    if all(s % o == 0 for s, o in zip(spatial, out_size)):
        shape = [x.shape[0]]
        for s, o in zip(spatial, out_size):
            shape += [o, s // o]
        shape.append(x.shape[-1])
        axes = tuple(2 + 2 * i for i in range(len(out_size)))
        return x.reshape(shape).mean(axes, dtype=torch.float32).to(x.dtype)
    out = x
    for axis, (s, o) in enumerate(zip(spatial, out_size), start=1):
        bins = [out.narrow(axis, i * s // o, -(-((i + 1) * s) // o)
                           - i * s // o)
                .mean(axis, keepdim=True, dtype=torch.float32).to(x.dtype)
                for i in range(o)]
        out = torch.cat(bins, dim=axis)
    return out
