"""Intensity statistics of the upload's front end, on the tensor's
device (counterpart of the JAX package's ``ops/stats.py``): percentile
clip to (1, 99), then z-score with eps 1e-8.

``percentile_bisect`` keeps JAX's bisection on the value domain in
JAX's float32 arithmetic, so its clip bounds are JAX's bit for bit:

  * ``targets = q / 100 * (n - 1)`` and ``mid = 0.5 * (lo + hi)`` are
    float32 operations, in that order;
  * the count ``#{x < mid}`` is cast to float32 before it is compared
    with the target, as JAX casts it. Above 2^24 values that cast
    rounds; a count compared in int64 or float64 would move the bounds
    of every real upload (a 240x240x155x4 volume has 35.7 M values).

JAX counts with one comparison pass over the volume per iteration and
quantile. Here the values are sorted once and each count is a binary
search in them (``torch.searchsorted``, left side: the number of values
below ``mid``): the same integers, so the same iterations, without 26
passes over the volume. ``torch.quantile`` is not used: it refuses
inputs above 2^24 values.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _f32(v, device) -> torch.Tensor:
    """A float32 scalar tensor, rounded as JAX rounds a Python number
    that meets a float32 array."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def percentile(x: torch.Tensor, q, axis=None) -> torch.Tensor:
    """Linear-interpolation percentile (``np.percentile``'s default) by a
    full sort, in float32 (JAX ``percentile``). A vector ``q`` stacks one
    result per quantile along a leading axis."""
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    if axis is None:
        s = torch.sort(x.reshape(-1).float()).values
        axis = 0
    else:
        if q.ndim > 0:
            return torch.stack([percentile(x, qi, axis=axis) for qi in q])
        s = torch.sort(x.float(), dim=axis).values
    n = s.shape[axis]
    idx = q / 100.0 * _f32(n - 1, x.device)
    lo = torch.clamp(torch.floor(idx).to(torch.int32), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    w = idx - lo.float()
    if s.ndim == 1:
        return s[lo.long()] * (1.0 - w) + s[hi.long()] * w
    s_lo = s.select(axis, int(lo))
    s_hi = s.select(axis, int(hi))
    return s_lo * (1.0 - w) + s_hi * w


def percentile_bisect(x: torch.Tensor, qs, iters: int = 26) -> torch.Tensor:
    """Percentile values by bisection on the value domain, one per q in
    ``qs`` (JAX ``percentile_bisect``): 26 iterations pin each threshold
    to ~range / 2^26."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    qs = torch.as_tensor(qs, dtype=torch.float32,
                         device=flat.device).reshape(-1)
    targets = qs / 100.0 * _f32(n - 1, flat.device)
    lo = flat.min().expand_as(qs)
    hi = flat.max().expand_as(qs)
    ranked = torch.sort(flat).values
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = torch.searchsorted(ranked, mid).to(torch.float32)
        go_right = cnt <= targets
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def percentile_clip(x: torch.Tensor, lo_q: float = 1.0, hi_q: float = 99.0,
                    exact: bool = False) -> torch.Tensor:
    """Clip intensities to [P_lo, P_hi] in float32: the bisection
    percentiles by default, the sort form with ``exact=True``."""
    if exact:
        lo, hi = percentile(x, lo_q), percentile(x, hi_q)
    else:
        lo, hi = percentile_bisect(x, (lo_q, hi_q))
    return torch.clamp(x.float(), lo, hi)


def zscore_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / (std + eps) in float32, with the population std (as
    ``jnp.std``)."""
    xf = x.float()
    return (xf - xf.mean()) / (xf.std(correction=0) + eps)


def preprocess_intensity(x: torch.Tensor,
                         clip: Tuple[float, float] = (1.0, 99.0),
                         eps: float = 1e-8) -> torch.Tensor:
    """The whole intensity chain: percentile clip, then z-score."""
    return zscore_normalize(percentile_clip(x, *clip), eps)
