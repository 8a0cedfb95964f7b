"""Normalisation ops (NDHWC layout), counterparts of the JAX package's
``ops/norm.py`` and of the GroupNorm variants in its ``ops/s2d.py`` and
``ops/pallas/ps2d.py``.

All GroupNorms take one-pass f32 moments (mean of x and of x^2) with the
variance clamped at 0, whatever the compute dtype of ``x``. That is not ``torch.nn.GroupNorm``'s two-pass
form: near-constant groups come out differently, and the port follows
the reference. Every op here is differentiable (plain tensor ops), so
the train forward runs the same functions as the eval forward.
"""

from __future__ import annotations

import torch


def group_affine(s1: torch.Tensor, s2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """Per-channel means of x and x^2, (N, C) f32 -> the per-channel
    (scale, shift) f32 pair with ``x * scale + shift`` == GroupNorm(x)."""
    n, c = s1.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    g1 = s1.reshape(n, num_groups, -1).mean(-1)
    g2 = s2.reshape(n, num_groups, -1).mean(-1)
    mean_c = g1.repeat_interleave(c // num_groups, dim=-1)
    var_c = torch.clamp(
        g2.repeat_interleave(c // num_groups, dim=-1) - mean_c.square(),
        min=0.0)
    rstd_c = torch.rsqrt(var_c + eps)
    gm = gamma.float()
    return rstd_c * gm, beta.float() - mean_c * rstd_c * gm


def group_means(sums, count: int, group=None):
    """Sums over this rank's ``count`` voxels -> the means over the
    volume whose D slabs (of ``count`` voxels each) lie on the ranks of
    ``group``: the sums added over the group by one differentiable
    all-reduce (its backward sums their cotangents over the group), then
    divided by the group's count; without a group, ``sums / count``."""
    if group is None:
        return [s / count for s in sums]
    import torch.distributed as dist
    from ..parallel.mesh import all_reduce_sum
    total = all_reduce_sum(torch.stack(list(sums)), group)
    return [s / (count * dist.get_world_size(group)) for s in total]


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               group=None) -> torch.Tensor:
    """GroupNorm over (N, ..., C) as the JAX ``group_norm``: statistics
    and the affine in f32, one rounding to ``x.dtype`` at the end.
    ``group``: ``x`` is this rank's D slab of a volume sharded over that
    process group (the ``space`` group); the statistics are the whole
    volume's (``group_means``)."""
    axes = tuple(range(1, x.ndim - 1))
    xf = x.float()
    moments = ((xf.mean(axes), xf.square().mean(axes)) if group is None
               else group_means((xf.sum(axes), xf.square().sum(axes)),
                                xf[0, ..., 0].numel(), group))
    scale, shift = group_affine(*moments, gamma, beta, num_groups, eps)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (xf * scale.reshape(shape) + shift.reshape(shape)).to(x.dtype)


def bf16_moments(x: torch.Tensor, count: int, group=None):
    """Per-channel means of an (N, ..., C) tensor and of its square over
    ``count`` voxels: f32 accumulation of the values, and of the squares
    rounded to ``x.dtype`` (the JAX ``group_norm_s2d`` and
    ``group_norm_flat`` statistics, bf16 there). ``count`` is the true voxel count,
    so zero padding in ``x`` does not change the result. ``group``:
    ``x`` is this rank's D slab of a volume sharded over that group
    (``group_means``)."""
    axes = tuple(range(1, x.ndim - 1))
    return group_means((x.sum(axes, dtype=torch.float32),
                        x.square().sum(axes, dtype=torch.float32)), count,
                       group)


def apply_affine(x: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """``x * scale + shift`` in ``x.dtype`` with per-(N, C) factors, as
    the JAX package's s2d and flat GroupNorms apply it."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (x * scale.to(x.dtype).reshape(shape)
            + shift.to(x.dtype).reshape(shape))


def group_norm_s2d(x: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, num_groups: int,
                   eps: float = 1e-5, group=None) -> torch.Tensor:
    """GroupNorm with the arithmetic of the JAX ``group_norm_s2d``:
    ``bf16_moments`` statistics (over ``group``'s slabs), affine applied
    in ``x.dtype``."""
    count = x[0, ..., 0].numel()
    scale, shift = group_affine(*bf16_moments(x, count, group), gamma, beta,
                                num_groups, eps)
    return apply_affine(x, scale, shift)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, momentum: float = 0.9,
                     eps: float = 1e-5, group=None):
    """Train BatchNorm over (N, ..., C) as flax's ``BatchNorm`` with
    ``use_running_average=False`` computes it -> (y f32, (new_mean,
    new_var)).

    The batch statistics are f32 one-pass moments, the variance
    E[x^2] - E[x]^2 clamped at 0: the BIASED variance, which flax also
    keeps in its running statistics (``F.batch_norm`` keeps the unbiased
    one, so it is not used). ``y = (x - mean) * (rsqrt(var + eps) *
    gamma) + beta`` in f32. The running statistics move as
    ``momentum * running + (1 - momentum) * batch`` (flax's momentum 0.9
    is torch's 0.1) and carry no gradient.

    ``group`` (a process group, the data-parallel ranks): the statistics
    are the whole batch's over the group, as JAX's single partitioned
    program takes them: each rank's sums of x and x^2 and its count are
    summed over the group by a differentiable all-reduce, whose backward
    sums the cotangents of the moments over the group."""
    xf = x.float()
    axes = tuple(range(x.ndim - 1))
    if group is None:
        mu = xf.mean(axes)
        ex2 = xf.square().mean(axes)
    else:
        from ..parallel.mesh import all_reduce_sum
        count = torch.full((x.shape[-1],), float(xf.numel() // x.shape[-1]),
                           device=x.device)
        s = all_reduce_sum(torch.stack([xf.sum(axes), xf.square().sum(axes),
                                        count]), group)
        mu, ex2 = s[0] / s[2], s[1] / s[2]
    v = torch.clamp(ex2 - mu.square(), min=0.0)
    y = (xf - mu) * (torch.rsqrt(v + eps) * gamma.float()) + beta.float()
    with torch.no_grad():
        new_mean = momentum * mean.float() + (1.0 - momentum) * mu
        new_var = momentum * var.float() + (1.0 - momentum) * v
    return y, (new_mean, new_var)


def batch_norm_infer(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm from running statistics (JAX
    ``batch_norm_infer``; flax ``BatchNorm`` at eval computes the same):
    f32 arithmetic, result in ``x.dtype``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return ((x.float() - mean.float()) * scale + beta.float()).to(x.dtype)
