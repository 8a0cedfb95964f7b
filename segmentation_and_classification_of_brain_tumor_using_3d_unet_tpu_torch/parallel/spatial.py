"""Spatial partitioning of volumes along D over the mesh's ``space`` axis
(counterpart of the JAX package's ``parallel/spatial.py``).

Each rank of a ``space`` group holds one D slab of a (B, D, H, W, C)
activation. A SAME 3x3x3 conv of the whole volume is then, on each slab,
the conv of the slab extended by one plane from each neighbour (zero
planes at the volume's two ends), cropped back: ``halo_exchange_d`` is
that exchange (point-to-point sends to both neighbours), and
``sharded_conv3d`` / ``zero_boundary_halo_conv`` wrap a conv around it.
The exchange is differentiable, as JAX's ``ppermute`` is: its backward
sends each received plane's cotangent back to the rank it came from.
``halo_exchange_planes`` is the same exchange for a tensor that already
has its one-voxel halo (the ps2d region's halo layout): it fills the D
halo planes in place of padding. The U-Net, its ps2d region included,
runs on these slabs (``UNet3D`` with a ``space_group``);
``make_spatial_apply`` is its sliding-window apply function.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, _host, _staged, all_gather


def constrain_spatial(x: torch.Tensor, mesh: Mesh, axis: str = "space",
                      depth: Optional[int] = None) -> torch.Tensor:
    """``x`` unchanged. On a ``space`` > 1 mesh, ``x`` must be this
    rank's slab of an NDHWC activation (of ``depth`` planes in all, when
    given); JAX pins the layout here, each rank holds its slab already."""
    k = mesh.shape.get(axis, 1)
    if k == 1:
        return x
    if x.ndim != 5 or (depth is not None and (depth % k
                                              or x.shape[1] != depth // k)):
        raise ValueError(f"{tuple(x.shape)} is not a D slab of {depth} "
                         f"planes over {k} ranks")
    return x


def _swap(to_left: torch.Tensor, to_right: torch.Tensor, group,
          tag: int):
    """Send ``to_left`` to the previous rank of ``group`` and ``to_right``
    to the next; returns (from the previous rank, from the next), None
    at the volume's ends, on the tensors' device."""
    n = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    staged = _staged(to_left, group)

    def buf(t):
        return _host(t) if staged else t.contiguous()

    ops, from_left, from_right = [], None, None
    # tag: a message going right; tag + 1: one going left
    if i > 0:
        left = dist.get_global_rank(group, i - 1)
        from_left = buf(torch.empty_like(to_right))
        ops += [dist.P2POp(dist.isend, buf(to_left), left, group, tag + 1),
                dist.P2POp(dist.irecv, from_left, left, group, tag)]
    if i < n - 1:
        right = dist.get_global_rank(group, i + 1)
        from_right = buf(torch.empty_like(to_left))
        ops += [dist.P2POp(dist.isend, buf(to_right), right, group, tag),
                dist.P2POp(dist.irecv, from_right, right, group, tag + 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = to_left.device
    return (None if from_left is None else from_left.to(dev),
            None if from_right is None else from_right.to(dev))


def _end_pads(x: torch.Tensor, halo: int, boundary: str):
    """The (left, right) pads of a slab at the volume's ends: zeros, or
    its end plane repeated."""
    if boundary == "zero":
        z = torch.zeros_like(x[:, :halo])
        return z, z
    return (x[:, :1].expand_as(x[:, :halo]),
            x[:, -1:].expand_as(x[:, -halo:]))


class _HaloExchange(torch.autograd.Function):
    """The exchange over a group, and its reverse as the backward: the
    cotangents of the received planes go back to their senders, which
    add them into the edge planes they sent."""

    @staticmethod
    def forward(ctx, x, halo, group, boundary):
        ctx.halo, ctx.group, ctx.boundary = halo, group, boundary
        from_left, from_right = _swap(x[:, :halo], x[:, -halo:], group, 0)
        edge_lo, edge_hi = _end_pads(x, halo, boundary)
        left_pad = edge_lo if from_left is None else from_left
        right_pad = edge_hi if from_right is None else from_right
        return torch.cat([left_pad, x, right_pad], dim=1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        g_lo, g_hi = g[:, :h], g[:, -h:]
        gx = g[:, h:-h].clone()
        from_left, from_right = _swap(g_lo, g_hi, ctx.group, 2)
        if from_left is not None:
            gx[:, :h] += from_left
        elif ctx.boundary == "edge":
            # the pad repeats the end plane: its cotangents are that
            # plane's
            gx[:, :1] += g_lo.sum(1, keepdim=True)
        if from_right is not None:
            gx[:, -h:] += from_right
        elif ctx.boundary == "edge":
            gx[:, -1:] += g_hi.sum(1, keepdim=True)
        return gx, None, None, None


def halo_exchange_d(x_shard: torch.Tensor, halo: int, group=None,
                    boundary: str = "edge") -> torch.Tensor:
    """Pad this rank's (B, D_shard, H, W, C) slab with ``halo`` planes from
    each D neighbour in ``group`` (the ``space`` group; None = one rank).
    At the volume's ends ``boundary`` fills: "edge" repeats the slab's
    own end plane, "zero" gives the zero planes of a zero-padded SAME
    conv. Differentiable: the backward runs the reverse exchange."""
    if boundary not in ("edge", "zero"):
        raise ValueError(f"boundary must be 'edge' or 'zero', got "
                         f"{boundary!r}")
    if group is not None:
        if not 0 < halo <= x_shard.shape[1]:
            raise ValueError(f"halo {halo} for a slab of "
                             f"{x_shard.shape[1]} planes")
        return _HaloExchange.apply(x_shard, halo, group, boundary)
    edge_lo, edge_hi = _end_pads(x_shard, halo, boundary)
    return torch.cat([edge_lo, x_shard, edge_hi], dim=1)


class _HaloPlanes(torch.autograd.Function):
    """The halo-layout exchange over a group; its backward sends the
    cotangents of the filled planes back to their senders, which add
    them into the edge interior planes they sent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        from_left, from_right = _swap(x[:, 1:2], x[:, -2:-1], group, 4)
        y = x.clone()
        if from_left is not None:
            y[:, :1] = from_left
        if from_right is not None:
            y[:, -1:] = from_right
        ctx.live = (from_left is not None, from_right is not None)
        return y

    @staticmethod
    def backward(ctx, g):
        from_left, from_right = _swap(g[:, :1], g[:, -1:], ctx.group, 6)
        gx = g.clone()
        if from_left is not None:
            gx[:, :1] = 0           # overwritten: x's own plane 0 unread
            gx[:, 1:2] += from_left
        if from_right is not None:
            gx[:, -1:] = 0
            gx[:, -2:-1] += from_right
        return gx, None


def halo_exchange_planes(x_halo: torch.Tensor, group=None):
    """Fill the D halo planes of this rank's slab ``x_halo`` (B, D+2,
    H+2, W+2, C) in the halo layout: plane 0 with the left neighbour's
    last interior plane, plane D+1 with the right neighbour's first.
    Returns (the filled tensor, ``d_live``): ``d_live`` = (lo, hi) says
    which planes hold a neighbour's values, for K1 and K6 to read; at
    the volume's ends the plane is left as it is (zero in the region)
    and reported not live. Differentiable: the backward sends the
    filled planes' cotangents back and adds them into the sender's edge
    interior plane. Without a group, ``x_halo`` and no live plane."""
    if group is None:
        return x_halo, (False, False)
    if x_halo.shape[1] < 3:
        raise ValueError(f"a halo-layout slab {tuple(x_halo.shape)} has no "
                         f"interior plane")
    n = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    return _HaloPlanes.apply(x_halo, group), (i > 0, i < n - 1)


def sharded_conv3d(mesh: Mesh, conv_fn: Callable,
                   axis: str = "space") -> Callable:
    """A SAME 3x3x3 conv ``conv_fn(x) -> y`` (shape-preserving in D) as
    the per-slab function of a D-sharded volume: ``conv_fn`` runs on the
    slab extended by one plane of each neighbour (zeros at the volume's
    ends, as the zero-pad SAME conv sees them), and the two halo planes
    are cropped from its output. Equal to the unsharded conv's slab."""
    group = mesh.group(axis)

    def conv(x_shard: torch.Tensor) -> torch.Tensor:
        y = conv_fn(halo_exchange_d(x_shard, 1, group, "zero"))
        return y[:, 1:-1]

    return conv


def zero_boundary_halo_conv(mesh: Mesh, conv_valid_fn: Callable,
                            axis: str = "space") -> Callable:
    """A conv that is VALID in D (and SAME in H and W), run per slab on
    the slab extended by one plane of each neighbour, zeros at the
    volume's ends: the slab of the unsharded zero-pad SAME conv."""
    group = mesh.group(axis)

    def conv(x_shard: torch.Tensor) -> torch.Tensor:
        return conv_valid_fn(halo_exchange_d(x_shard, 1, group, "zero"))

    return conv


def make_spatial_apply(model: torch.nn.Module, mesh: Mesh,
                       axis: str = "space") -> Callable:
    """The sliding window's apply function on a ``space`` mesh (JAX
    ``dryrun_multichip``'s ``apply_spatial``): ``apply(patches)`` takes
    the whole (N, d, h, w, C) window batch on every rank, runs this
    rank's D slab of it through ``model``'s slab forward (``model(x,
    space_group=...)``) and gathers the logits along D over the group,
    so every rank returns the batch's (N, d, h, w, out) logits. On a
    mesh whose ``axis`` has size 1 it is ``model`` itself."""
    from .mesh import batch_sharding
    group = mesh.group(axis)
    if group is None:
        return model
    sharding = batch_sharding(mesh)

    def apply(patches: torch.Tensor) -> torch.Tensor:
        slab = sharding.slab(patches).contiguous()
        logits = model(slab, space_group=group)
        return torch.cat(all_gather(logits.contiguous(), group), dim=1)

    return apply
