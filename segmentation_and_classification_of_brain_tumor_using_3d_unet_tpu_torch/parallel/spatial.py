"""Spatial partitioning of volumes along D over the mesh's ``space`` axis
(counterpart of the JAX package's ``parallel/spatial.py``).

Each rank of a ``space`` group holds one D slab of a (B, D, H, W, C)
activation. A SAME 3x3x3 conv of the whole volume is then, on each slab,
the conv of the slab extended by one plane from each neighbour (zero
planes at the volume's two ends), cropped back: ``halo_exchange_d`` is
that exchange (point-to-point sends to both neighbours), and
``sharded_conv3d`` / ``zero_boundary_halo_conv`` wrap a conv around it.
These are the building blocks of a spatially sharded U-Net; the port's
models do not run on them yet (``space > 1`` is refused by the trainer).
The exchange carries no gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, _host, _staged


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


def halo_exchange_d(x_shard: torch.Tensor, halo: int, group=None,
                    boundary: str = "edge") -> torch.Tensor:
    """Pad this rank's (B, D_shard, H, W, C) slab with ``halo`` planes from
    each D neighbour in ``group`` (the ``space`` group; None = one rank).
    At the volume's ends ``boundary`` fills: "edge" repeats the slab's
    own end plane, "zero" gives the zero planes of a zero-padded SAME
    conv."""
    if boundary not in ("edge", "zero"):
        raise ValueError(f"boundary must be 'edge' or 'zero', got "
                         f"{boundary!r}")
    lo, hi = x_shard[:, :halo], x_shard[:, -halo:]
    if boundary == "zero":
        edge_lo, edge_hi = torch.zeros_like(lo), torch.zeros_like(hi)
    else:
        edge_lo = x_shard[:, :1].expand_as(lo)
        edge_hi = x_shard[:, -1:].expand_as(hi)
    if group is None:
        return torch.cat([edge_lo, x_shard, edge_hi], dim=1)
    n = dist.get_world_size(group)
    i = dist.get_group_rank(group, dist.get_rank())
    staged = _staged(x_shard, group)

    def buf(t):
        return _host(t) if staged else t.contiguous()

    ops, from_left, from_right = [], None, None
    # tag 0: a slab's last planes, going right; tag 1: its first, going left
    if i > 0:
        left = dist.get_global_rank(group, i - 1)
        from_left = buf(torch.empty_like(hi))
        ops += [dist.P2POp(dist.isend, buf(lo), left, group, 1),
                dist.P2POp(dist.irecv, from_left, left, group, 0)]
    if i < n - 1:
        right = dist.get_global_rank(group, i + 1)
        from_right = buf(torch.empty_like(lo))
        ops += [dist.P2POp(dist.isend, buf(hi), right, group, 0),
                dist.P2POp(dist.irecv, from_right, right, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = x_shard.device
    left_pad = edge_lo if from_left is None else from_left.to(dev)
    right_pad = edge_hi if from_right is None else from_right.to(dev)
    return torch.cat([left_pad, x_shard, right_pad], dim=1)


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
