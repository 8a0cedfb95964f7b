"""Device mesh, batch sharding and collectives on ``torch.distributed``
(counterpart of the JAX package's ``parallel/mesh.py``).

JAX builds one ``jax.sharding.Mesh`` over every device of the job and lets
XLA insert the collectives. Here one process drives one device: the mesh
is a grid of process ranks, (data, space) row-major as JAX reshapes its
devices, with one process group per row and per column of the grid, and
the code that needs a collective calls it on the group of its axis.
Without a process group (one process) the mesh is ``{"data": 1,
"space": 1}`` and every collective is the identity.

The backend is chosen explicitly (``initialize_distributed``): ``nccl``
for CUDA ranks, ``gloo`` for the CPU and wherever the caller asks for it
(two ranks that share one card: NCCL refuses two ranks on one device).
Under gloo a CUDA tensor's collective is staged through pinned host
memory on purpose, the same way for every collective.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig

logger = logging.getLogger(__name__)

AXES = ("data", "space")


class Mesh:
    """A (data, space) grid of process ranks.

    ``shape`` maps each axis name to its size; ``devices`` is the grid
    (``devices.size`` ranks); ``coords`` this process's (data, space)
    index, None when it is not in the grid; ``groups`` the process group
    of this process's row along each axis (None where that axis has size
    1 or no process group exists: the collective is then the identity);
    ``whole`` the group of every rank of the grid (the row's group when
    the other axis has size 1; None for one rank)."""

    def __init__(self, grid: np.ndarray,
                 axis_names: Tuple[str, str] = AXES,
                 groups: Optional[Mapping[str, object]] = None,
                 rank: Optional[int] = None, whole=None):
        self.devices = np.asarray(grid)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self.rank = rank
        hit = np.argwhere(self.devices == rank) if rank is not None else []
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self.groups = dict(groups or {})
        self.whole = whole

    def index(self, axis: str) -> int:
        """This process's index along ``axis`` (0 outside the grid)."""
        if self.coords is None:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks={self.devices.tolist()}, "
                f"coords={self.coords})")


def _world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(data: int = -1, space: int = 1,
                axis_names: Tuple[str, str] = AXES,
                devices: Optional[Sequence[int]] = None) -> Mesh:
    """A (data, space) mesh; ``data=-1`` fills the remaining ranks.

    ``devices``: the ranks to lay out (default: every rank of the
    process group, or the one process). With a process group, one group
    per grid column (the ``data`` axis) and per row (``space``), and one
    of the whole grid when both axes are longer than 1, are made by
    every rank, in the same order, as ``dist.new_group`` requires."""
    world, rank = _world()
    ranks = list(devices) if devices is not None else list(range(world))
    n = len(ranks)
    if data == -1:
        if n % space != 0:
            raise ValueError(f"{n} devices not divisible by space={space}")
        data = n // space
    if data * space > n:
        raise ValueError(
            f"mesh {data}x{space} needs {data * space} devices, have {n}")
    grid = np.asarray(ranks[: data * space]).reshape(data, space)
    groups, whole = {}, None

    def group_of(members):
        return (dist.group.WORLD if members == list(range(world))
                else dist.new_group(members))

    if world > 1:
        for axis, lines in ((axis_names[0], grid.T), (axis_names[1], grid)):
            for line in lines:
                members = [int(r) for r in line]
                if len(members) == 1:
                    continue            # a line of one rank: identity
                g = group_of(members)
                if rank in members:
                    groups[axis] = g
        if data > 1 and space > 1:
            members = [int(r) for r in grid.reshape(-1)]
            g = group_of(members)
            whole = g if rank in members else None
        else:
            whole = groups.get(axis_names[0 if space == 1 else 1])
    return Mesh(grid, axis_names, groups, rank, whole)


def mesh_from_config(cfg: MeshConfig,
                     devices: Optional[Sequence[int]] = None) -> Mesh:
    return create_mesh(cfg.data, cfg.space, cfg.axis_names, devices)


@dataclass(frozen=True)
class BatchSharding:
    """The batch dimension over ``data`` and, when the mesh's ``space``
    axis is larger than 1, the D dimension over ``space``: the layout of
    a (B, D, H, W, C) batch (JAX ``P("data", "space")`` / ``P("data")``)."""

    mesh: Mesh

    def _part(self, n: int, axis: str, what: str) -> slice:
        k = self.mesh.shape.get(axis, 1)
        if n % k:
            raise ValueError(f"{what} {n} not divisible by the mesh's "
                             f"{axis} axis ({k})")
        i = self.mesh.index(axis)
        return slice(i * n // k, (i + 1) * n // k)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        return self._part(n, "data", "batch")

    def slab(self, x):
        """This rank's D slab of (B, D, ...) ``x`` (``x`` itself when
        ``space`` is 1)."""
        if self.mesh.shape.get("space", 1) > 1:
            x = x[:, self._part(x.shape[1], "space", "depth")]
        return x

    def shard(self, x):
        """This rank's rows (and D slab, when ``space`` > 1) of ``x``."""
        return self.slab(x[self.rows(x.shape[0])])


@dataclass(frozen=True)
class Replicated:
    """Every rank holds the whole tree (JAX ``P()``); ``place`` makes it
    so by broadcasting its tensors from the mesh's first rank."""

    mesh: Mesh

    def place(self, tensors):
        if not (dist.is_available() and dist.is_initialized()):
            return tensors
        src = int(self.mesh.devices.reshape(-1)[0])
        for t in tensors:
            broadcast_(t, src)
        return tensors


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(batch, mesh: Mesh):
    """This rank's part of a global host batch dict (or array): its rows
    of the batch dimension, and its D slab when ``space`` > 1."""
    s = batch_sharding(mesh)
    if isinstance(batch, Mapping):
        return {k: s.shard(v) for k, v in batch.items()}
    return s.shard(batch)


def replicate_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast ``module``'s parameters and buffers from the mesh's
    first rank, so that every rank starts from the same weights."""
    with torch.no_grad():
        replicated(mesh).place(list(module.parameters())
                               + list(module.buffers()))


def local_device_count() -> int:
    return torch.cuda.device_count()


# ---------------------------------------------------------------------------
# process group bring-up
# ---------------------------------------------------------------------------

def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> torch.device:
    """Join the job's process group; returns this rank's device.

    ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` (with ``MASTER_ADDR`` /
    ``MASTER_PORT``) are read when set; otherwise ``coordinator_address``
    (``host:port``, or a URL such as ``tcp://...`` or ``file://...``),
    ``num_processes`` and ``process_id``. A no-op, logged at INFO, when a
    group already exists or there is one process.

    ``device``: this rank's device; default ``cuda:{LOCAL_RANK %
    device_count}``. ``backend``: ``nccl`` for a CUDA device and
    ``gloo`` for the CPU by default; ``gloo`` may be asked for on CUDA
    (ranks that share a card). Nothing falls back from one to the other."""
    from ..device import resolve_device
    env = os.environ
    if device is None:
        local = int(env.get("LOCAL_RANK", process_id or 0))
        n_dev = max(torch.cuda.device_count(), 1)
        device = f"cuda:{local % n_dev}"
    dev = resolve_device(device)
    if dist.is_initialized():
        logger.info("initialize_distributed skipped: a process group "
                    "exists (world %d)", dist.get_world_size())
        return dev
    if "RANK" in env and "WORLD_SIZE" in env:
        world, rank, init = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    else:
        world, rank = int(num_processes or 1), int(process_id or 0)
        init = coordinator_address
        if init and "://" not in init:
            init = f"tcp://{init}"
    if world <= 1:
        logger.info("initialize_distributed skipped: one process")
        return dev
    if init is None:
        raise ValueError("initialize_distributed needs a coordinator "
                         "address for more than one process")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    logger.info("process group: rank %d of %d, backend %s, device %s",
                rank, world, backend, dev)
    return dev


def is_primary() -> bool:
    """True on rank 0, or without a process group: the process that
    writes files."""
    return _world()[1] == 0


# ---------------------------------------------------------------------------
# collectives (the identity on a group of None)
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    """gloo with a CUDA tensor: the collective runs on a pinned host
    copy."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (one device -> host copy)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``."""
    if group is None:
        return t
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast of ``t`` from global rank ``src``."""
    if _staged(t, group):
        h = _host(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's ``t`` (equal shapes), in group-rank order."""
    if group is None:
        return [t]
    n = dist.get_world_size(group)
    src = _host(t) if _staged(t, group) else t.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the cotangents over the same
    group: each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (identity on None)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _ReplicaSum(torch.autograd.Function):
    """Sum over a group whose backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replica_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` for a loss that every rank then holds
    a replica of (identity on None). Its backward hands each rank's
    cotangent back unchanged: every rank differentiates its replica, and
    its backward then gives that rank's own share of the gradient (the
    shares summed over the group are the gradient). ``all_reduce_sum``'s
    backward would sum the group's equal cotangents instead: a gradient
    as many times too large as the group has ranks."""
    if group is None:
        return x
    return _ReplicaSum.apply(x, group)


# the most bytes of one flat gradient bucket of ``mean_over``
BUCKET_BYTES = 64 << 20


def mean_over(tensors: Sequence[torch.Tensor], group,
              n: Optional[int] = None) -> List[torch.Tensor]:
    """The element-wise sum of each tensor over ``group`` divided by
    ``n`` (default: the group's size, the mean), through a few flat
    buffers of at most ``BUCKET_BYTES`` (one collective per bucket, not
    per tensor). Every rank gets the same bits."""
    tensors = list(tensors)
    if group is None:
        return tensors
    n = dist.get_world_size(group) if n is None else n
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    bucket: List[int] = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
        all_reduce_(flat, group).div_(n)
        for i, part in zip(bucket, flat.split(
                [tensors[i].numel() for i in bucket])):
            out[i] = part.view_as(tensors[i])
        bucket.clear()

    size, dtype = 0, None
    for i, t in enumerate(tensors):
        nb = t.numel() * t.element_size()
        if bucket and (t.dtype != dtype or size + nb > BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(i)
        size, dtype = size + nb, t.dtype
    flush()
    return out
