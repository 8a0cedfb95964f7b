"""Fused GroupNorm (+ReLU, +residual): K5, a hand-written CUDA kernel
(``csrc/group_norm.cu``), with its plain PyTorch version beside it.

Counterpart of the JAX package's ``ops/pallas/groupnorm.py``. The
DoubleConv tail ``relu(norm(x)) + residual`` in two passes over the
activation: per-channel f32 sums of x and of x*x (the squares taken in
f32), folded into the group statistics as ``norm.group_affine`` does
(one-pass moments, the variance clamped at 0, as JAX's XLA epilogue),
then the affine, the optional ReLU and the optional residual in f32 with
one rounding to ``x.dtype``. JAX's ``tile_m`` and lane packing shape its
TPU grid and lanes only, and are not carried over.

The kernel is one cooperative launch of persistent blocks: each block
sums its range of rows (the first stages of it kept in shared memory),
writes its partial sums, waits at a grid-wide barrier, folds its
samples' partials in block order and applies them, re-reading the kept
stages from shared memory and the rest of its range from the end.
``group_norm_plan`` mirrors the C code's launch plan, ``group_norm_ranges``
and ``group_norm_block_of`` its walk, and ``fused_group_norm_mirror`` its
order of summation across blocks, so that the CPU tests can hold them.

The wrapper takes its plain version for tensors on the CPU only; for a
CUDA tensor it launches the kernel or raises. ``fused_group_norm.launches``
counts the launches: one a call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .norm import group_affine
from .ps2d import _aligned, _lib, _on_cpu, _ptr, _stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/group_norm.cu's constants
GN_CONSUMERS = 256                  # eight consumer warps (+ loader, storer)
_STAGE_BYTES = 32768
_KEEP_L2 = 24 << 20
_MIN_BLOCK_BYTES = 64 << 10
# an H100 SXM: its SMs and the shared memory a block may opt in to
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448
_PLAN_KEYS = ("grid", "V", "TX", "TY", "gran", "stage_rows", "stage_bytes",
              "res_stage_bytes", "depth", "nres", "keep", "smem", "units")
_ELT = {None: 0, torch.float32: 4, torch.bfloat16: 2}


def group_norm_plan(n: int, m: int, c: int, dtype: torch.dtype,
                    sms: int = H100_SMS,
                    smem_per_block: int = H100_SMEM_PER_BLOCK,
                    res_dtype: torch.dtype = None) -> dict:
    """K5's launch plan for x (n, m, c) of ``dtype`` (and a residual of
    ``res_dtype``, or none) on a card whose ``sms`` blocks may run at once
    with ``smem_per_block`` bytes each (the C code's ``make_plan``): V
    values an access (8 where c % 8 == 0), a TX x TY thread grid over a
    row's vectors and the rows, ``gran`` rows a 16 B multiple in x and the
    residual, stages of ``stage_rows`` rows (``stage_bytes`` of x,
    ``res_stage_bytes`` of the residual), rings ``depth`` stages deep,
    ``nres`` resident stages, ``keep`` stages a block loaded with an L2
    evict_last policy, the grid, its dynamic shared memory and the whole
    granules in n * m rows (``units``). Raises ValueError where a stage
    and the fixed arrays do not fit."""
    elt, res_elt = _ELT[dtype], _ELT[res_dtype]
    vec = 8 if c % 8 == 0 else 1
    vpr = c // vec
    tx = min(vpr, GN_CONSUMERS)
    row = c * elt
    gran = 16 // math.gcd(row % 16, 16)
    if res_elt:
        gran = max(gran, 16 // math.gcd(c * res_elt % 16, 16))
    stage_rows = max(1, _STAGE_BYTES // (row * gran)) * gran
    sb, rsb = stage_rows * row, stage_rows * c * res_elt
    fixed = 4 * max(GN_CONSUMERS * vec, 2 * c) + 8 * c
    for depth in (4, 3, 2):
        left = smem_per_block - fixed - depth * (sb + rsb + 40)
        if left >= 0:
            break
    if left < 0 or sb >= 1 << 20 or rsb >= 1 << 20:
        raise ValueError(f"fused_group_norm: a row of {c} channels does not "
                         f"fit the kernel's shared memory")
    nres = min(left // (sb + 24), 32 - depth)
    total = n * m
    units = total // gran
    grid = max(1, min(-(-total * row // _MIN_BLOCK_BYTES), sms, units))
    return {"grid": grid, "V": vec, "TX": tx, "TY": GN_CONSUMERS // tx,
            "gran": gran, "stage_rows": stage_rows, "stage_bytes": sb,
            "res_stage_bytes": rsb, "depth": depth, "nres": nres,
            "keep": _KEEP_L2 // (grid * sb),
            "smem": (depth * (sb + rsb) + nres * sb + fixed
                     + 8 * (5 * depth + 3 * nres)),
            "units": units, "blocks_per_sample": grid / n,
            "resident_bytes": nres * sb}


def residual_stream_dtype(x: torch.Tensor, residual) -> torch.dtype:
    """The dtype of the residual the kernel streams: None without one, or
    where the residual is x itself (x's stages serve as the residual)."""
    if residual is None or (residual.data_ptr() == x.data_ptr()
                            and residual.dtype == x.dtype):
        return None
    return residual.dtype


def group_norm_device_plan(n: int, m: int, c: int, dtype: torch.dtype,
                           res_dtype: torch.dtype = None,
                           device=None) -> dict:
    """The plan the C code computes on the current card (the
    ``group_norm_plan`` keys it launches with, and the card's ``sms`` and
    ``smem_cap``)."""
    device = torch.device(device or "cuda")
    lib = _lib()
    out = (ctypes.c_int * (len(_PLAN_KEYS) + 2))()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lib.check("group_norm_plan", lib.group_norm_plan(
        n, m, c, _DTYPES[dtype], _ELT[res_dtype], sms,
        ctypes.addressof(out)))
    return dict(zip((*_PLAN_KEYS, "sms", "smem_cap"), out))


def _range_start(plan: dict, b: int, total: int) -> int:
    if b >= plan["grid"]:
        return total
    return plan["gran"] * (b * plan["units"] // plan["grid"])


def group_norm_block_of(plan: dict, r: int) -> int:
    """The block whose range holds flat row r (the kernel's
    ``block_of``)."""
    u, grid, units = r // plan["gran"], plan["grid"], plan["units"]
    if u >= units:
        return grid - 1
    return min(((u + 1) * grid - 1) // units, grid - 1)


def group_norm_ranges(plan: dict, n: int, m: int) -> list:
    """Each block's items in the kernel's order: [(sample, first flat
    row, end flat row), ...] a block; the ranges cover the n * m rows of
    the flattened tensor in order, cut at multiples of ``gran`` rows, and
    an item is a range's part in one sample."""
    total, out = n * m, []
    for b in range(plan["grid"]):
        lo, hi = (_range_start(plan, i, total) for i in (b, b + 1))
        out.append([(k, max(lo, k * m), min(hi, (k + 1) * m))
                    for k in range(lo // m, (hi - 1) // m + 1)])
    return out


def fused_group_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, num_groups: int,
                           eps: float = 1e-5, residual: torch.Tensor = None,
                           relu: bool = False) -> torch.Tensor:
    """Plain version of K5: the same function as tensor ops."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, c)
    m = xf.shape[1]
    scale, shift = group_affine(xf.sum(1) / m, xf.square().sum(1) / m,
                                gamma, beta, num_groups, eps)
    return _apply(x, xf, scale, shift, residual, relu)


def _apply(x, xf, scale, shift, residual, relu):
    n, c = x.shape[0], x.shape[-1]
    y = xf * scale[:, None] + shift[:, None]
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.float().reshape(n, -1, c)
    return y.to(x.dtype).reshape(x.shape)


def fused_group_norm_mirror(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, num_groups: int,
                            eps: float = 1e-5, residual: torch.Tensor = None,
                            relu: bool = False, plan: dict = None):
    """K5's function with the kernel's order of summation across blocks:
    f32 sums of x and x*x over each item of ``plan`` (the H100's plan by
    default), a sample's items added in block order (blocks
    ``group_norm_block_of`` its first row to its last), folded by
    ``group_affine``. Returns (y, plan)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, c)
    m = xf.shape[1]
    plan = plan or group_norm_plan(
        n, m, c, x.dtype, res_dtype=residual_stream_dtype(x, residual))
    flat = xf.reshape(n * m, c)
    part = {}
    for b, items in enumerate(group_norm_ranges(plan, n, m)):
        for k, r0, r1 in items:
            part[b + k] = torch.stack([flat[r0:r1].sum(0),
                                       flat[r0:r1].square().sum(0)])
    sums = []
    for k in range(n):
        t = torch.zeros((2, c))
        for b in range(group_norm_block_of(plan, k * m),
                       group_norm_block_of(plan, (k + 1) * m - 1) + 1):
            t = t + part[b + k]
        sums.append(t)
    s = torch.stack(sums)
    scale, shift = group_affine(s[:, 0] / m, s[:, 1] / m, gamma, beta,
                                num_groups, eps)
    return _apply(x, xf, scale, shift, residual, relu), plan


def fused_group_norm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, num_groups: int, eps: float = 1e-5,
                     residual: torch.Tensor = None,
                     relu: bool = False) -> torch.Tensor:
    """K5 (JAX ``fused_group_norm``): GroupNorm over (N, ..., C), then
    the optional ReLU, then the optional ``+ residual`` (the DoubleConv
    tail order ``relu(norm(x)) + residual``). x and the residual f32 or
    bf16; the result in ``x.dtype``."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} % groups {num_groups} != 0")
    if _on_cpu(x):
        return fused_group_norm_plain(x, gamma, beta, num_groups, eps,
                                      residual, relu)
    m = x.numel() // max(n * c, 1)
    if (x.dtype not in _DTYPES or x.ndim < 2 or x.numel() == 0
            or m * c >= 2 ** 31 or n > 65535):
        raise ValueError(f"fused_group_norm: needs a non-empty f32 or bf16 "
                         f"(N, ..., C) tensor with N <= 65535 and fewer than "
                         f"2^31 values a sample, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype not in _DTYPES
                                 or not residual.is_cuda):
        raise ValueError(f"fused_group_norm: the residual must be an f32 or "
                         f"bf16 CUDA tensor of x's shape, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    xc = _aligned(x)
    r = None if residual is None else _aligned(residual)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    part = torch.empty((sms + n, 2, c), dtype=torch.float32, device=x.device)
    g32, b32 = (t.to(device=x.device, dtype=torch.float32).contiguous()
                for t in (gamma, beta))
    y = torch.empty_like(xc)
    lib = _lib()
    lib.check("group_norm", lib.group_norm(
        xc.data_ptr(), _DTYPES[x.dtype], _ptr(r),
        0 if r is None else _DTYPES[r.dtype], int(relu), g32.data_ptr(),
        b32.data_ptr(), eps, y.data_ptr(), part.data_ptr(), sms, n, m, c,
        num_groups, _stream()))
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0
