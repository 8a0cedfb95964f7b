"""The int8 3x3x3 SAME conv of int8 serving: Q8, a hand-written CUDA
kernel (``csrc/conv3d_int8.cu``), with its plain PyTorch version.

It computes ``ops/conv.py::conv3d_zcat_int8`` (JAX ``conv3d_zcat_int8``,
``ops/conv.py:197-285``), which in JAX is an XLA conv, not a Pallas
kernel, so this kernel replaces no TPU kernel. JAX's ``SEG3D_INT8_FORM``
and ``SEG3D_INT8_ACC`` switches pick among TPU formulations of this one
function (``tests/test_quant.py:108-125``); the port has one form.

  * ``prepare_weights_int8`` — the weights' quantization, once per weight
    version: on the card two kernels write the scales and the int8
    weights in the layout the conv reads (``int8_weight_layout`` is its
    plain mirror), on the CPU the plain quantization.
    ``prepare_weights_int8.launches`` counts its launches on the card.
  * ``conv3d_int8`` — the wrapper: on the card the kernel (x quantized
    once by its own pass, int8 ``wgmma`` products summed in int32, the f32
    epilogue and one rounding to bf16), on the CPU the plain version.
    Without ``weights`` it prepares them first by
    ``prepare_weights_int8`` (which counts that launch).
    ``conv3d_int8.launches`` counts the conv's launches.
  * ``conv3d_int8_plain`` — the plain version: x and w quantized with the
    same f32 formulas, a float64 conv of the integer values (exact: every
    sum is an integer below 27 * ci * 127^2 < 2^53), then the same
    epilogue.
  * ``conv3d_int8_plan_of`` — the launch plan the C code picks, in
    Python (its mirror: the wrapper sizes the scratch by it);
    ``conv3d_int8_item`` the part of the input and of K one item of a
    block covers; ``conv3d_int8_plan`` the card's own plan.
  * ``Int8WeightCache`` — the prepared weights of the last kernel version
    a conv ran with (``FastConv3D``'s, a plain attribute, not state).
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .conv import BF16, F32, quantize_weights_int8
from .ps2d import _aligned, _check, _lib, _on_cpu, _stream

# the card and the kernel's constants (csrc/conv3d_int8.cu)
SMS = 132
SMEM_MAX = 232448
ROWS = 256                 # GEMM rows (output voxels) an item where N = 32
PITCH = 48                 # input-tile bytes a voxel and 32-channel chunk
MAX_TILE = 1024            # input-tile voxels at most (and its tables)
MAX_STAGES = 6
BAR_BYTES = 128
MAX_K_SPLITS = 256         # row blocks of the weights' maxima kernel
PLAN_KEYS = ("packed", "resident", "N", "TB", "TD", "TH", "TW", "n_tiles",
             "patches", "chunks", "splits", "items", "grid_x", "grid_y",
             "stages", "smem", "cip", "tile_voxels", "weight_splits", "k16")


class Int8Weights(NamedTuple):
    """Prepared weights: ``wq`` int8 and ``w_scale`` (co,) f32, for a
    (3, 3, 3, ci, co) kernel; ``layout`` "kernel" (the card's, flat
    (co / 8, k16, 8, 16)) or "plain" (DHWIO, the CPU's)."""
    wq: torch.Tensor
    w_scale: torch.Tensor
    ci: int
    co: int
    layout: str


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    ci = x.shape[-1]
    if x.ndim != 5 or tuple(w.shape[:4]) != (3, 3, 3, ci) or w.ndim != 5:
        raise ValueError(f"conv3d_int8: needs x (B, D, H, W, ci) and w (3, 3, "
                         f"3, ci, co), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def _act_scale(act_scale, device) -> torch.Tensor:
    """The scalar as an f32 tensor on ``device``: by a CPU scalar, torch's
    CUDA division multiplies by its reciprocal instead (not always the
    same bits as the IEEE division)."""
    return torch.as_tensor(act_scale, dtype=F32, device=device).reshape(())


def quantize_act_int8(x: torch.Tensor, act_scale) -> torch.Tensor:
    """``clip(round(x_f32 / act_scale), -127, 127)`` (half to even) as
    int8: the activations' per-tensor quantization."""
    s = _act_scale(act_scale, x.device)
    return torch.round(x.float() / s).clamp(-127, 127).to(torch.int8)


# ---------------------------------------------------------------- plan
def _pow2_at_least(n: int) -> int:
    v = 1
    while v < n:
        v <<= 1
    return v


def _round128(n: int) -> int:
    return (n + 127) & ~127


def _shape_plan(B, D, H, W, co, packed, cip, k16, chunks, N, streamed):
    """The C code's ``shape_plan``: the geometry for N output channels a
    tile, resident (None where the weights do not fit) or streamed."""
    n_tiles = -(-co // N)
    TW = min(8, _pow2_at_least(W))
    TH = min(8, _pow2_at_least(H))
    rows = (ROWS if N == 32 and not packed else ROWS // 2) * (
        2 if streamed else 1)
    TD = min(16, rows // (TW * TH), _pow2_at_least(D))
    TB = min(16, rows // (TD * TH * TW), _pow2_at_least(B))
    while TB * (TD + 2) * (TH + 2) * (TW + 2) > MAX_TILE:
        if TB > 1:
            TB >>= 1
        else:
            TD >>= 1
    nb, nd, nh, nw = (-(-B // TB), -(-D // TD), -(-H // TH), -(-W // TW))
    patches = nb * nd * nh * nw
    V = TB * (TD + 2) * (TH + 2) * (TW + 2)
    a_slot = _round128(V * (4 if packed else PITCH))
    fixed = 8 * 16 * (N + 8) * 2 + MAX_TILE * 8 + BAR_BYTES
    b_res = k16 * 16 * N
    resident = not streamed and (packed
                                 or b_res + 2 * a_slot + fixed <= SMEM_MAX)
    if not resident and not streamed:
        return None
    if resident:
        slot, splits = a_slot, 1
        stages = min(MAX_STAGES, (SMEM_MAX - fixed - b_res) // slot) & ~1
    else:
        b_res, slot = 0, a_slot + 27 * 32 * N
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // slot) & ~1
        splits = max(1, min(chunks, SMS // (patches * n_tiles)))
    items = patches * n_tiles * splits
    if resident:
        grid_x, grid_y = min(patches, max(1, SMS // n_tiles)), n_tiles
    else:
        grid_x, grid_y = min(items, SMS), 1
    return dict(packed=int(packed), resident=int(resident), N=N, TB=TB,
                TD=TD, TH=TH, TW=TW, n_tiles=n_tiles,
                patches=min(patches, 0x7fffffff), chunks=chunks,
                splits=splits, items=min(items, 0x7fffffff), grid_x=grid_x,
                grid_y=grid_y, stages=stages,
                smem=b_res + stages * slot + fixed, cip=cip, tile_voxels=V,
                weight_splits=0, k16=k16)


def conv3d_int8_plan_of(B: int, D: int, H: int, W: int, ci: int, co: int
                        ) -> dict:
    """The launch plan of Q8 for x (B, D, H, W, ci) -> co (the C code's
    ``plan``): ``packed`` (ci <= 4: K over (tap, channel) pairs, 128
    deep) or K over ``cip`` = ci rounded up to 32 in ``chunks`` of 32
    channels; N = 32 (co <= 32) or 64 output channels a tile
    (``n_tiles``); the TB x TD x TH x TW output patch (at most 256 voxels
    where N = 32 and not packed, else 128, twice that streamed; its input
    tile ``tile_voxels`` at most 1024); ``resident`` (the channel tile's
    weights kept in shared memory, persistent blocks over the patches,
    grid (grid_x, n_tiles)) or streamed (each stage carries its weights;
    both consumer warpgroups on each item, K split in ``splits`` where
    the patches x tiles do not fill the SMs; grid (min(items, SMs), 1));
    ``stages`` (resident: two rings of half as many, one a consumer
    warpgroup), dynamic shared memory ``smem``; the weights' maxima
    splits; ``k16``, the weights' 16 B K rows; ``form``; ``overlap``,
    input-tile voxels over patch voxels (the int8 copy's reads an
    element; its quantization is once an element). Kept per shape."""
    return dict(_plan_of(B, D, H, W, ci, co))


@functools.lru_cache(maxsize=256)
def _plan_of(B: int, D: int, H: int, W: int, ci: int, co: int) -> dict:
    if (min(B, D, H, W, ci) < 1 or co < 8 or co % 8
            or B * D * H * W > 0x7fffffff or ci > 0x7fffffff // 27 // 32):
        raise ValueError(f"conv3d_int8: unsupported shape x ({B}, {D}, {H}, "
                         f"{W}, {ci}) -> co {co}")
    packed = ci <= 4
    cip = 4 if packed else -(-ci // 32) * 32
    k16 = 8 if packed else 27 * cip // 16
    chunks = 1 if packed else cip // 32
    n0 = 32 if co <= 32 else 64
    args = (B, D, H, W, co, packed, cip, k16, chunks)
    # resident, else streamed
    plan = _shape_plan(*args, n0, False) or _shape_plan(*args, n0, True)
    plan["weight_splits"] = min(MAX_K_SPLITS, max(1, (27 * ci + 255)
                                                  // 256))
    return _described(plan)


def _described(plan: dict) -> dict:
    """``plan`` with its ``form`` and the int8 copy's ``overlap``."""
    plan["form"] = ("packed" if plan["packed"] else "resident"
                    if plan["resident"] else "streamed")
    plan["overlap"] = plan["tile_voxels"] / (
        plan["TB"] * plan["TD"] * plan["TH"] * plan["TW"])
    return plan


def conv3d_int8_item(plan: dict, shape, it: int, by: int = 0) -> dict:
    """What item ``it`` of a block in grid row ``by`` covers (the
    kernel's ``decode``): its patch origin (b0, d0, h0, w0) in x of
    ``shape`` (B, D, H, W), its output-channel tile ``nt`` and its
    32-channel chunks [c_lo, c_hi)."""
    B, D, H, W = shape
    TB, TD, TH, TW = plan["TB"], plan["TD"], plan["TH"], plan["TW"]
    nd, nh, nw = -(-D // TD), -(-H // TH), -(-W // TW)
    p, split, nt = it, 0, by
    if not plan["resident"]:
        p, q = it % plan["patches"], it // plan["patches"]
        nt, split = q % plan["n_tiles"], q // plan["n_tiles"]
    w0 = (p % nw) * TW
    p //= nw
    h0 = (p % nh) * TH
    p //= nh
    d0 = (p % nd) * TD
    b0 = (p // nd) * TB
    ch, sp = plan["chunks"], plan["splits"]
    return dict(b0=b0, d0=d0, h0=h0, w0=w0, nt=nt, c_lo=split * ch // sp,
                c_hi=(split + 1) * ch // sp)


def conv3d_int8_plan(B: int, D: int, H: int, W: int, ci: int, co: int
                     ) -> dict:
    """The plan the C code computes (``PLAN_KEYS``), with its ``form``
    and ``overlap`` as ``conv3d_int8_plan_of`` gives them."""
    import ctypes
    lib = _lib()
    fn = lib._dll.conv3d_int8_plan
    fn.argtypes = (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    lib.check("conv3d_int8_plan",
              fn(B, D, H, W, ci, co, ctypes.addressof(out)))
    return _described(dict(zip(PLAN_KEYS, out)))


# ------------------------------------------------------------- weights
def int8_weight_layout(wq: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the weight kernels' layout: wq (3, 3, 3, ci, co)
    int8 -> flat (co / 8, k16, 8, 16) int8, K tap-major over cip = ci
    rounded up to 32 (zero channels), or, where ci <= 4, over (tap,
    channel) pairs packed four channels a tap and padded to 128."""
    ci, co = wq.shape[3], wq.shape[4]
    cip = 4 if ci <= 4 else -(-ci // 32) * 32
    k = torch.zeros((27, cip, co), dtype=torch.int8, device=wq.device)
    k[:, :ci] = wq.reshape(27, ci, co)
    k = k.reshape(27 * cip, co)
    if ci <= 4:
        k = torch.cat([k, k.new_zeros((128 - 27 * 4, co))])
    kp = k.shape[0]
    return (k.t().reshape(co // 8, 8, kp // 16, 16).permute(0, 2, 1, 3)
            .contiguous().reshape(-1))


def prepare_weights_int8(w: torch.Tensor) -> Int8Weights:
    """The weights' quantization (``quantize_weights_int8``'s function),
    done once per weight version: w (3, 3, 3, ci, co) -> ``Int8Weights``,
    on the card by the two weight kernels in the conv's layout, on the
    CPU in DHWIO."""
    if w.ndim != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"prepare_weights_int8: needs w (3, 3, 3, ci, co), "
                         f"got {tuple(w.shape)}")
    ci, co = w.shape[3], w.shape[4]
    with torch.no_grad():
        if _on_cpu(w):
            wq, ws = quantize_weights_int8(w)
            return Int8Weights(wq, ws, ci, co, "plain")
        if co % 8:
            raise ValueError(f"conv3d_int8: co must be a multiple of 8, got "
                             f"{co}")
        plan = conv3d_int8_plan_of(1, 1, 1, 1, ci, co)
        wf = _aligned(w.float())
        _check("conv3d_int8 w", wf, dtype=F32)
        wq = torch.empty((co * plan["k16"] * 16,), dtype=torch.int8,
                         device=w.device)
        # w_scale (co,), then the maxima of |w| (their bits)
        f32s = torch.empty((2, co), dtype=F32, device=w.device)
        lib = _lib()
        lib.check("conv3d_int8_weights", lib.conv3d_int8_weights(
            wf.data_ptr(), wq.data_ptr(), f32s.data_ptr(), ci, co,
            _stream()))
    prepare_weights_int8.launches += 1
    return Int8Weights(wq, f32s[0], ci, co, "kernel")


prepare_weights_int8.launches = 0


class Int8WeightCache:
    """The prepared weights of the last kernel a conv ran with, keyed on
    the tensor itself (weakly), its storage pointer, ``_version``, shape,
    dtype and device: a weight loaded in place (``load_state_dict``, a
    checkpoint, the weight bridge) bumps ``_version``, a new tensor is
    another key, so the next call prepares them anew. A copy of the
    holder (``copy.deepcopy``, ``with_quant_mode``) starts empty."""

    __slots__ = ("key", "weights")

    def __init__(self):
        self.key = None
        self.weights: Optional[Int8Weights] = None

    def __deepcopy__(self, memo):
        return Int8WeightCache()

    def clear(self) -> None:
        self.key = self.weights = None

    def get(self, w: torch.Tensor) -> Int8Weights:
        key = (w.data_ptr(), w._version, tuple(w.shape), w.dtype, w.device)
        if self.weights is None or self.key[0]() is not w \
                or self.key[1:] != key:
            self.weights = prepare_weights_int8(w)
            self.key = (weakref.ref(w), *key)
        return self.weights


def _weights_for(w: torch.Tensor, weights: Optional[Int8Weights],
                 layout: str) -> Int8Weights:
    if weights is None:
        return prepare_weights_int8(w)
    if weights.layout != layout or (weights.ci, weights.co) != tuple(
            w.shape[3:]):
        raise ValueError(f"conv3d_int8: prepared weights ({weights.layout}, "
                         f"ci {weights.ci}, co {weights.co}) do not fit w "
                         f"{tuple(w.shape)} on {w.device}")
    return weights


# ---------------------------------------------------------------- conv
def conv3d_int8_plain(x: torch.Tensor, w: torch.Tensor, act_scale,
                      bias: torch.Tensor = None,
                      weights: Optional[Int8Weights] = None) -> torch.Tensor:
    """Plain version of the int8 conv: x (B, D, H, W, ci) any float, w
    (3, 3, 3, ci, co), scalar ``act_scale``, optional bias (co,) -> (B, D,
    H, W, co) bf16. ``weights``: w's prepared "plain" weights, used in
    place of quantizing w."""
    _check_shapes(x, w)
    s = _act_scale(act_scale, x.device)
    if weights is None:
        wq, w_scale = quantize_weights_int8(w)
    else:
        wq, w_scale = _weights_for(w, weights, "plain")[:2]
    xq = quantize_act_int8(x, s).to(torch.float64).permute(0, 4, 1, 2, 3)
    wn = wq.to(torch.float64).permute(4, 3, 0, 1, 2)
    y = F.conv3d(xq, wn, padding=1).permute(0, 2, 3, 4, 1).float()
    y = y * (s * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(BF16).contiguous()


def conv3d_int8(x: torch.Tensor, w: torch.Tensor, act_scale,
                bias: torch.Tensor = None,
                weights: Optional[Int8Weights] = None) -> torch.Tensor:
    """The int8 conv (``conv3d_int8_plain``'s function): on CUDA tensors
    the kernel, for x bf16 or f32 of any ci and co a multiple of 8; on the
    CPU the plain version. ``weights``: w's ``prepare_weights_int8``
    (kept by the caller across calls); without them the weights are
    prepared in the call."""
    if _on_cpu(x):
        return conv3d_int8_plain(x, w, act_scale, bias, weights)
    _check_shapes(x, w)
    if x.dtype not in (BF16, F32):
        raise ValueError(f"conv3d_int8: x must be bfloat16 or float32, got "
                         f"{x.dtype}")
    B, D, H, W, ci = x.shape
    co = w.shape[-1]
    if co % 8:
        raise ValueError(f"conv3d_int8: co must be a multiple of 8, got {co}")
    plan = conv3d_int8_plan_of(B, D, H, W, ci, co)
    x = _aligned(x)
    s = _aligned(_act_scale(act_scale, x.device).reshape(1))
    b = None if bias is None else _aligned(bias.float())
    _check("conv3d_int8 x", x, dtype=x.dtype)
    _check("conv3d_int8 act_scale", s, (1,), F32)
    if b is not None:
        _check("conv3d_int8 bias", b, (co,), F32)
    prep = _weights_for(w, weights, "kernel")
    _check("conv3d_int8 wq", prep.wq, (co * plan["k16"] * 16,), torch.int8)
    _check("conv3d_int8 w_scale", prep.w_scale, (co,), F32)
    vox = B * D * H * W
    # scratch: the int8 copy of x, and the split's int32 sums (zeroed by
    # the C entry)
    xq = torch.empty((vox * plan["cip"],), dtype=torch.int8, device=x.device)
    acc = (torch.empty((vox, co), dtype=torch.int32, device=x.device)
           if plan["splits"] > 1 else None)
    y = torch.empty((B, D, H, W, co), dtype=BF16, device=x.device)
    lib = _lib()
    lib.check("conv3d_int8", lib.conv3d_int8(
        x.data_ptr(), int(x.dtype == BF16), prep.wq.data_ptr(),
        prep.w_scale.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(), xq.data_ptr(),
        None if acc is None else acc.data_ptr(), y.data_ptr(), B, D, H, W,
        ci, co, _stream()))
    conv3d_int8.launches += 1
    return y


conv3d_int8.launches = 0

