"""Convolutions of the normal (NDHWC) layout.

Counterparts of the JAX package's ``ops/conv.py``. There these are XLA
ops, not Pallas kernels, so here they are library calls: cuDNN's conv3d
and cuBLAS's matmul on the card. Every op computes in a compute dtype
(``dtype``, bf16 by default; the JAX modules' ``dtype``): its operands
are cast to it, products accumulate in f32 and the result is rounded to
it once, as the JAX functions do. In f32 the library calls run with TF32
off (``full_f32``), as JAX's f32 is full f32. Every op carries gradients
(autograd through the library calls; on the CPU through the widened
operands). Kernels are kept in flax's layouts (DHWIO), so parameters
move between the packages unchanged. The one exception is the int8 conv
of int8 serving (``conv3d_zcat_int8``, eval only): PyTorch has no int8
3-D conv, so on the card it is a hand-written kernel
(``ops/conv_int8.py``).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

BF16 = torch.bfloat16
F32 = torch.float32

# convs with at most this many output channels take the ksplit
# formulation (JAX ops/conv.py KSPLIT_MAX_CO): its per-tap bf16 rounding
# is part of the reference's arithmetic for the head conv
KSPLIT_MAX_CO = 16


def f32_accumulate(fn, *args):
    """``fn`` on bf16 operands with f32 accumulation, result in bf16.

    cuDNN and cuBLAS accumulate bf16 products in f32 themselves; on the
    CPU the operands are widened first, which gives the same result."""
    if args[0].is_cuda:
        return fn(*args)
    return fn(*(a.float() for a in args)).to(BF16)


# TF32 (``torch.backends.cudnn.allow_tf32`` and the f32 matmul
# precision) is process-wide, and the server runs requests in threads, so
# the sections that set it are counted under one lock: the first to open
# saves the settings, the last to close restores them, and while any
# full-f32 section is open TF32 stays off (a section that only lets TF32
# in, for bf16 values it holds exactly, then runs without it: slower, same
# products).
_TF32_LOCK = threading.Lock()
_tf32_open = {"off": 0, "on": 0}
_tf32_saved = (True, "highest")


def _tf32_apply() -> None:
    conv, mm = _tf32_saved
    if _tf32_open["off"]:
        conv, mm = False, "highest"
    elif _tf32_open["on"]:
        conv = True
    torch.backends.cudnn.allow_tf32 = conv
    torch.set_float32_matmul_precision(mm)


@contextlib.contextmanager
def _tf32_section(kind: str):
    global _tf32_saved
    with _TF32_LOCK:
        if not any(_tf32_open.values()):
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.get_float32_matmul_precision())
        _tf32_open[kind] += 1
        _tf32_apply()
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_open[kind] -= 1
            _tf32_apply()


def full_f32():
    """cuDNN's convs and cuBLAS's f32 matmuls without TF32 until the
    last full-f32 section of any thread has closed; then both settings
    are restored."""
    return _tf32_section("off")


def tf32_for_bf16():
    """cuDNN's convs in TF32 for f32 operands that hold bf16 values
    (exact in TF32), unless a full-f32 section is open."""
    return _tf32_section("on")


def compute_dtype_of(spec) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (``ModelConfig.compute_dtype``) or
    a torch dtype -> the torch dtype; anything else raises."""
    dt = {"bfloat16": BF16, "float32": F32}.get(spec, spec)
    if dt not in (BF16, F32):
        raise ValueError(f"compute dtype must be bfloat16 or float32, got "
                         f"{spec!r}")
    return dt


def accumulate(fn, *args):
    """``fn`` on operands of one compute dtype, f32 accumulation, result
    in that dtype: bf16 as ``f32_accumulate``, f32 with TF32 off."""
    if args[0].dtype == BF16:
        return f32_accumulate(fn, *args)
    with full_f32():
        return fn(*args)


def matmul(x: torch.Tensor, w: torch.Tensor,
           dtype: torch.dtype = BF16) -> torch.Tensor:
    """``x @ w`` in ``dtype`` with f32 accumulation (``x`` (..., K),
    ``w`` (K, N) or batched (B, K, N) against ``x`` (B, ..., K))."""
    return accumulate(torch.matmul, x.to(dtype), w.to(dtype))


def _conv3d(x: torch.Tensor, w: torch.Tensor, padding,
            dtype: torch.dtype) -> torch.Tensor:
    """NDHWC ``x`` with a DHWIO kernel, both cast to ``dtype`` -> NDHWC
    in ``dtype``."""
    xn = x.to(dtype).permute(0, 4, 1, 2, 3)       # channels-last NCDHW view
    wn = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous()
    y = accumulate(lambda a, b: F.conv3d(a, b, padding=padding), xn, wn)
    return y.permute(0, 2, 3, 4, 1)


def split3_bf16(x: torch.Tensor):
    """The exact three-way split of an f32 tensor that the f32 forms of
    K1 (its transformed activations) and K7 (its activations and its
    weights) apply before their bf16 passes: ``hi = bf16(x)``,
    ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)`` (each difference
    exact in f32), so ``hi + mid + lo == x`` for 0 and every
    2^-110 <= |x| <= 3.3895e38; below, the error is under 2^-133. A
    plain mirror of the kernels' split, for the tests."""
    x = x.float()
    hi = x.to(BF16)
    r = x - hi.float()
    mid = r.to(BF16)
    lo = (r - mid.float()).to(BF16)
    return hi, mid, lo


# the part products K7's f32 form keeps (csrc/conv3d_same_f32.cu), in
# its order: (x's part, w's part), 0 hi, 1 mid, 2 lo; mid lo, lo mid and
# lo lo are dropped
SPLIT6_PASSES = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def conv3d_split6(x: torch.Tensor, w: torch.Tensor,
                  dtype: torch.dtype = torch.float64,
                  passes=SPLIT6_PASSES) -> torch.Tensor:
    """Plain mirror of K7's f32 form: the 3x3x3 SAME conv of NDHWC ``x``
    with DHWIO ``w`` (both f32) as six convs of their bf16 parts
    (``split3_bf16``, ``SPLIT6_PASSES``), each computed in ``dtype`` and
    summed in it pass by pass, in the kernel's order; ``passes`` a subset
    of them (one pass's share of the conv, or the sum without one). For
    the tests and the card's check that the gates see a dropped pass."""
    xs, ws = split3_bf16(x), split3_bf16(w)
    out = None
    for i, j in passes:
        y = _conv3d(xs[i], ws[j], 1, dtype)
        out = y if out is None else out + y
    return out.contiguous()


def conv3d_zcat(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor = None,
                dtype: torch.dtype = BF16,
                valid_d: bool = False) -> torch.Tensor:
    """3x3x3 SAME conv (JAX ``conv3d_zcat``): x (B, D, H, W, Cin),
    w (3, 3, 3, Cin, Cout); out in ``dtype``, bias added in ``dtype``.
    ``valid_d``: VALID in D (D - 2 output planes; a slab extended by one
    plane of each neighbour), SAME in H and W."""
    if tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d_zcat expects 3x3x3 kernels, got "
                         f"{tuple(w.shape)}")
    y = _conv3d(x, w, (0, 1, 1) if valid_d else 1, dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y.contiguous()


def conv3d_zsum(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor = None,
                dtype: torch.dtype = BF16) -> torch.Tensor:
    """3x3x3 SAME conv as three 2-D convs over the z-windows of the
    D-padded input, summed (JAX ``conv3d_zsum``): ``out[z] = sum_dz
    conv2d(x[z - 1 + dz], w[dz])``, each 2-D conv rounded to ``dtype``
    and the sum and bias taken in ``dtype``, as JAX sums them. x (B, D,
    H, W, Cin), w (3, 3, 3, Cin, Cout)."""
    if tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d_zsum expects 3x3x3 kernels, got "
                         f"{tuple(w.shape)}")
    b, d, h, wd, c = x.shape
    xp = F.pad(x.to(dtype), (0, 0, 0, 0, 0, 0, 1, 1))
    out = None
    for dz in range(3):
        x2 = xp[:, dz:dz + d].reshape(b * d, h, wd, c).permute(0, 3, 1, 2)
        w2 = w[dz].to(dtype).permute(3, 2, 0, 1).contiguous()
        y = accumulate(lambda a, k: F.conv2d(a, k, padding=1), x2, w2)
        out = y if out is None else out + y
    out = out.permute(0, 2, 3, 1).reshape(b, d, h, wd, -1)
    if bias is not None:
        out = out + bias.to(dtype)
    return out.contiguous()


def conv3d_ksplit(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor = None,
                  dtype: torch.dtype = BF16,
                  valid_d: bool = False) -> torch.Tensor:
    """3x3x3 SAME conv as the JAX ``conv3d_ksplit``: one 2-D conv per
    depth tap, each rounded to ``dtype``, then a shifted three-slice sum
    in ``dtype``. ``valid_d`` as ``conv3d_zcat``'s: the taps' planes of
    the extended slab stand where the zero pad stands otherwise."""
    co = w.shape[-1]
    # (1, 3, 3, ci, 3*co): output block kz holds depth tap kz's 2-D kernel
    w2 = w.permute(1, 2, 3, 0, 4).reshape(1, 3, 3, w.shape[3], 3 * co)
    y = _conv3d(x, w2, (0, 1, 1), dtype)          # (B, D, H, W, 3co)
    yp = y if valid_d else F.pad(y, (0, 0, 0, 0, 0, 0, 1, 1))
    D = yp.shape[1] - 2
    out = (yp[:, 0:D, ..., 0:co] + yp[:, 1:1 + D, ..., co:2 * co]
           + yp[:, 2:2 + D, ..., 2 * co:3 * co])
    if bias is not None:
        out = out + bias.to(dtype)
    return out.contiguous()


def conv3d_3x3x3(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor = None,
                 dtype: torch.dtype = BF16,
                 valid_d: bool = False) -> torch.Tensor:
    """The formulation the JAX ``conv3d_3x3x3`` picks for this shape;
    ``valid_d``: VALID in D (``conv3d_zcat``'s)."""
    if w.shape[-1] <= KSPLIT_MAX_CO:
        return conv3d_ksplit(x, w, bias, dtype, valid_d)
    return conv3d_zcat(x, w, bias, dtype, valid_d)


def conv3d_slab(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                dtype: torch.dtype, group) -> torch.Tensor:
    """``conv3d_3x3x3`` of a volume D-sharded over ``group`` (the
    ``space`` group), on this rank's slab: the slab extended by one
    plane of each neighbour (zeros at the volume's ends) through the
    same formulation, VALID in D, so that the slab gets the unsharded
    conv's planes. The exchange carries the gradient back."""
    from ..parallel.spatial import halo_exchange_d
    return conv3d_3x3x3(halo_exchange_d(x.to(dtype), 1, group, "zero"), w,
                        bias, dtype, valid_d=True)


def quantize_weights_int8(w: torch.Tensor):
    """Symmetric per-output-channel int8 weights (JAX
    ``conv3d_zcat_int8``, ``ops/conv.py:225-228``): ``w_scale =
    max(max|w| over (kd, kh, kw, ci), 1e-12) / 127`` in f32 and ``wq =
    clip(round(w / w_scale), -127, 127)``, half to even. w (3, 3, 3, ci,
    co) -> (wq int8 of w's shape, w_scale f32 (co,))."""
    w = w.float()
    # 127 as a tensor on w's device: by a Python scalar, torch's CUDA
    # division multiplies by its reciprocal (not always the same bits)
    w_scale = w.abs().amax(dim=(0, 1, 2, 3)).clamp_min(1e-12) / torch.full(
        (), 127.0, device=w.device)
    wq = torch.round(w / w_scale).clamp(-127, 127).to(torch.int8)
    return wq, w_scale


def conv3d_zcat_int8(x: torch.Tensor, w: torch.Tensor, act_scale,
                     bias: torch.Tensor = None, weights=None) -> torch.Tensor:
    """Quantized 3x3x3 SAME conv, inference only (JAX
    ``conv3d_zcat_int8``): x (B, D, H, W, ci) any float, quantized per
    tensor as ``clip(round(x_f32 / act_scale), -127, 127)``; w (3, 3, 3,
    ci, co) per output channel (``quantize_weights_int8``); the int8
    products summed exactly, then ``y_f32 * (act_scale * w_scale)``,
    ``+ bias`` in f32 and one rounding to bf16. ``act_scale``: a scalar
    (f32 tensor or float). On CUDA tensors it launches the int8 kernel
    (``ops/conv_int8.py``), on the CPU it runs its plain version.
    ``weights``: w's ``prepare_weights_int8``, else prepared in the
    call."""
    if tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d_zcat_int8 expects 3x3x3 kernels, got "
                         f"{tuple(w.shape)}")
    from .conv_int8 import conv3d_int8
    return conv3d_int8(x, w, act_scale, bias, weights)


def conv_transpose3d_k2s2(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor = None,
                          dtype: torch.dtype = BF16) -> torch.Tensor:
    """ConvTranspose(kernel 2^3, stride 2^3) as a matmul and a
    depth-to-space (JAX ``conv_transpose3d_k2s2``). x (B, D, H, W, Cin),
    w (2, 2, 2, Cin, Cout) in flax's convention, which applies the
    kernel spatially flipped: out[2d+a, 2h+p, 2w+q] = x[d, h, w] @
    w[1-a, 1-p, 1-q]."""
    B, D, H, W, _ = x.shape
    ci, co = w.shape[3], w.shape[4]
    wf = w.flip(0, 1, 2).reshape(8, ci, co).permute(1, 0, 2)
    y = matmul(x, wf.reshape(ci, 8 * co), dtype)  # (B, D, H, W, 8co)
    y = y.reshape(B, D, H, W, 2, 2, 2, co).permute(0, 1, 4, 2, 5, 3, 6, 7)
    y = y.reshape(B, 2 * D, 2 * H, 2 * W, co)
    if bias is not None:
        y = y + bias.to(dtype)
    return y.contiguous()


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor = None,
            dtype: torch.dtype = BF16) -> torch.Tensor:
    """Pointwise conv as a channel matmul (JAX ``conv1x1``); w is
    (1, 1, 1, Cin, Cout) or (Cin, Cout)."""
    y = matmul(x, w.reshape(w.shape[-2], w.shape[-1]), dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def _kaiming_fan_out(shape, generator) -> torch.Tensor:
    """flax ``variance_scaling(2.0, "fan_out", "normal")`` for a
    (..., in, out) kernel."""
    fan_out = math.prod(shape[:-2]) * shape[-1]
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_out)


def set_compute_dtype(model: nn.Module, dtype) -> torch.dtype:
    """Set the compute dtype of every layer of ``model`` that has one
    (the JAX modules' ``dtype`` field); returns it as a torch dtype."""
    dtype = compute_dtype_of(dtype)
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return dtype


class _ConvParams(nn.Module):
    """``kernel`` (flax layout, f32) and optional ``bias`` parameters;
    the layer computes in ``compute_dtype``."""

    compute_dtype = BF16

    def __init__(self, kernel_shape, use_bias: bool, generator=None,
                 init="kaiming"):
        super().__init__()
        if init == "kaiming":
            k = _kaiming_fan_out(kernel_shape, generator)
        else:   # flax lecun_normal: fan-in scaled
            fan_in = math.prod(kernel_shape[:-1])
            k = (torch.randn(kernel_shape, generator=generator)
                 * math.sqrt(1.0 / fan_in))
        self.kernel = nn.Parameter(k)
        self.bias = (nn.Parameter(torch.zeros(kernel_shape[-1]))
                     if use_bias else None)


def conv_transpose3d_k2s2_halo(x: torch.Tensor, w: torch.Tensor,
                               bias: torch.Tensor = None,
                               dtype: torch.dtype = BF16) -> torch.Tensor:
    """The train route of the decoder-last up conv: the library
    transposed conv (k = s = 2; flax's kernel flipped into torch's
    (Cin, Cout, 2, 2, 2)) in ``dtype``, the bias added in ``dtype``,
    padded into the halo layout (B, 2D+2, 2H+2, 2W+2, Cout) with
    ``F.pad``. Same function as K2, with a backward (JAX: the s2d-out up
    and the XLA pad, ``models/unet3d.py:772-792``)."""
    wt = w.to(dtype).flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    y = accumulate(lambda a, b: F.conv_transpose3d(a, b, stride=2),
                   x.to(dtype).permute(0, 4, 1, 2, 3), wt)
    y = y.permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.to(dtype)
    return F.pad(y, (0, 0, 1, 1, 1, 1, 1, 1))


class Conv1x1(_ConvParams):
    """Pointwise conv; parameters as flax ``nn.Conv(features, (1,1,1))``."""

    def __init__(self, cin: int, features: int, use_bias: bool = True,
                 generator=None):
        super().__init__((1, 1, 1, cin, features), use_bias, generator)

    def forward(self, x):
        return conv1x1(x, self.kernel, self.bias, self.compute_dtype)


QUANT_MODES = ("off", "calib", "int8")


class FastConv3D(_ConvParams):
    """3x3x3 SAME conv; parameters as flax ``nn.Conv(features, (3,3,3))``.

    ``quant_mode`` (JAX ``FastConv3D.quant_mode``): ``"off"``, the conv in
    ``compute_dtype``; ``"calib"``, the same conv, and the buffer
    ``absmax`` (not saved) keeps the largest ``max|x|`` of its inputs over
    calls (JAX's ``quant_stats`` sow); ``"int8"``, ``conv3d_zcat_int8``
    with the buffer ``act_scale`` (JAX's ``quant`` collection). Only a
    conv whose mode is not ``"off"`` has ``act_scale`` (1.0 until loaded,
    as JAX's init), so a model without quantization keeps its
    ``state_dict`` keys. In ``"int8"`` the kernel's prepared int8 weights
    are kept across calls in ``_int8_weights`` (a plain attribute, not
    state: ``Int8WeightCache``), prepared anew when ``kernel`` changes."""

    def __init__(self, cin: int, features: int, use_bias: bool = False,
                 generator=None, quant_mode: str = "off"):
        super().__init__((3, 3, 3, cin, features), use_bias, generator)
        from .conv_int8 import Int8WeightCache
        self._int8_weights = Int8WeightCache()
        self.set_quant_mode(quant_mode)

    def set_quant_mode(self, mode: str) -> None:
        """Switch this conv's ``quant_mode``, adding its ``act_scale`` and
        ``absmax`` buffers (or dropping them for ``"off"``); a loaded
        ``act_scale`` is kept across ``"calib"`` and ``"int8"``."""
        if mode not in QUANT_MODES:
            raise ValueError(f"quant_mode must be one of {QUANT_MODES}, got "
                             f"{mode!r}")
        self.quant_mode = mode
        self._int8_weights.clear()
        if mode == "off":
            self._buffers.pop("act_scale", None)
            self._buffers.pop("absmax", None)
        elif "act_scale" not in self._buffers:
            dev = self.kernel.device
            self.register_buffer("act_scale", torch.ones((), device=dev))
            self.register_buffer("absmax", torch.zeros((), device=dev),
                                 persistent=False)

    def forward(self, x, space_group=None):
        """``space_group``: ``x`` is this rank's D slab of a volume
        sharded over that group (``conv3d_slab``); not with
        quantization."""
        if self.quant_mode != "off" and space_group is not None:
            raise ValueError("quant_mode runs on whole volumes, not on D "
                             "slabs")
        if self.quant_mode == "calib":
            # |x| and its maximum are exact in x's dtype: no f32 copy
            self.absmax = torch.maximum(self.absmax, x.abs().amax().float())
        elif self.quant_mode == "int8":
            return conv3d_zcat_int8(x, self.kernel, self.act_scale, self.bias,
                                    self._int8_weights.get(self.kernel))
        if space_group is not None:
            return conv3d_slab(x, self.kernel, self.bias,
                               self.compute_dtype, space_group)
        return conv3d_3x3x3(x, self.kernel, self.bias, self.compute_dtype)


class FastConvTranspose3D(_ConvParams):
    """k=2, s=2 transposed conv; parameters as flax
    ``nn.ConvTranspose(features, (2,2,2), strides=(2,2,2))``."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__((2, 2, 2, cin, features), True, generator,
                         init="lecun")

    def forward(self, x):
        return conv_transpose3d_k2s2(x, self.kernel, self.bias,
                                     self.compute_dtype)

    def halo_train(self, x):
        """Into the halo layout, differentiable (the train path)."""
        return conv_transpose3d_k2s2_halo(x, self.kernel, self.bias,
                                          self.compute_dtype)
