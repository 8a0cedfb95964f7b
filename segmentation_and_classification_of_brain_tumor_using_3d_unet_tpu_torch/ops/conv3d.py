"""The 3x3x3 SAME conv of the unpadded NDHWC layout: K7, a hand-written
CUDA kernel (``csrc/conv3d_same.cu``), with its plain PyTorch version and
a differentiable op on it.

Counterpart of the JAX package's ``ops/pallas/conv3d.py``: the function
of ``ops/conv.py::conv3d_zcat`` (bf16 products, f32 accumulation, one
rounding) with ci and co multiples of 32, and its custom VJP. JAX's
``Plan``, ``build_wbig`` and its ``W % Tw`` condition are the TPU's
block-Toeplitz lane geometry; the kernel here needs none of them.

  * ``conv3d_same`` — the kernel's wrapper, bf16 or f32: on the card the
    bf16 form (``csrc/conv3d_same.cu``) or the f32 form
    (``csrc/conv3d_same_f32.cu``: six bf16 passes on the tensor cores
    over an exact split of x and of w; ``ops/conv.py::conv3d_split6`` is
    its plain mirror), on the CPU the plain version.
    ``conv3d_same.launches`` counts its launches.
  * ``wtile_conv3d`` — the op with gradients (JAX ``wtile_conv3d``): the
    forward and the data gradient on the kernel (the data gradient with
    the taps flipped and ci, co swapped, as JAX's backward), the weight
    gradient a library weight-grad conv with f32 accumulation, as JAX's
    is XLA's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv3d_weight

from .conv import BF16, f32_accumulate, full_f32, tf32_for_bf16
from .ps2d import _aligned, _check, _kernel_dtype, _lib, _on_cpu, _stream


def _check_widths(x: torch.Tensor, w: torch.Tensor) -> None:
    """JAX ``make_plan``'s eligibility: ci and co multiples of 32."""
    ci, co = x.shape[-1], w.shape[-1]
    if (x.ndim != 5 or tuple(w.shape) != (3, 3, 3, ci, co) or ci <= 0
            or co <= 0 or ci % 32 or co % 32):
        raise ValueError(f"wtile_conv3d: needs x (B, D, H, W, ci) and w "
                         f"(3, 3, 3, ci, co) with ci, co multiples of 32, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def _tf32(allowed: bool):
    """cuDNN's f32 convs in TF32 or not, for the duration (the counted
    sections of ``ops/conv.py``). TF32 holds a bf16 value exactly, so
    products of bf16 operands widened to f32 stay exact either way; true
    f32 operands need it off."""
    return tf32_for_bf16() if allowed else full_f32()


def wtile_conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: an f32 conv of x and of w cast to x.dtype,
    one rounding to x.dtype."""
    _check_widths(x, w)
    wn = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)
    with _tf32(x.dtype == BF16):
        y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), wn, padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def conv3d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K7: 3x3x3 SAME conv of x (B, D, H, W, ci) with w (3, 3, 3, ci, co)
    cast to x.dtype -> (B, D, H, W, co) in x.dtype; x bf16 or f32 (the
    f32 weights are not rounded, as JAX's are not)."""
    if _on_cpu(x):
        return wtile_conv3d_plain(x, w)
    _check_widths(x, w)
    dt = _kernel_dtype("wtile_conv3d", x)
    B, D, H, W, ci = x.shape
    co = w.shape[-1]
    x = _aligned(x)
    wk = _aligned(w.to(dt).reshape(27, ci, co))     # 16 B copies
    _check("wtile_conv3d x", x, dtype=dt)
    _check("wtile_conv3d w", wk, dtype=dt)
    y = torch.empty((B, D, H, W, co), dtype=dt, device=x.device)
    lib = _lib()
    if dt == BF16:
        code = lib.conv3d_same(x.data_ptr(), wk.data_ptr(), y.data_ptr(), B,
                               D, H, W, ci, co, _stream())
    else:
        # scratch for the weights' hi, mid and lo parts, which the launch
        # splits on the card before the conv
        parts = torch.empty((3, 27, ci, co), dtype=BF16, device=x.device)
        code = lib.conv3d_same_f32(x.data_ptr(), wk.data_ptr(),
                                   parts.data_ptr(), y.data_ptr(), B, D, H,
                                   W, ci, co, _stream())
    lib.check("conv3d_same", code)
    conv3d_same.launches += 1
    return y


conv3d_same.launches = 0


def conv3d_same_plan(B: int, D: int, H: int, W: int, ci: int, co: int,
                     dtype: torch.dtype = BF16) -> dict:
    """The launch geometry K7's ``dtype`` form picks for x (B, D, H, W,
    ci) -> co: output channels N a block, input channels KC per step, M
    output voxels (the GEMM rows) a block, the TD x TH x TW output patch,
    the block count and the dynamic shared memory in bytes."""
    import ctypes
    lib = _lib()
    fn = (lib._dll.conv3d_same_plan if dtype == BF16
          else lib._dll.conv3d_same_f32_plan)
    keys = ("N", "KC", "M", "TD", "TH", "TW", "blocks", "smem")
    fn.argtypes = (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    lib.check("conv3d_same_plan",
              fn(B, D, H, W, ci, co, ctypes.addressof(out)))
    return dict(zip(keys, out))


def wgmma_tile_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One 64 x n x 16 product a @ b (a (64, 16), b (16, n) bf16 on the
    card, n 32, 64 or 128) -> (64, n) f32 through K7's own operand path:
    its ldmatrix rows, its weight-slab layout and wgmma descriptor, its
    accumulator mapping. For tests: it tells a descriptor fault from an
    indexing fault in the conv."""
    import ctypes
    n = b.shape[-1]
    if (tuple(a.shape) != (64, 16) or tuple(b.shape) != (16, n)
            or n not in (32, 64, 128)):
        raise ValueError(f"wgmma_tile_product: needs (64, 16) @ (16, n), "
                         f"n in 32/64/128, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    a, b = _aligned(a), _aligned(b)
    _check("wgmma_tile_product a", a)
    _check("wgmma_tile_product b", b)
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    lib = _lib()
    fn = lib._dll.conv3d_same_wgmma_probe
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    lib.check("conv3d_same_wgmma_probe", fn(a.data_ptr(), b.data_ptr(),
                                            d.data_ptr(), n, _stream()))
    return d


def conv3d_same_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The data gradient of the conv for the cotangent ``g``: the same
    conv of g with the taps flipped and ci, co swapped (JAX ``_bwd``,
    ``conv3d.py:358-363``)."""
    return conv3d_same(g, w.flip(0, 1, 2).transpose(3, 4))


def conv3d_same_wgrad(x: torch.Tensor, g: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The weight gradient (3, 3, 3, ci, co) in ``dtype``: a library
    weight-grad conv with f32 accumulation, rounded once (JAX: 27 f32
    einsums in XLA cast to w's dtype, ``conv3d.py:366-379``). bf16
    operands for a bf16 result run the library's bf16 conv (exact
    products, f32 sums, one rounding); otherwise the operands are widened
    to f32 (TF32 allowed only for bf16 values, which it holds exactly)."""
    ci, co = x.shape[-1], g.shape[-1]
    xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)

    def wgrad(a, b):
        return conv3d_weight(a, (co, ci, 3, 3, 3), b, padding=1)

    bf = x.dtype == BF16 and g.dtype == BF16
    if bf and dtype == BF16:
        dw = f32_accumulate(wgrad, xn, gn)
    else:
        with _tf32(bf):
            dw = wgrad(xn.float(), gn.float())
    return dw.permute(2, 3, 4, 1, 0).to(dtype).contiguous()


class _WtileConv3d(torch.autograd.Function):
    """K7 with a backward (JAX ``wtile_conv3d``'s custom VJP,
    ``conv3d.py:350-383``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_same(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = (conv3d_same_dgrad(g, w).to(x.dtype)
              if ctx.needs_input_grad[0] else None)
        dw = (conv3d_same_wgrad(x, g, w.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def wtile_conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K7's op (JAX ``wtile_conv3d``): 3x3x3 SAME conv over unpadded NDHWC
    with gradients to x and to w. ci and co must be multiples of 32
    (``ValueError`` otherwise). On CUDA tensors the forward and the data
    gradient launch K7 (its bf16 or f32 form, by x's dtype); on the CPU
    they run its plain version."""
    return _WtileConv3d.apply(x, w)
