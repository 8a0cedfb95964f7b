"""The int8 3x3x3 SAME conv of int8 serving: Q8, a hand-written CUDA
kernel (``csrc/conv3d_int8.cu``), with its plain PyTorch version.

It computes ``ops/conv.py::conv3d_zcat_int8`` (JAX ``conv3d_zcat_int8``,
``ops/conv.py:197-285``), which in JAX is an XLA conv, not a Pallas
kernel, so this kernel replaces no TPU kernel. JAX's ``SEG3D_INT8_FORM``
and ``SEG3D_INT8_ACC`` switches pick among TPU formulations of this one
function (``tests/test_quant.py:108-125``); the port has one form.

  * ``conv3d_int8`` — the wrapper: on the card the kernel (the weights
    quantized once a call into its K-major int8 layout, x quantized as it
    is loaded, int8 tensor-core products summed in int32, the f32
    epilogue and one rounding to bf16), on the CPU the plain version.
    ``conv3d_int8.launches`` counts its launches.
  * ``conv3d_int8_plain`` — the plain version: x and w quantized with the
    same f32 formulas, a float64 conv of the integer values (exact: every
    sum is an integer below 27 * ci * 127^2 < 2^53), then the same
    epilogue.
  * ``conv3d_int8_plan`` — the launch geometry the kernel picks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import BF16, F32, quantize_weights_int8
from .ps2d import _aligned, _check, _lib, _on_cpu, _stream

# the kernel's scratch of f32 weight maxima, one row a split of K
MAX_K_SPLITS = 32


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


def conv3d_int8_plain(x: torch.Tensor, w: torch.Tensor, act_scale,
                      bias: torch.Tensor = None) -> torch.Tensor:
    """Plain version of the int8 conv: x (B, D, H, W, ci) any float, w
    (3, 3, 3, ci, co), scalar ``act_scale``, optional bias (co,) -> (B, D,
    H, W, co) bf16."""
    _check_shapes(x, w)
    s = _act_scale(act_scale, x.device)
    wq, w_scale = quantize_weights_int8(w)
    xq = quantize_act_int8(x, s).to(torch.float64).permute(0, 4, 1, 2, 3)
    wn = wq.to(torch.float64).permute(4, 3, 0, 1, 2)
    y = F.conv3d(xq, wn, padding=1).permute(0, 2, 3, 4, 1).float()
    y = y * (s * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(BF16).contiguous()


def conv3d_int8(x: torch.Tensor, w: torch.Tensor, act_scale,
                bias: torch.Tensor = None) -> torch.Tensor:
    """The int8 conv (``conv3d_int8_plain``'s function): on CUDA tensors
    the kernel, for x bf16 or f32 of any ci and co a multiple of 8; on the
    CPU the plain version."""
    if _on_cpu(x):
        return conv3d_int8_plain(x, w, act_scale, bias)
    _check_shapes(x, w)
    if x.dtype not in (BF16, F32):
        raise ValueError(f"conv3d_int8: x must be bfloat16 or float32, got "
                         f"{x.dtype}")
    B, D, H, W, ci = x.shape
    co = w.shape[-1]
    if co % 8:
        raise ValueError(f"conv3d_int8: co must be a multiple of 8, got {co}")
    cip = -(-ci // 32) * 32
    x = _aligned(x)
    wf = _aligned(w.float())
    s = _aligned(_act_scale(act_scale, x.device).reshape(1))
    b = None if bias is None else _aligned(bias.float())
    _check("conv3d_int8 x", x, dtype=x.dtype)
    _check("conv3d_int8 w", wf, dtype=F32)
    _check("conv3d_int8 act_scale", s, (1,), F32)
    if b is not None:
        _check("conv3d_int8 bias", b, (co,), F32)
    # scratch: the quantized weights (co, 27, cip) K-major, then w_scale
    # (co,) and the per-split maxima (MAX_K_SPLITS, co)
    wq = torch.empty((co, 27, cip), dtype=torch.int8, device=x.device)
    f32s = torch.empty((1 + MAX_K_SPLITS, co), dtype=F32, device=x.device)
    y = torch.empty((B, D, H, W, co), dtype=BF16, device=x.device)
    lib = _lib()
    code = lib.conv3d_int8(x.data_ptr(), int(x.dtype == BF16), wf.data_ptr(),
                           s.data_ptr(), None if b is None else b.data_ptr(),
                           wq.data_ptr(), f32s.data_ptr(), y.data_ptr(), B, D,
                           H, W, ci, co, _stream())
    lib.check("conv3d_int8", code)
    conv3d_int8.launches += 1
    return y


conv3d_int8.launches = 0


def conv3d_int8_plan(B: int, D: int, H: int, W: int, ci: int, co: int
                     ) -> dict:
    """The launch geometry the kernel picks for x (B, D, H, W, ci) -> co:
    output channels N a block, the TB x TD x TH x TW output patch (its
    voxels the GEMM rows), the conv's blocks and dynamic shared memory in
    bytes, and the weight quantization's splits of K."""
    import ctypes
    lib = _lib()
    fn = lib._dll.conv3d_int8_plan
    keys = ("N", "TB", "TD", "TH", "TW", "blocks", "smem", "k_splits")
    fn.argtypes = (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    lib.check("conv3d_int8_plan",
              fn(B, D, H, W, ci, co, ctypes.addressof(out)))
    return dict(zip(keys, out))
