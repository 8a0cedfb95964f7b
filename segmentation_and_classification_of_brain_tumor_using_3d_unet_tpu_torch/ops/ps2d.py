"""The level-0 region of the eval forward: three hand-written CUDA
kernels and the torch glue between them.

Counterpart of the JAX package's ``ops/pallas/ps2d.py``. There the
region's tensors live in a packed space-to-depth "flat" form that fills
the TPU's 128-wide lanes. Here they live in the HALO LAYOUT:
channels-last bf16 with a one-voxel zero halo on D, H and W,
``(B, D+2, H+2, W+2, C)``. A 3x3x3 SAME conv reads it without any
bounds logic, and every op below keeps the halo exactly zero, as the
flat form keeps its pads. Statistics divide by the true voxel count.

Kernels (``csrc/``), each with its plain PyTorch version beside it:

  * ``pack_halo`` (K3) — NDHWC -> halo layout (JAX ``pack_flat_fast``);
  * ``up_k2s2_into_halo`` (K2) — k=2 s=2 transposed conv into the halo
    layout (JAX ``up_k2s2_into_flat``);
  * ``conv3d_halo`` (K1) — 3x3x3 conv over 1-2 halo inputs with the
    on-load affine / ReLU / mask and the output statistics (JAX
    ``ps2d_conv3d_flat_multi``).

A wrapper takes its plain version for tensors on the CPU only; for a
CUDA tensor it launches its kernel or raises. Each keeps a count of its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import BF16, f32_accumulate, matmul_bf16
from .norm import apply_affine_bf16, bf16_moments, group_affine
from .pool import max_pool3d

# ----------------------------------------------------------------------
# launch plumbing
# ----------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(name: str, t: torch.Tensor, shape=None, dtype=BF16) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, contiguous,
    16 B aligned, and (where given) its shape."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous CUDA {dtype} tensor, "
                         f"got {t.dtype} on {t.device}, contiguous="
                         f"{t.is_contiguous()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16 B aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _lib():
    from .native import library
    return library()


# ----------------------------------------------------------------------
# halo-layout helpers
# ----------------------------------------------------------------------


def halo_mask(x: torch.Tensor) -> torch.Tensor:
    """(1, D+2, H+2, W+2, 1) mask of a halo tensor: 1 inside, 0 on the
    halo, in ``x``'s dtype."""
    Dp, Hp, Wp = x.shape[1:4]
    m = torch.zeros((1, Dp, Hp, Wp, 1), dtype=x.dtype, device=x.device)
    m[:, 1:-1, 1:-1, 1:-1] = 1
    return m


def interior_count(x: torch.Tensor) -> int:
    """True voxels of a halo tensor: D * H * W."""
    Dp, Hp, Wp = x.shape[1:4]
    return (Dp - 2) * (Hp - 2) * (Wp - 2)


def halo_to_normal(x: torch.Tensor) -> torch.Tensor:
    """Halo layout -> NDHWC (region exit; JAX ``flat_to_normal``)."""
    return x[:, 1:-1, 1:-1, 1:-1].contiguous()


# ----------------------------------------------------------------------
# K3: pack_halo
# ----------------------------------------------------------------------


def pack_halo_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (B, D, H, W, C) -> (B, D+2, H+2, W+2, C)
    with a zero halo."""
    B, D, H, W, C = x.shape
    y = x.new_zeros((B, D + 2, H + 2, W + 2, C))
    y[:, 1:-1, 1:-1, 1:-1] = x
    return y


def pack_halo(x: torch.Tensor) -> torch.Tensor:
    """K3 (JAX ``pack_flat_fast``): NDHWC bf16 -> halo layout. C must
    be a multiple of 8."""
    if _on_cpu(x):
        return pack_halo_plain(x)
    B, D, H, W, C = x.shape
    if C % 8 or x.numel() == 0:
        raise ValueError(f"pack_halo: needs C % 8 == 0 and a non-empty "
                         f"tensor, got {tuple(x.shape)}")
    _check("pack_halo x", x)
    y = torch.empty((B, D + 2, H + 2, W + 2, C), dtype=BF16,
                    device=x.device)
    lib = _lib()
    lib.check("pack_halo", lib.pack_halo(x.data_ptr(), y.data_ptr(),
                                         B, D, H, W, C, _stream()))
    pack_halo.launches += 1
    return y


pack_halo.launches = 0


# ----------------------------------------------------------------------
# K2: up_k2s2_into_halo
# ----------------------------------------------------------------------


def _phase_weights(w: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, ci, co) flax ConvTranspose kernel -> (8, ci, co) bf16
    with phase k = (a*2 + p)*2 + q holding the flipped tap."""
    return w.to(BF16).flip(0, 1, 2).reshape(8, w.shape[3], w.shape[4])


def up_k2s2_into_halo_plain(x: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor = None) -> torch.Tensor:
    """Plain version of K2: f32 dot of the bf16 operands plus the f32
    bias, one rounding to bf16, interleaved and packed into the halo
    layout."""
    B, D2, H2, W2, ci = x.shape
    co = w.shape[-1]
    wk = _phase_weights(w).permute(1, 0, 2).reshape(ci, 8 * co).float()
    y = x.float() @ wk
    if bias is not None:
        y = y + bias.float().repeat(8)
    y = y.to(BF16).reshape(B, D2, H2, W2, 2, 2, 2, co)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, 2 * D2, 2 * H2,
                                                  2 * W2, co)
    return pack_halo_plain(y)


def up_k2s2_into_halo(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor = None) -> torch.Tensor:
    """K2 (JAX ``up_k2s2_into_flat``): ConvTranspose(k=2^3, s=2^3) of
    x (B, D2, H2, W2, ci) bf16 with the flax kernel w (2, 2, 2, ci, co)
    and an optional f32 bias, emitted as the halo layout
    (B, 2*D2+2, 2*H2+2, 2*W2+2, co). ci and co must be multiples of 8."""
    if _on_cpu(x):
        return up_k2s2_into_halo_plain(x, w, bias)
    B, D2, H2, W2, ci = x.shape
    co = w.shape[-1]
    if tuple(w.shape) != (2, 2, 2, ci, co) or ci % 8 or co % 8 \
            or x.numel() == 0:
        raise ValueError(f"up_k2s2_into_halo: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} need ci, co % 8 == 0")
    _check("up_k2s2_into_halo x", x)
    wk = _phase_weights(w).contiguous()
    _check("up_k2s2_into_halo w", wk)
    b = None
    if bias is not None:
        b = bias.float().contiguous()
        _check("up_k2s2_into_halo bias", b, (co,), torch.float32)
    y = torch.empty((B, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2, co),
                    dtype=BF16, device=x.device)
    lib = _lib()
    lib.check("up_k2s2_into_halo", lib.up_k2s2_into_halo(
        x.data_ptr(), wk.data_ptr(), _ptr(b), y.data_ptr(), B, D2, H2, W2,
        ci, co, _stream()))
    up_k2s2_into_halo.launches += 1
    return y


up_k2s2_into_halo.launches = 0


# ----------------------------------------------------------------------
# K1: conv3d_halo
# ----------------------------------------------------------------------


def _affine_pair(in_scale, in_shift, B, ci_total, device):
    sc = (in_scale if in_scale is not None
          else torch.ones((B, ci_total), device=device))
    sh = (in_shift if in_shift is not None
          else torch.zeros((B, ci_total), device=device))
    return sc.to(BF16).contiguous(), sh.to(BF16).contiguous()


def _transform_inputs(xs, in_scale, in_shift, in_relu, in_mul0):
    """The on-load transform of K1 as tensor ops, each step rounded to
    bf16 as the kernel rounds it."""
    B = xs[0].shape[0]
    affine = in_scale is not None or in_shift is not None
    if affine:
        in_scale, in_shift = _affine_pair(
            in_scale, in_shift, B, sum(x.shape[-1] for x in xs),
            xs[0].device)
    vs, off = [], 0
    for i, x in enumerate(xs):
        ci = x.shape[-1]
        v = x
        if affine:
            sc = in_scale[:, off:off + ci].reshape(B, 1, 1, 1, ci)
            sh = in_shift[:, off:off + ci].reshape(B, 1, 1, 1, ci)
            v = v * sc + sh
            if in_relu:
                v = torch.relu(v)
            v = v * halo_mask(v)
        if i == 0 and in_mul0 is not None:
            v = v * in_mul0
        vs.append(v)
        off += ci
    return vs


def conv3d_halo_plain(xs, w, in_scale=None, in_shift=None, in_relu=False,
                      in_mul0=None, emit_stats=False):
    """Plain version of K1: transform, concat, one VALID conv over the
    halo (== SAME conv of the interior) with f32 accumulation."""
    vs = _transform_inputs(xs, in_scale, in_shift, in_relu, in_mul0)
    xcat = torch.cat(vs, dim=-1) if len(vs) > 1 else vs[0]
    wn = w.to(BF16).permute(4, 3, 0, 1, 2).contiguous()
    y = f32_accumulate(F.conv3d, xcat.permute(0, 4, 1, 2, 3), wn)
    y = y.permute(0, 2, 3, 4, 1)                  # (B, D, H, W, co)
    out = pack_halo_plain(y)
    if not emit_stats:
        return out
    yf = y.float()
    return out, (yf.sum((1, 2, 3)), yf.square().sum((1, 2, 3)))


def conv3d_halo(xs, w, in_scale=None, in_shift=None, in_relu=False,
                in_mul0=None, emit_stats=False):
    """K1 (JAX ``ps2d_conv3d_flat_multi``): bias-free 3x3x3 SAME conv
    of the channel concat of 1-2 halo tensors (the concat is never
    stored), bf16 in, f32 accumulation, bf16 halo-layout out.

    * ``in_scale`` / ``in_shift`` (B, sum ci): per-channel affine on
      load (the previous GroupNorm), optionally followed by ReLU
      (``in_relu``); the halo stays zero.
    * ``in_mul0`` (same shape as ``xs[0]``): per-voxel, per-channel
      multiplier on input 0 (the attention gate's psi * SE).
    * ``emit_stats``: also return ``(s1, s2)``, each (B, co) f32, the
      per-channel sum and sum of squares of the bf16 output.

    Kernel limits: each input's channels a multiple of 32, co in
    (16, 32, 64)."""
    xs = tuple(xs)
    if in_relu and in_scale is None and in_shift is None:
        raise ValueError("conv3d_halo: in_relu applies after an affine")
    if _on_cpu(xs[0]):
        return conv3d_halo_plain(xs, w, in_scale, in_shift, in_relu,
                                 in_mul0, emit_stats)
    B, Dp, Hp, Wp, _ = xs[0].shape
    cis = [x.shape[-1] for x in xs]
    ci_total, co = sum(cis), w.shape[-1]
    if (len(xs) > 2 or any(c % 32 for c in cis) or co not in (16, 32, 64)
            or min(Dp, Hp, Wp) < 3
            or tuple(w.shape) != (3, 3, 3, ci_total, co)):
        raise ValueError(
            f"conv3d_halo: unsupported inputs {[tuple(x.shape) for x in xs]}"
            f" / kernel {tuple(w.shape)} (1-2 inputs, ci % 32 == 0, co in "
            f"16/32/64)")
    for i, x in enumerate(xs):
        _check(f"conv3d_halo x{i}", x, (B, Dp, Hp, Wp, cis[i]))
    wb = w.to(BF16).contiguous()
    _check("conv3d_halo w", wb)
    sc = sh = None
    if in_scale is not None or in_shift is not None:
        sc, sh = _affine_pair(in_scale, in_shift, B, ci_total, xs[0].device)
        _check("conv3d_halo in_scale", sc, (B, ci_total))
        _check("conv3d_halo in_shift", sh, (B, ci_total))
    if in_mul0 is not None:
        _check("conv3d_halo in_mul0", in_mul0, xs[0].shape)
    y = torch.empty((B, Dp, Hp, Wp, co), dtype=BF16, device=xs[0].device)
    stats = (torch.zeros((B, 2, co), dtype=torch.float32,
                         device=xs[0].device) if emit_stats else None)
    lib = _lib()
    lib.check("conv3d_halo", lib.ps2d_conv3d(
        xs[0].data_ptr(), _ptr(xs[1]) if len(xs) > 1 else None, cis[0],
        cis[1] if len(xs) > 1 else 0, wb.data_ptr(), _ptr(sc), _ptr(sh),
        int(in_relu), _ptr(in_mul0), y.data_ptr(), _ptr(stats),
        B, Dp - 2, Hp - 2, Wp - 2, co, _stream()))
    conv3d_halo.launches += 1
    if not emit_stats:
        return y
    return y, (stats[:, 0], stats[:, 1])


conv3d_halo.launches = 0

KERNELS = (conv3d_halo, up_k2s2_into_halo, pack_halo)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


# ----------------------------------------------------------------------
# glue between the kernels (JAX ps2d.py:923-1074, as torch ops)
# ----------------------------------------------------------------------


def group_norm_halo_affine(x: torch.Tensor, gamma, beta, num_groups: int,
                           eps: float = 1e-5, sums=None):
    """GroupNorm statistics of a halo tensor -> per-channel (scale,
    shift), each (B, C) f32 (JAX ``group_norm_flat_affine``). ``sums``:
    K1's emitted (sum, sum of squares); without them the statistics
    are read from ``x`` (f32 accumulation, squares rounded to bf16)."""
    n = interior_count(x)
    if sums is None:
        s1, s2 = bf16_moments(x, n)
    else:
        s1, s2 = sums[0] / n, sums[1] / n
    return group_affine(s1, s2, gamma, beta, num_groups, eps)


def group_norm_halo(x: torch.Tensor, gamma, beta, num_groups: int,
                    eps: float = 1e-5, sums=None) -> torch.Tensor:
    """GroupNorm of a halo tensor, applied in bf16, halo re-zeroed
    (JAX ``group_norm_flat``)."""
    scale, shift = group_norm_halo_affine(x, gamma, beta, num_groups, eps,
                                          sums)
    return apply_affine_bf16(x, scale, shift) * halo_mask(x)


def conv1x1_halo(xs, w: torch.Tensor, bias=None, se0=None,
                 psi0=None) -> torch.Tensor:
    """Pointwise conv over the channel concat of halo tensors (JAX
    ``conv1x1_flat``), halo re-zeroed. ``se0`` (B, ci_0) folds the
    gate's channel factor into input 0's weights per batch item;
    ``psi0`` (B, D+2, H+2, W+2, 1) scales input 0's contribution per
    voxel — the gated input is never formed."""
    w2 = w.reshape(w.shape[-2], w.shape[-1]).to(BF16)
    y, off = None, 0
    for i, x in enumerate(xs):
        ci = x.shape[-1]
        wi = w2[off:off + ci]
        off += ci
        if i == 0 and se0 is not None:
            wi = wi[None] * se0.to(BF16)[:, :, None]     # (B, ci, co)
            t = matmul_bf16(x.reshape(x.shape[0], -1, ci), wi)
            t = t.reshape(*x.shape[:-1], -1)
        else:
            t = matmul_bf16(x, wi)
        if i == 0 and psi0 is not None:
            t = t * psi0
        y = t if y is None else y + t
    if bias is not None:
        y = y + bias.to(BF16)
    return y * halo_mask(y)


def global_avg_pool_halo(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) of a halo tensor over its true voxels ->
    (B, 1, 1, 1, C) in ``x.dtype`` (JAX ``global_avg_pool_flat``)."""
    s = x.sum((1, 2, 3), keepdim=True, dtype=torch.float32)
    return (s / interior_count(x)).to(x.dtype)


def max_pool3d_from_halo(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 max pool of a halo tensor -> the next level in NDHWC
    (JAX ``max_pool3d_from_flat``)."""
    return max_pool3d(x[:, 1:-1, 1:-1, 1:-1])
