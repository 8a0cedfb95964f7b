"""The ps2d regions of the eval forward (level 0, and level 1 at
``ps2d_levels=2``) and of the train forward (level 0): four hand-written
CUDA kernels, the differentiable conv built on K1, and the torch glue
between them.

Counterpart of the JAX package's ``ops/pallas/ps2d.py``. There the
region's tensors live in a packed space-to-depth "flat" form that fills
the TPU's 128-wide lanes. Here they live in the HALO LAYOUT:
channels-last with a one-voxel zero halo on D, H and W,
``(B, D+2, H+2, W+2, C)``, in the compute dtype (bf16 or f32, as JAX's
kernels compute in their input's dtype). A 3x3x3 SAME conv reads it
without any bounds logic, and every op below keeps the halo exactly
zero, as the flat form keeps its pads. Statistics divide by the true
voxel count.

Kernels (``csrc/``), each with its plain PyTorch version beside it:

  * ``pack_halo`` (K3) — NDHWC -> halo layout (JAX ``pack_flat_fast``);
  * ``up_k2s2_into_halo`` (K2) — k=2 s=2 transposed conv into the halo
    layout (JAX ``up_k2s2_into_flat``);
  * ``conv3d_halo`` (K1) — 3x3x3 conv over 1-2 halo inputs with the
    on-load affine / ReLU / mask and the output statistics (JAX
    ``ps2d_conv3d_flat_multi``).
  * ``pool_into_halo`` (K4) — 2x2x2 max pool of a halo tensor into the
    next level's halo layout, the level-1 region's entry (JAX
    ``pool_into_flat``);
  * ``conv3d_halo_train`` (K6) — K1 made differentiable (JAX
    ``ps2d_conv3d_flat_train``): forward and data gradient on K1, the
    weight gradient a library weight-grad conv. It has no kernel of its
    own: its launches are K1's, counted in ``conv3d_halo.launches``.

Each kernel has a bf16 and an f32 form (K3 and K4 one source
templated on the element type; K1 and K2 a source each, ``*_f32.cu``),
and each wrapper takes either dtype and returns its input's. K1's f32
form runs on the tensor cores as three bf16 passes over an exact split
of its activations (``ops/conv.py::split3_bf16`` mirrors the split), K2's
as six over an exact split of its activations and its weights
(``up_k2s2_into_halo_split6`` mirrors it).
A wrapper takes its plain version for tensors on the CPU only; for a
CUDA tensor it launches its kernel or raises. Each keeps a count of its
launches in ``<wrapper>.launches``.

On a D slab of a volume sharded over a ``space`` group, the region runs
per slab: K1 and K6 take ``d_live`` = (lo, hi), which says that plane 0
and/or plane D+1 of every input holds a D neighbour's values (written
there by ``parallel/spatial.py::halo_exchange_planes``) and is loaded
and transformed as the interior; the GroupNorms and the gate's pooling
sum over the slab and then over the ``group``. K2-K4 and the pointwise
glue need no neighbour while each slab's depth is even.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv3d_weight

from .conv import BF16, F32, SPLIT6_PASSES, accumulate, matmul, split3_bf16
from .norm import apply_affine, bf16_moments, group_affine, group_means
from .pool import max_pool3d

# no live D halo plane: the one-process region, and a slab at both ends
NO_LIVE = (False, False)

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


def _kernel_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The dtype a kernel runs in: its input's, bf16 or f32."""
    if t.dtype not in (BF16, F32):
        raise ValueError(f"{name}: the kernels take bfloat16 or float32, got "
                         f"{t.dtype}")
    return t.dtype


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16 B aligned data pointer (a copy if it is
    a view at an odd offset)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _lib():
    from .native import library
    return library()


# ----------------------------------------------------------------------
# halo-layout helpers
# ----------------------------------------------------------------------


def halo_mask(x: torch.Tensor, d_live=NO_LIVE) -> torch.Tensor:
    """(1, D+2, H+2, W+2, 1) mask of a halo tensor: 1 inside, 0 on the
    halo, in ``x``'s dtype; 1 also on a live D halo plane (``d_live`` =
    (plane 0, plane D+1))."""
    Dp, Hp, Wp = x.shape[1:4]
    lo, hi = (int(bool(v)) for v in d_live)
    m = torch.zeros((1, Dp, Hp, Wp, 1), dtype=x.dtype, device=x.device)
    m[:, 1 - lo:Dp - 1 + hi, 1:-1, 1:-1] = 1
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
    with a zero halo. Differentiable: the train path packs with it, as
    JAX trains with ``pack_flat`` (the XLA pad; K3 has no backward)."""
    return F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))


def pack_halo(x: torch.Tensor) -> torch.Tensor:
    """K3 (JAX ``pack_flat_fast``): NDHWC bf16 or f32 -> halo layout in
    x's dtype. C must be a multiple of 8."""
    if _on_cpu(x):
        return pack_halo_plain(x)
    B, D, H, W, C = x.shape
    if C % 8 or x.numel() == 0:
        raise ValueError(f"pack_halo: needs C % 8 == 0 and a non-empty "
                         f"tensor, got {tuple(x.shape)}")
    dt = _kernel_dtype("pack_halo", x)
    _check("pack_halo x", x, dtype=dt)
    y = torch.empty((B, D + 2, H + 2, W + 2, C), dtype=dt, device=x.device)
    lib = _lib()
    lib.check("pack_halo", lib.pack_halo(x.data_ptr(), int(dt == BF16),
                                         y.data_ptr(), B, D, H, W, C,
                                         _stream()))
    pack_halo.launches += 1
    return y


pack_halo.launches = 0


# ----------------------------------------------------------------------
# K2: up_k2s2_into_halo
# ----------------------------------------------------------------------


def _phase_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2, 2, 2, ci, co) flax ConvTranspose kernel -> (8, ci, co) in
    ``dtype`` (x's: rounded to bf16 for a bf16 x only, as JAX's K2 takes
    its weights in x.dtype) with phase k = (a*2 + p)*2 + q holding the
    flipped tap."""
    return w.to(dtype).flip(0, 1, 2).reshape(8, w.shape[3], w.shape[4])


def _phase_matrix(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(2, 2, 2, ci, co) flax kernel -> the GEMM's (ci, 8 co) in
    ``dtype``: column k co + o is phase k's tap of output channel o."""
    return _phase_weights(w, dtype).permute(1, 0, 2).reshape(
        w.shape[3], 8 * w.shape[4])


def _phases_into_halo(y: torch.Tensor, x_shape) -> torch.Tensor:
    """The GEMM's output (B*D2*H2*W2, 8 co) for an x of ``x_shape``,
    interleaved and packed into the halo layout (B, 2*D2+2, 2*H2+2,
    2*W2+2, co)."""
    B, D2, H2, W2, _ = x_shape
    co = y.shape[-1] // 8
    y = y.reshape(B, D2, H2, W2, 2, 2, 2, co)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, 2 * D2, 2 * H2,
                                                  2 * W2, co)
    return pack_halo_plain(y)


def up_k2s2_into_halo_plain(x: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor = None) -> torch.Tensor:
    """Plain version of K2: f32 dot of the operands in x's dtype plus the
    f32 bias, one rounding to x's dtype, interleaved and packed into the
    halo layout."""
    y = accumulate(torch.matmul, x.float(), _phase_matrix(w, x.dtype).float())
    if bias is not None:
        y = y + bias.float().repeat(8)
    return _phases_into_halo(y.to(x.dtype), x.shape)


def up_k2s2_into_halo_split6(x: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor = None,
                             dtype: torch.dtype = torch.float64,
                             passes=SPLIT6_PASSES) -> torch.Tensor:
    """Plain mirror of K2's f32 form: the GEMM of f32 ``x`` with the f32
    phase weights as six GEMMs of their bf16 parts (``split3_bf16``,
    ``SPLIT6_PASSES``: (x's part, w's part)), each computed in ``dtype``
    and summed in it pass by pass in the kernel's order, then the bias in
    ``dtype``, into the halo layout in ``dtype``; ``passes`` a subset of
    them (one pass's share, or the sum without one). For the tests and
    the card's check that the gates see a dropped pass."""
    xs = split3_bf16(x)
    ws = split3_bf16(_phase_matrix(w, F32))
    out = None
    for i, j in passes:
        y = torch.matmul(xs[i].to(dtype), ws[j].to(dtype))
        out = y if out is None else out + y
    if bias is not None:
        out = out + bias.to(dtype).repeat(8)
    return _phases_into_halo(out, x.shape)


def up_k2s2_into_halo(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor = None) -> torch.Tensor:
    """K2 (JAX ``up_k2s2_into_flat``): ConvTranspose(k=2^3, s=2^3) of
    x (B, D2, H2, W2, ci) bf16 or f32 with the flax kernel w (2, 2, 2,
    ci, co) taken in x's dtype and an optional f32 bias, emitted as the
    halo layout (B, 2*D2+2, 2*H2+2, 2*W2+2, co) in x's dtype. ci and co
    must be multiples of 8."""
    if _on_cpu(x):
        return up_k2s2_into_halo_plain(x, w, bias)
    B, D2, H2, W2, ci = x.shape
    co = w.shape[-1]
    if tuple(w.shape) != (2, 2, 2, ci, co) or ci % 8 or co % 8 \
            or x.numel() == 0:
        raise ValueError(f"up_k2s2_into_halo: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} need ci, co % 8 == 0")
    dt = _kernel_dtype("up_k2s2_into_halo", x)
    _check("up_k2s2_into_halo x", x, dtype=dt)
    # bf16 (8, ci, co); f32 the GEMM's (ci, 8 co)
    wk = _aligned(_phase_weights(w, dt) if dt == BF16
                  else _phase_matrix(w, dt))
    _check("up_k2s2_into_halo w", wk, dtype=dt)
    b = None
    if bias is not None:
        b = _aligned(bias.float())
        _check("up_k2s2_into_halo bias", b, (co,), F32)
    y = torch.empty((B, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2, co),
                    dtype=dt, device=x.device)
    lib = _lib()
    entry = lib.up_k2s2_into_halo if dt == BF16 else lib.up_k2s2_into_halo_f32
    lib.check("up_k2s2_into_halo", entry(
        x.data_ptr(), wk.data_ptr(), _ptr(b), y.data_ptr(), B, D2, H2, W2,
        ci, co, _stream()))
    up_k2s2_into_halo.launches += 1
    return y


up_k2s2_into_halo.launches = 0


def up_k2s2_plan(B: int, D2: int, H2: int, W2: int, ci: int, co: int,
                 dtype: torch.dtype = BF16) -> dict:
    """The launch geometry K2's ``dtype`` form picks for x (B, D2, H2,
    W2, ci) -> co: R input rows a tile of 64 GEMM rows (W2 <= 64) or tpr
    tiles a row, KC input channels a K chunk and nK chunks, P of the four
    (a, p) output-row pairs and CW channels a weight slab (NS = 2 P CW
    GEMM columns), the slabs, S input-tile buffers, the tiles and halo
    rows, the dynamic shared memory in bytes and the block count."""
    import ctypes
    lib = _lib()
    fn = (lib._dll.up_k2s2_plan if dtype == BF16
          else lib._dll.up_k2s2_f32_plan)
    fn.argtypes = (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    keys = ("R", "tpr", "KC", "nK", "P", "CW", "NS", "slabs", "S", "tiles",
            "halo_rows", "smem", "blocks")
    out = (ctypes.c_int * len(keys))()
    lib.check("up_k2s2_plan", fn(B, D2, H2, W2, ci, co,
                                 ctypes.addressof(out)))
    return dict(zip(keys, out))


# ----------------------------------------------------------------------
# K1: conv3d_halo
# ----------------------------------------------------------------------


def _affine_pair(in_scale, in_shift, B, ci_total, device, dtype):
    sc = (in_scale if in_scale is not None
          else torch.ones((B, ci_total), device=device))
    sh = (in_shift if in_shift is not None
          else torch.zeros((B, ci_total), device=device))
    return _aligned(sc.to(dtype)), _aligned(sh.to(dtype))


def _k1_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K1's weights in ``dtype``, their values rounded to bf16 first (JAX
    ``pack_w_rot``, ``ps2d.py:413-414``, in either dtype). In f32 the
    rounding passes the gradient straight through, as JAX's VJP
    differentiates the unrounded weights."""
    wr = w.to(BF16)
    if dtype == BF16:
        return wr
    w = w.to(dtype)
    return w + (wr.to(dtype) - w).detach()


def _transform_inputs(xs, in_scale, in_shift, in_relu, in_mul0,
                      d_live=NO_LIVE):
    """The on-load transform of K1 as tensor ops in the inputs' dtype,
    each step rounded as the kernel rounds it; a live D halo plane is
    transformed as the interior."""
    B = xs[0].shape[0]
    affine = in_scale is not None or in_shift is not None
    if affine:
        in_scale, in_shift = _affine_pair(
            in_scale, in_shift, B, sum(x.shape[-1] for x in xs),
            xs[0].device, xs[0].dtype)
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
            v = v * halo_mask(v, d_live)
        if i == 0 and in_mul0 is not None:
            v = v * in_mul0
        vs.append(v)
        off += ci
    return vs


def conv3d_halo_plain(xs, w, in_scale=None, in_shift=None, in_relu=False,
                      in_mul0=None, emit_stats=False, d_live=NO_LIVE):
    """Plain version of K1: transform, concat, one VALID conv over the
    halo (== SAME conv of the interior) with f32 accumulation, in the
    inputs' dtype with the weights' values rounded to bf16. The
    statistics are f32 sums (float64 ones for float64 inputs)."""
    vs = _transform_inputs(xs, in_scale, in_shift, in_relu, in_mul0,
                           d_live)
    xcat = torch.cat(vs, dim=-1) if len(vs) > 1 else vs[0]
    wn = _k1_weights(w, xcat.dtype).permute(4, 3, 0, 1, 2).contiguous()
    y = accumulate(F.conv3d, xcat.permute(0, 4, 1, 2, 3), wn)
    y = y.permute(0, 2, 3, 4, 1)                  # (B, D, H, W, co)
    out = pack_halo_plain(y)
    if not emit_stats:
        return out
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    return out, (yf.sum((1, 2, 3)), yf.square().sum((1, 2, 3)))


def conv3d_halo(xs, w, in_scale=None, in_shift=None, in_relu=False,
                in_mul0=None, emit_stats=False, d_live=NO_LIVE):
    """K1 (JAX ``ps2d_conv3d_flat_multi``): bias-free 3x3x3 SAME conv
    of the channel concat of 1-2 halo tensors (the concat is never
    stored), bf16 or f32 in, f32 accumulation, halo-layout out in the
    inputs' dtype. The weights' values are rounded to bf16 in either
    dtype, as JAX's kernel rounds them (so the f32 form's three bf16
    passes over an exact split of x' compute the f32 conv).

    * ``in_scale`` / ``in_shift`` (B, sum ci): per-channel affine on
      load (the previous GroupNorm), optionally followed by ReLU
      (``in_relu``); the halo stays zero.
    * ``in_mul0`` (same shape as ``xs[0]``): per-voxel, per-channel
      multiplier on input 0 (the attention gate's psi * SE).
    * ``emit_stats``: also return ``(s1, s2)``, each (B, co) f32, the
      per-channel sum and sum of squares of the output.
    * ``d_live`` (lo, hi): plane 0 / plane D+1 of every input (and of
      ``in_mul0``) holds a D neighbour's values, loaded and transformed
      as the interior; the output is this slab's interior with a zero
      halo, its statistics the interior's.

    Kernel limits: each input's channels a multiple of 32, co 16 or a
    multiple of 32."""
    xs = tuple(xs)
    if in_relu and in_scale is None and in_shift is None:
        raise ValueError("conv3d_halo: in_relu applies after an affine")
    if _on_cpu(xs[0]):
        return conv3d_halo_plain(xs, w, in_scale, in_shift, in_relu,
                                 in_mul0, emit_stats, d_live)
    B, Dp, Hp, Wp, _ = xs[0].shape
    cis = [x.shape[-1] for x in xs]
    ci_total, co = sum(cis), w.shape[-1]
    if (len(xs) > 2 or any(c % 32 for c in cis)
            or not (co == 16 or (co > 0 and co % 32 == 0))
            or min(Dp, Hp, Wp) < 3
            or tuple(w.shape) != (3, 3, 3, ci_total, co)):
        raise ValueError(
            f"conv3d_halo: unsupported inputs {[tuple(x.shape) for x in xs]}"
            f" / kernel {tuple(w.shape)} (1-2 inputs, ci % 32 == 0, co 16 "
            f"or a multiple of 32)")
    dt = _kernel_dtype("conv3d_halo", xs[0])
    for i, x in enumerate(xs):
        _check(f"conv3d_halo x{i}", x, (B, Dp, Hp, Wp, cis[i]), dt)
    # both forms take the weights as bf16 (the f32 form's split needs them
    # no wider: their values are bf16's in either dtype)
    wb = _aligned(_k1_weights(w, BF16))
    _check("conv3d_halo w", wb, dtype=BF16)
    sc = sh = None
    if in_scale is not None or in_shift is not None:
        sc, sh = _affine_pair(in_scale, in_shift, B, ci_total, xs[0].device,
                              dt)
        _check("conv3d_halo in_scale", sc, (B, ci_total), dt)
        _check("conv3d_halo in_shift", sh, (B, ci_total), dt)
    if in_mul0 is not None:
        _check("conv3d_halo in_mul0", in_mul0, xs[0].shape, dt)
    y = torch.empty((B, Dp, Hp, Wp, co), dtype=dt, device=xs[0].device)
    ci1 = cis[1] if len(xs) > 1 else 0
    # the kernel writes each block's sums; they are added here over the
    # blocks, in a fixed order (two runs give the same bits)
    parts = None
    if emit_stats:
        n_sp = conv3d_halo_plan(B, Dp - 2, Hp - 2, Wp - 2, cis[0], ci1,
                                co, dt)["blocks_per_item"]
        parts = torch.empty((B, n_sp, 2, co), dtype=torch.float32,
                            device=xs[0].device)
    lib = _lib()
    entry = lib.ps2d_conv3d if dt == BF16 else lib.ps2d_conv3d_f32
    lib.check("conv3d_halo", entry(
        xs[0].data_ptr(), _ptr(xs[1]) if len(xs) > 1 else None, cis[0],
        ci1, wb.data_ptr(), _ptr(sc), _ptr(sh),
        int(in_relu), _ptr(in_mul0), y.data_ptr(), _ptr(parts),
        B, Dp - 2, Hp - 2, Wp - 2, co, _stream(),
        int(bool(d_live[0])) | 2 * int(bool(d_live[1]))))
    conv3d_halo.launches += 1
    if not emit_stats:
        return y
    stats = parts.sum(1)
    return y, (stats[:, 0], stats[:, 1])


conv3d_halo.launches = 0


def conv3d_halo_plan(B: int, D: int, H: int, W: int, ci0: int, ci1: int,
                     co: int, dtype: torch.dtype = BF16) -> dict:
    """The launch geometry K1's ``dtype`` form picks for inputs of ci0
    (and ci1; 0 for one input) channels over a (B, D, H, W) interior ->
    co: output channels N a block, input channels KC per step, M output
    voxels (the GEMM rows) a block, the TD x TH x TW output patch, the
    block count, the dynamic shared memory in bytes, and the blocks a
    batch item and channel tile (the statistics buffer's block axis)."""
    import ctypes
    lib = _lib()
    fn = (lib._dll.ps2d_conv3d_plan if dtype == BF16
          else lib._dll.ps2d_conv3d_f32_plan)
    keys = ("N", "KC", "M", "TD", "TH", "TW", "blocks", "smem",
            "blocks_per_item")
    fn.argtypes = (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    lib.check("ps2d_conv3d_plan", fn(B, D, H, W, ci0, ci1, co,
                                     ctypes.addressof(out)))
    return dict(zip(keys, out))


# ----------------------------------------------------------------------
# K4: pool_into_halo
# ----------------------------------------------------------------------


def pool_into_halo_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the 2x2x2 max pool of a halo tensor, packed
    into the next level's halo layout."""
    return pack_halo_plain(max_pool3d_from_halo(x))


def pool_into_halo(x: torch.Tensor) -> torch.Tensor:
    """K4 (JAX ``pool_into_flat``): 2x2x2 stride-2 max pool of a halo
    tensor (B, D+2, H+2, W+2, C) bf16 or f32 -> (B, D/2+2, H/2+2,
    W/2+2, C) in its dtype with a zero halo. D, H, W must be even and C
    a multiple of 8."""
    if _on_cpu(x):
        return pool_into_halo_plain(x)
    B, Dp, Hp, Wp, C = x.shape
    D, H, W = Dp - 2, Hp - 2, Wp - 2
    if C % 8 or min(B, D, H, W) < 1 or D % 2 or H % 2 or W % 2:
        raise ValueError(f"pool_into_halo: needs an even, non-empty "
                         f"interior and C % 8 == 0, got {tuple(x.shape)}")
    dt = _kernel_dtype("pool_into_halo", x)
    _check("pool_into_halo x", x, dtype=dt)
    y = torch.empty((B, D // 2 + 2, H // 2 + 2, W // 2 + 2, C), dtype=dt,
                    device=x.device)
    lib = _lib()
    lib.check("pool_into_halo", lib.pool_into_halo(
        x.data_ptr(), int(dt == BF16), y.data_ptr(), B, D, H, W, C,
        _stream()))
    pool_into_halo.launches += 1
    return y


pool_into_halo.launches = 0

# ----------------------------------------------------------------------
# K6: conv3d_halo_train
# ----------------------------------------------------------------------


def conv3d_halo_dgrad(dy: torch.Tensor, w: torch.Tensor, i: int, cis,
                      d_live=NO_LIVE):
    """K6's data gradient for input ``i`` of a conv of inputs with
    ``cis`` channels: K1 on the cotangent ``dy`` (halo layout) with the
    flipped taps of that input's slice of ``w``, ci and co swapped (the
    transpose of a SAME 3x3x3 conv), and the identity on-load affine,
    as JAX's backward runs it (``ps2d.py:856-877``): the output's halo
    is a constant zero, so its cotangent must not reach dx. The plain K1
    zeroes the halo under an affine; the card's K1 never loads it.

    With a live D halo plane the input's planes 0 and D+1 were read too,
    and their cotangents go back to the neighbours that sent them: K1
    runs on dy's interior padded with two zero planes each side in D, a
    halo tensor of D+2 interior planes, whose output's interior is the
    cotangent of all D+2 input planes (H and W halo zero); a plane that
    was not live gets zero, as the one-process K6 gives its halo."""
    off = sum(cis[:i])
    w_t = w[:, :, :, off:off + cis[i]].flip(0, 1, 2).transpose(3, 4)
    ones = torch.ones((dy.shape[0], dy.shape[-1]), dtype=dy.dtype,
                      device=dy.device)
    if not any(d_live):
        return conv3d_halo((dy,), w_t, in_scale=ones, in_shift=ones * 0)
    dyp = F.pad(dy[:, 1:-1], (0, 0, 0, 0, 0, 0, 2, 2))
    dx = conv3d_halo((dyp,), w_t, in_scale=ones, in_shift=ones * 0)
    dx = dx[:, 1:-1]
    for plane, live in zip((0, -1), d_live):
        if not live:
            dx[:, plane] = 0
    return dx.contiguous()


def conv3d_halo_wgrad(xs, dy: torch.Tensor) -> torch.Tensor:
    """K6's weight gradient (3, 3, 3, sum ci, co) in dy's dtype: the
    library weight-grad conv per input (JAX: XLA's, outside Pallas) over
    the cotangent's interior, in f32 with TF32 off for f32 operands. A
    VALID weight grad over the input's zero halo is the SAME one over
    its interior."""
    dy_in = halo_to_normal(dy).permute(0, 4, 1, 2, 3)   # channels-last
    co = dy.shape[-1]
    dws = [accumulate(
        lambda a, b: conv3d_weight(a, (co, x.shape[-1], 3, 3, 3), b),
        x.permute(0, 4, 1, 2, 3), dy_in).permute(2, 3, 4, 1, 0)
        for x in xs]
    return (torch.cat(dws, dim=3) if len(dws) > 1 else dws[0]).contiguous()


class _ConvHaloTrain(torch.autograd.Function):
    """K1 with a backward (JAX ``ps2d_conv3d_flat_train``'s custom VJP,
    ``ps2d.py:839-890``): the data gradients on K1, the weight gradient
    a library call, both blind to the cotangent's halo. The weight
    gradient reads the inputs' live D halo planes as they are (their
    other halo voxels are zero)."""

    @staticmethod
    def forward(ctx, w, d_live, *xs):
        ctx.save_for_backward(w, *xs)
        ctx.d_live = d_live
        return conv3d_halo(xs, w, d_live=d_live)

    @staticmethod
    def backward(ctx, dy):
        w, *xs = ctx.saved_tensors
        dy = _aligned(dy)               # in its own dtype, the output's
        cis = [x.shape[-1] for x in xs]
        dxs = [conv3d_halo_dgrad(dy, w, i, cis, ctx.d_live)
               if ctx.needs_input_grad[2 + i] else None
               for i in range(len(xs))]
        dw = (conv3d_halo_wgrad(xs, dy).to(w.dtype)
              if ctx.needs_input_grad[0] else None)
        return (dw, None, *dxs)


def conv3d_halo_train(xs, w, d_live=NO_LIVE) -> torch.Tensor:
    """K6 (JAX ``ps2d_conv3d_flat_train``): ``conv3d_halo(xs, w)`` (bf16
    or f32 halo tensors in, the halo-layout output in their dtype) with
    gradients to every input and to ``w``. On CUDA tensors the forward
    and each input's data gradient launch K1 (counted in
    ``conv3d_halo.launches``); on the CPU they run K1's plain version.
    The weight gradient is a library weight-grad conv, as JAX's is
    XLA's (in f32 with TF32 off for f32 tensors). No fused transforms:
    the train path applies its GroupNorms as separate ops. ``d_live``
    as ``conv3d_halo``'s: the live planes are read, and each input's
    gradient then holds their cotangents too."""
    return _ConvHaloTrain.apply(w.to(xs[0].dtype), tuple(d_live), *xs)


def conv3d_halo_train_plain(xs, w, d_live=NO_LIVE) -> torch.Tensor:
    """Plain version of K6: autograd through ``conv3d_halo_plain``, the
    inputs' halos but their live D planes masked (zero, and passing no
    gradient) and the output's halo a constant (its cotangent
    dropped)."""
    xs = [x * halo_mask(x, d_live) for x in xs]
    return conv3d_halo_plain(xs, w.to(xs[0].dtype), d_live=d_live)


KERNELS = (conv3d_halo, up_k2s2_into_halo, pack_halo, pool_into_halo)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


# ----------------------------------------------------------------------
# glue between the kernels (JAX ps2d.py:923-1074, as torch ops)
# ----------------------------------------------------------------------


def group_norm_halo_affine(x: torch.Tensor, gamma, beta, num_groups: int,
                           eps: float = 1e-5, sums=None, group=None):
    """GroupNorm statistics of a halo tensor -> per-channel (scale,
    shift), each (B, C) f32 (JAX ``group_norm_flat_affine``). ``sums``:
    K1's emitted (sum, sum of squares); without them the statistics
    are read from ``x`` (f32 accumulation, squares rounded to bf16; its
    halo must be zero). ``group``: ``x`` is this rank's D slab of a
    volume sharded over that group, and the sums are added over it.
    Under autograd the halo's share of the gradient is dropped by the
    producer of ``x`` (K6's backward, ``F.pad``), not here."""
    n = interior_count(x)
    if sums is None:
        s1, s2 = bf16_moments(x, n, group)
    else:
        s1, s2 = group_means(sums, n, group)
    return group_affine(s1, s2, gamma, beta, num_groups, eps)


def group_norm_halo(x: torch.Tensor, gamma, beta, num_groups: int,
                    eps: float = 1e-5, sums=None,
                    group=None) -> torch.Tensor:
    """GroupNorm of a halo tensor, applied in x's dtype, halo re-zeroed
    (JAX ``group_norm_flat``); ``group`` as ``group_norm_halo_affine``'s."""
    scale, shift = group_norm_halo_affine(x, gamma, beta, num_groups, eps,
                                          sums, group)
    return apply_affine(x, scale, shift) * halo_mask(x)


def conv1x1_halo(xs, w: torch.Tensor, bias=None, se0=None,
                 psi0=None) -> torch.Tensor:
    """Pointwise conv over the channel concat of halo tensors (JAX
    ``conv1x1_flat``), halo re-zeroed. ``se0`` (B, ci_0) folds the
    gate's channel factor into input 0's weights per batch item;
    ``psi0`` (B, D+2, H+2, W+2, 1) scales input 0's contribution per
    voxel — the gated input is never formed. Computed in the inputs'
    dtype."""
    dt = xs[0].dtype
    w2 = w.reshape(w.shape[-2], w.shape[-1]).to(dt)
    y, off = None, 0
    for i, x in enumerate(xs):
        ci = x.shape[-1]
        wi = w2[off:off + ci]
        off += ci
        if i == 0 and se0 is not None:
            wi = wi[None] * se0.to(dt)[:, :, None]       # (B, ci, co)
            t = matmul(x.reshape(x.shape[0], -1, ci), wi, dt)
            t = t.reshape(*x.shape[:-1], -1)
        else:
            t = matmul(x, wi, dt)
        if i == 0 and psi0 is not None:
            t = t * psi0
        y = t if y is None else y + t
    if bias is not None:
        y = y + bias.to(dt)
    return y * halo_mask(y)


def global_avg_pool_halo(x: torch.Tensor, group=None) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) of a halo tensor (zero halo) over its true
    voxels -> (B, 1, 1, 1, C) in ``x.dtype`` (JAX
    ``global_avg_pool_flat``); ``group``: over the volume whose D slabs
    lie on that group's ranks."""
    s = x.sum((1, 2, 3), keepdim=True, dtype=torch.float32)
    return group_means([s], interior_count(x), group)[0].to(x.dtype)


def max_pool3d_from_halo(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 max pool of a halo tensor -> the next level in NDHWC
    (JAX ``max_pool3d_from_flat``)."""
    return max_pool3d(x[:, 1:-1, 1:-1, 1:-1])
