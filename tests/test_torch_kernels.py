"""Each CUDA kernel of the port against its plain PyTorch version, on
the card (marker ``gpu``; they skip without a CUDA device).

This file imports no JAX, so it also runs on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

(``tests/conftest.py`` imports JAX, hence ``--noconftest``.) Tolerances
as in test_torch_ps2d.py: pack and pool bit-exact; the transposed conv
(K2) within 1 bf16 ulp of max|ref|, its halo exactly zero and two runs
bit-identical; the conv (K1) within 2^-7 * max|ref| and
its sums within 1e-3 of the largest sum (f32 sums in another order), and
bit-identical across two runs (per-block sums added in a fixed order, no
float atomics). The differentiable conv (K6) against autograd through the
plain conv: its gradients within 2^-5 * max|ref| (JAX's rule for its
own kernel's VJP, tests/test_ps2d.py:446-451). The fused GroupNorm (K5)
within 1 bf16 ulp of max|ref| in bf16 and 1e-5 of max|ref| in f32, and
bit-identical across two runs (no float atomics). The unpadded conv (K7)
within 2^-7 * max|ref|, its gradients within 2^-5 * max|ref|, two runs
bit-identical, and its wgmma tile step alone within 1e-5 * max|ref| of
torch.matmul (f32 sums of 16 exact products).

The f32 forms (K1, K2, K7 sources of their own; K3, K4 the same sources
instantiated for f32) against their plain versions in full f32 (TF32
off, ``ops.conv.full_f32``, around the whole test, backwards included):
pack and pool bit-exact; K1, K2, K6 and K7 within 1e-5 * max|ref| (f32
sums in another order), K1's sums within 1e-5 of the largest sum; two
runs bit-identical. K1's f32 form (three bf16 wgmma passes over an exact
split of its activations), K7's and K2's (six over an exact split of
their activations and weights) also err against a float64 conv of the
same inputs by at most 4x the plain f32 conv's own error; K7's and K2's
errors hold none of the share of any of their three smallest passes
(least squares, |beta| <= 0.5; -1 would be a pass dropped).

The int8 conv of int8 serving (Q8) against its plain version (a float64
conv of the quantized integers, exact): bit-equal, with prepared
(cached) weights and with the weights quantized in the call, two runs
bit-identical; its prepared weights equal to the plain quantization in
the kernel's layout; its launch plan equal to the Python mirror; its
int8 wgmma tile step alone equal to the integer product.
"""

import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv import full_f32
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import conv3d as K7
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import groupnorm as K5
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

BF16 = torch.bfloat16


def _ulp(m):
    """One bf16 ulp at magnitude m."""
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


# (cis, co, affine, relu, mul0, stats, (B, D, H, W)): the level-0
# region's three call forms, the level-1 region's three (enc1.conv1
# 32->64, enc1/dec1.conv2 64->64 with affine + ReLU, dec1.conv1 64+64->64
# with the mask) and the remaining combinations, over a 3x19x37 interior
# (ragged against every patch); then D = 1, a volume smaller than one
# patch (2x3x5), volumes large enough for M = 256 plans, co = 16 at each
# (KC, M), inputs of mixed widths (KC = 32 forced by one of them), and
# between them every kernel instantiation (N 16/32/64/128 x (M 128 with
# KC 32 or 64, M 256 with KC 32) x one or several channel tiles;
# test_k1_cases_cover_every_instantiation checks that)
_S = (2, 3, 19, 37)
K1_CASES = [
    ((32,), 32, None, False, False, False, _S),
    ((32,), 32, "both", True, False, True, _S),
    ((32, 32), 32, None, False, True, True, _S),
    ((32, 32), 16, "both", False, True, True, _S),
    ((64,), 64, "scale", True, False, False, _S),
    ((32, 32), 32, "shift", True, False, True, _S),
    ((32,), 64, None, False, False, True, _S),
    ((64,), 64, "both", True, False, True, _S),
    ((64, 64), 64, None, False, True, True, _S),
    # any 32-multiple co: channel tiles of 32 (96) and of 64 (128)
    ((32,), 96, "both", True, False, True, _S),
    ((64, 32), 96, None, False, True, True, _S),
    ((32,), 128, "both", True, False, True, _S),
    ((64, 64), 128, None, False, True, True, _S),
    ((32,), 32, "both", True, False, True, (2, 1, 9, 20)),
    ((32, 32), 64, None, False, True, True, (2, 2, 3, 5)),
    ((64,), 128, None, False, False, False, (1, 5, 9, 11)),
    ((32,), 32, "both", True, False, True, (2, 16, 32, 40)),
    ((32, 32), 32, None, False, True, True, (2, 16, 32, 40)),
    ((64,), 64, "both", True, False, True, (2, 16, 32, 40)),
    ((32,), 96, None, False, False, True, (2, 16, 32, 40)),
    ((64,), 128, "both", True, False, True, (2, 16, 32, 40)),
    ((32,), 192, "both", True, False, True, (2, 16, 32, 40)),
    ((32,), 256, "shift", False, False, True, (2, 8, 30, 40)),
    ((32,), 16, "both", True, False, True, (2, 16, 32, 40)),
    ((64,), 16, None, False, False, True, _S),
    ((64,), 32, "scale", False, False, True, _S),
    ((64,), 96, "both", True, False, True, _S),
    ((32,), 192, None, False, False, True, _S),
    ((64,), 192, "both", True, False, True, _S),
    ((32,), 256, None, False, False, True, _S),
    ((32, 64), 64, "both", True, True, True, _S),
    ((64, 64), 256, "both", True, True, True, _S),
]


def _k1_inputs(device, cis, co, affine, mul0, shape, seed=1):
    """Halo inputs, weights and on-load transform arguments of a K1 case."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, D, H, W = shape

    def rnd(shape, s=1.0):
        return (torch.randn(shape, device=device, generator=g) * s).to(BF16)

    xs = [T.pack_halo(rnd((B, D, H, W, c))) for c in cis]
    w = rnd((3, 3, 3, sum(cis), co), 0.1)
    kw = {}
    if affine in ("scale", "both"):
        kw["in_scale"] = rnd((B, sum(cis)), 0.3) + 1
    if affine in ("shift", "both"):
        kw["in_shift"] = rnd((B, sum(cis)), 0.3)
    if mul0:
        kw["in_mul0"] = T.pack_halo(rnd((B, D, H, W, cis[0]), 0.5))
    return xs, w, kw


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_pack_halo_kernel_matches_plain(cuda):
    x = torch.randn((2, 5, 9, 20, 32), device=cuda).to(BF16)
    before = T.pack_halo.launches
    torch.testing.assert_close(T.pack_halo(x), T.pack_halo_plain(x),
                               rtol=0, atol=0)
    assert T.pack_halo.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 6, 10, 40, 32), (1, 4, 4, 4, 64)])
def test_pool_into_halo_kernel_matches_plain(cuda, shape):
    x = T.pack_halo(torch.randn(shape, device=cuda).to(BF16))
    before = T.pool_into_halo.launches
    y = T.pool_into_halo(x)
    torch.testing.assert_close(y, T.pool_into_halo_plain(x), rtol=0, atol=0)
    assert T.pool_into_halo.launches == before + 1
    assert (y.float() * (1 - T.halo_mask(y).float())).abs().max() == 0


# ((B, D2, H2, W2), ci, co, bias): the UNet's two call forms at the
# server's batch of 4 windows of 128^3 (level 0, level 1); tails (W2 = 6,
# 37 and 70 = 64 + 6 against tiles of 64 GEMM rows: ten whole rows, one
# part-filled row, two tiles a row; D2 = H2 = 1); narrow channels (ci = co
# = 8: K zero-padded to 16; ci = 32, co = 16; 24 channels, three slabs of
# 8); slabs of two pairs (co = 64 at ci = 64), one pair and part of co (co
# = 128, 256), and K in chunks (ci = 512, 1024; ci = 2056: the last chunk
# part zeros). Between them every launch shape
# (test_k2_cases_cover_every_plan checks that).
K2_CASES = [
    ((4, 64, 64, 64), 64, 32, True),
    ((4, 32, 32, 32), 128, 64, True),
    ((2, 3, 5, 6), 64, 32, True),
    ((2, 3, 5, 6), 64, 64, False),
    ((1, 2, 3, 37), 64, 32, False),
    ((1, 1, 2, 70), 64, 32, True),
    ((2, 1, 1, 9), 64, 32, True),
    ((1, 2, 3, 5), 8, 8, True),
    ((1, 2, 3, 5), 8, 8, False),
    ((1, 2, 3, 20), 32, 16, True),
    ((1, 2, 3, 20), 32, 16, False),
    ((1, 2, 2, 40), 24, 24, True),
    ((1, 2, 2, 4), 256, 128, True),
    ((1, 2, 3, 5), 512, 256, False),
    ((1, 2, 2, 3), 1024, 64, True),
    ((1, 2, 2, 3), 2056, 64, False),
]


def _k2_inputs(device, shape, ci, co, with_bias, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((*shape, ci), device=device, generator=g).to(BF16)
    w = (torch.randn((2, 2, 2, ci, co), device=device, generator=g)
         * 0.1).to(BF16)
    b = (torch.randn((co,), device=device, generator=g) * 0.1
         if with_bias else None)
    return x, w, b


def _dirty(shape, dtype=BF16):
    """Leave NaNs in the allocator's next block of this size, so that a
    halo the kernel fails to write shows."""
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ci,co,with_bias", K2_CASES)
def test_up_k2s2_into_halo_kernel_matches_plain(cuda, shape, ci, co,
                                                with_bias):
    x, w, b = _k2_inputs(cuda, shape, ci, co, with_bias)
    B, D2, H2, W2 = shape
    _dirty((B, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2, co))
    before = T.up_k2s2_into_halo.launches
    got = T.up_k2s2_into_halo(x, w, b)
    torch.cuda.synchronize()
    assert T.up_k2s2_into_halo.launches == before + 1
    ref = T.up_k2s2_into_halo_plain(x, w, b)
    assert got.shape == ref.shape
    d = (got.float() - ref.float()).abs().max().item()
    assert d <= _ulp(ref.float().abs().max().item()), d
    assert (got.float() * (1 - T.halo_mask(got).float())).abs().max() == 0


@pytest.mark.gpu
def test_k2_cases_cover_every_plan(cuda):
    """The cases above reach each kernel instantiation (slabs of 64, 128
    and 256 columns), K whole and in chunks, tiles of several rows, of a
    row and of part of a row, slabs of 4, 2 and 1 pairs and of part of
    co."""
    plans = [T.up_k2s2_plan(*shape, ci, co)
             for shape, ci, co, _ in K2_CASES]
    assert {p["NS"] for p in plans} == {64, 128, 256}
    assert {p["nK"] > 1 for p in plans} == {False, True}
    assert {p["P"] for p in plans} == {1, 2, 4}
    assert {(p["R"] > 1, p["tpr"] > 1) for p in plans} == {
        (True, False), (False, False), (False, True)}
    assert any(p["CW"] < co for p, (_, _, co, _) in zip(plans, K2_CASES))
    # the main path's two forms: two blocks an SM, weights loaded once;
    # all 8 phases a slab at level 0, one (a, p) pair of two input rows a
    # tile at level 1
    for p in plans[:2]:
        assert p["nK"] == 1 and p["smem"] <= 113 * 1024, p
    assert (plans[0]["P"], plans[0]["R"]) == (4, 1), plans[0]
    assert (plans[1]["P"], plans[1]["R"]) == (1, 2), plans[1]


@pytest.mark.gpu
def test_up_k2s2_into_halo_two_runs_bit_identical(cuda):
    """No float atomics: two launches at the level-1 form (the server's
    batch of 4 windows, (4, 32^3, 128) -> (4, 66^3, 64)) give the same
    bits."""
    x, w, b = _k2_inputs(cuda, (4, 32, 32, 32), 128, 64, True, seed=3)
    assert torch.equal(T.up_k2s2_into_halo(x, w, b),
                       T.up_k2s2_into_halo(x, w, b))


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co,affine,relu,mul0,stats,shape", K1_CASES)
def test_conv3d_halo_kernel_matches_plain(cuda, cis, co, affine, relu,
                                          mul0, stats, shape):
    xs, w, kw = _k1_inputs(cuda, cis, co, affine, mul0, shape)
    before = T.conv3d_halo.launches
    got = T.conv3d_halo(xs, w, in_relu=relu, emit_stats=stats, **kw)
    ref = T.conv3d_halo_plain(xs, w, in_relu=relu, emit_stats=stats, **kw)
    torch.cuda.synchronize()
    assert T.conv3d_halo.launches == before + 1
    y, yr = (got[0], ref[0]) if stats else (got, ref)
    d = (y.float() - yr.float()).abs().max().item()
    assert d <= 2 ** -7 * yr.float().abs().max().item(), d
    assert (y.float() * (1 - T.halo_mask(y).float())).abs().max() == 0
    if stats:
        for s, sr in zip(got[1], ref[1]):
            torch.testing.assert_close(
                s, sr, rtol=0, atol=1e-3 * sr.abs().max().item())


@pytest.mark.gpu
def test_k1_cases_cover_every_instantiation(cuda):
    """The cases above reach each (N, KC, M, one channel tile or
    several) the launch can pick (co = 16 is one tile of N = 16)."""
    seen = set()
    for cis, co, _, _, _, _, (B, D, H, W) in K1_CASES:
        p = T.conv3d_halo_plan(B, D, H, W, cis[0], sum(cis[1:]), co)
        assert p["TD"] * p["TH"] * p["TW"] <= p["M"] and p["blocks"] >= 1
        seen.add((p["N"], p["KC"], p["M"], p["N"] == co))
    shapes = ((32, 128), (64, 128), (32, 256))
    assert seen == ({(n, kc, m, one) for n in (32, 64, 128)
                     for kc, m in shapes for one in (True, False)}
                    | {(16, kc, m, True) for kc, m in shapes}), sorted(seen)


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co,affine,relu,mul0,shape", [
    ((32,), 32, "both", True, False, (2, 16, 32, 40)),
    ((32, 32), 32, None, False, True, (2, 16, 32, 40)),
    ((64, 64), 64, None, False, True, (2, 3, 19, 37)),
    ((32,), 96, "both", True, False, (2, 3, 19, 37)),
    ((128,), 128, "both", True, False, (4, 64, 64, 64)),
])
def test_conv3d_halo_two_runs_bit_identical(cuda, cis, co, affine, relu,
                                            mul0, shape):
    """No float atomics: two launches on the same inputs give the same
    output and statistics bits (the last case: co = 128 at the server's
    batch of 4 level-1 windows, 64^3)."""
    xs, w, kw = _k1_inputs(cuda, cis, co, affine, mul0, shape, seed=8)
    y1, (a1, b1) = T.conv3d_halo(xs, w, in_relu=relu, emit_stats=True, **kw)
    y2, (a2, b2) = T.conv3d_halo(xs, w, in_relu=relu, emit_stats=True, **kw)
    assert torch.equal(y1, y2) and torch.equal(a1, a2) and torch.equal(b1, b2)
    yr = T.conv3d_halo_plain(xs, w, in_relu=relu, **kw)
    d = (y1.float() - yr.float()).abs().max().item()
    assert d <= 2 ** -7 * yr.float().abs().max().item(), d


@pytest.mark.gpu
def test_kernels_refuse_unsupported_inputs(cuda):
    with pytest.raises(ValueError):
        T.pack_halo(torch.zeros((1, 2, 2, 2, 12), device=cuda, dtype=BF16))
    with pytest.raises(ValueError):
        T.conv3d_halo([torch.zeros((1, 4, 4, 4, 16), device=cuda,
                                   dtype=BF16)],
                      torch.zeros((3, 3, 3, 16, 32), device=cuda))
    with pytest.raises(ValueError):      # odd interior
        T.pool_into_halo(torch.zeros((1, 5, 6, 6, 32), device=cuda,
                                     dtype=BF16))


@pytest.mark.gpu
@pytest.mark.parametrize("co", [8, 48, 80])
def test_conv3d_halo_refuses_other_widths(cuda, co):
    x = torch.zeros((1, 4, 4, 4, 32), device=cuda, dtype=BF16)
    with pytest.raises(ValueError):
        T.conv3d_halo([x], torch.zeros((3, 3, 3, 32, co), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co", [((32,), 32), ((32, 32), 32),
                                    ((64,), 96), ((32, 64), 128)])
def test_conv3d_halo_train_kernel_matches_plain(cuda, cis, co):
    """K6's forward, data gradients and weight gradient against autograd
    through the plain conv, with garbage in the cotangent's halo (the
    output's halo is a constant zero; its cotangent must be dropped)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    B, D, H, W = 2, 3, 19, 37

    def rnd(shape, s=1.0):
        return torch.randn(shape, device=cuda, generator=g) * s

    xs0 = [T.pack_halo(rnd((B, D, H, W, c)).to(BF16)) for c in cis]
    w0 = rnd((3, 3, 3, sum(cis), co), 0.1)
    r = rnd((B, D + 2, H + 2, W + 2, co))
    r = r + 100 * r * (1 - T.halo_mask(r))      # garbage on the halo

    def run(fn):
        xs = [x.clone().requires_grad_() for x in xs0]
        w = w0.clone().requires_grad_()
        y = fn(xs, w)
        (y.float() * r).sum().backward()
        return y.detach(), [x.grad for x in xs], w.grad

    before = T.conv3d_halo.launches
    y, dxs, dw = run(T.conv3d_halo_train)
    torch.cuda.synchronize()
    n = 1 + len(cis)            # the forward, one data gradient per input
    assert T.conv3d_halo.launches == before + n     # K6's launches are K1's
    yr, dxs_r, dw_r = run(T.conv3d_halo_train_plain)

    def close(a, b, rel):
        d = (a.float() - b.float()).abs().max().item()
        assert d <= rel * max(b.float().abs().max().item(), 1e-3), d

    close(y, yr, 2 ** -7)
    for a, b in zip(dxs, dxs_r):
        close(a, b, 2 ** -5)
        assert (a.float() * (1 - T.halo_mask(a).float())).abs().max() == 0
    close(dw, dw_r, 2 ** -5)


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co", [((32,), 32), ((32, 32), 32),
                                    ((64,), 96), ((32, 64), 128)])
def test_conv3d_halo_dgrad_ignores_cotangent_halo(cuda, cis, co):
    """K6's data gradient on K1 with garbage on the cotangent's halo: the
    kernel never loads a halo position, so the result is bit for bit the
    one of the cotangent with a zero halo, and its plain version's."""
    g = torch.Generator(device=cuda).manual_seed(9)
    B, D, H, W = 2, 3, 19, 37
    dy = torch.randn((B, D + 2, H + 2, W + 2, co), device=cuda, generator=g)
    clean = (dy * T.halo_mask(dy)).to(BF16)
    dirty = (dy + 100 * dy * (1 - T.halo_mask(dy))).to(BF16)
    assert (dirty != clean).any()
    w = torch.randn((3, 3, 3, sum(cis), co), device=cuda, generator=g) * 0.1
    for i in range(len(cis)):
        got = T.conv3d_halo_dgrad(dirty, w, i, cis)
        assert torch.equal(got, T.conv3d_halo_dgrad(clean, w, i, cis))
        off = sum(cis[:i])
        w_t = w[:, :, :, off:off + cis[i]].flip(0, 1, 2).transpose(3, 4)
        ref = T.conv3d_halo_plain((clean,), w_t)
        d = (got.float() - ref.float()).abs().max().item()
        assert d <= 2 ** -7 * ref.float().abs().max().item(), d
        assert (got.float() * (1 - T.halo_mask(got).float())).abs().max() == 0


# (shape, groups): a ragged voxel count, C = 24 (3 vectors a row), C = 12
# (one value an access), C = 512 (more vectors a row than a warp), a
# sample of 20480 voxels, 300 samples of 8 voxels (blocks walk many
# samples), and ranges of ~500 KB in f32, larger than what a block keeps
# on chip between its passes (192 KB)
K5_CASES = [
    ((2, 5, 9, 20, 32), 8),
    ((1, 5, 3, 7, 32), 4),
    ((3, 4, 4, 4, 16), 1),
    ((2, 3, 5, 7, 24), 4),
    ((2, 3, 5, 7, 12), 4),
    ((1, 2, 3, 5, 512), 8),
    ((2, 16, 32, 40, 32), 8),
    ((300, 2, 2, 2, 32), 8),
    ((2, 64, 64, 64, 32), 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("relu,residual", [(False, None), (True, None),
                                           (True, "same"), (False, "f32"),
                                           (True, "x")])
@pytest.mark.parametrize("shape,groups", K5_CASES)
def test_fused_group_norm_kernel_matches_plain(cuda, shape, groups, relu,
                                               residual, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(shape, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.3 * torch.randn(shape[-1], device=cuda, generator=g)
    beta = 0.3 * torch.randn(shape[-1], device=cuda, generator=g)
    r = None
    if residual == "x":                 # x itself: read from x's stages
        r = x
    elif residual is not None:
        r = torch.randn(shape, device=cuda, generator=g).to(
            dtype if residual == "same" else torch.float32)
    before = K5.fused_group_norm.launches
    got = K5.fused_group_norm(x, gamma, beta, groups, residual=r, relu=relu)
    torch.cuda.synchronize()
    assert K5.fused_group_norm.launches == before + 1
    again = K5.fused_group_norm(x, gamma, beta, groups, residual=r,
                                relu=relu)
    ref = K5.fused_group_norm_plain(x, gamma, beta, groups, residual=r,
                                    relu=relu)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, again)
    m = ref.float().abs().max().item()
    d = (got.float() - ref.float()).abs().max().item()
    assert d <= (_ulp(m) if dtype == BF16 else 1e-5 * m), d


@pytest.mark.gpu
@pytest.mark.parametrize("res_dtype", [None, torch.float32, BF16])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("shape", [(4, 128 ** 3, 32), (300, 8, 32),
                                   (2, 105, 12), (1, 30, 512)])
def test_fused_group_norm_plan_on_the_card(cuda, shape, dtype, res_dtype):
    """The C code's plan on this card is group_norm_plan's for its SMs
    and shared memory."""
    got = K5.group_norm_device_plan(*shape, dtype, res_dtype)
    want = K5.group_norm_plan(*shape, dtype, got["sms"], got["smem_cap"],
                              res_dtype)
    assert {k: got[k] for k in K5._PLAN_KEYS} == {
        k: want[k] for k in K5._PLAN_KEYS}


@pytest.mark.gpu
def test_fused_group_norm_refuses_ragged_groups(cuda):
    with pytest.raises(ValueError):
        K5.fused_group_norm(torch.zeros((1, 2, 2, 2, 12), device=cuda),
                            torch.ones(12, device=cuda),
                            torch.zeros(12, device=cuda), 8)


# (ci, co, D, H, W) at batch 2: ragged patches (D, H and W not multiples
# of the patch, narrow and wide patches), D = 1, a volume smaller than one
# patch (3x5x7), ci 96 (three chunks of 32), co 96 (three channel tiles of
# 32), co 256, and between them every kernel instantiation (N 32/64/128 x
# (M 128 with KC 32 or 64, M 256 with KC 32) x one or several channel
# tiles; test_k7_cases_cover_every_instantiation checks that; the last six
# are large enough for M 256)
K7_CASES = [
    (32, 32, 3, 19, 37),
    (64, 32, 2, 8, 8),
    (32, 64, 3, 7, 12),
    (32, 96, 2, 9, 33),
    (64, 128, 2, 10, 40),
    (128, 64, 2, 15, 10),
    (512, 512, 2, 15, 10),
    (32, 32, 1, 9, 20),
    (32, 64, 3, 5, 7),
    (64, 64, 2, 19, 37),
    (96, 96, 2, 9, 33),
    (64, 96, 2, 13, 21),
    (32, 256, 3, 7, 12),
    (32, 128, 8, 30, 40),
    (64, 128, 8, 31, 41),
    (96, 256, 8, 30, 20),
    (128, 256, 8, 29, 23),
    (32, 192, 3, 7, 12),
    (64, 192, 2, 10, 12),
    (32, 32, 25, 41, 39),
    (64, 96, 17, 33, 31),
    (96, 64, 23, 40, 41),
    (32, 192, 16, 33, 32),
    (64, 128, 24, 39, 40),
    (32, 256, 15, 40, 41),
]


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,D,H,W", K7_CASES)
def test_conv3d_same_kernel_matches_plain(cuda, ci, co, D, H, W):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, D, H, W, ci), device=cuda, generator=g).to(BF16)
    w = torch.randn((3, 3, 3, ci, co), device=cuda, generator=g) * 0.05
    before = K7.conv3d_same.launches
    y = K7.conv3d_same(x, w)
    torch.cuda.synchronize()
    assert K7.conv3d_same.launches == before + 1
    ref = K7.wtile_conv3d_plain(x, w)
    assert y.dtype == BF16 and y.shape == ref.shape
    d = (y.float() - ref.float()).abs().max().item()
    assert d <= 2 ** -7 * ref.float().abs().max().item(), d


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("ci,co,D,H,W", [(32, 32, 3, 19, 37),
                                         (64, 32, 2, 15, 10)])
def test_wtile_conv3d_grads_match_plain(cuda, ci, co, D, H, W, w_dtype):
    """K7's op: forward and data gradient on the kernel (2 launches), the
    weight gradient a library call in the weights' dtype, against
    autograd through the plain version, with the loss of the JAX test,
    sum(y^2)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x0 = torch.randn((1, D, H, W, ci), device=cuda, generator=g).to(BF16)
    w0 = (torch.randn((3, 3, 3, ci, co), device=cuda, generator=g)
          * 0.05).to(w_dtype)

    def run(fn):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(x, w).float() ** 2).sum().backward()
        return x.grad, w.grad

    before = K7.conv3d_same.launches
    dx, dw = run(K7.wtile_conv3d)
    torch.cuda.synchronize()
    assert K7.conv3d_same.launches == before + 2
    rx, rw = run(K7.wtile_conv3d_plain)
    assert dx.dtype == BF16 and dw.dtype == w_dtype
    for a, b in ((dx, rx), (dw, rw)):
        d = (a.float() - b.float()).abs().max().item()
        assert d <= 2 ** -5 * b.float().abs().max().item(), d


@pytest.mark.gpu
def test_conv3d_same_refuses_f32_and_other_widths(cuda):
    """Widths that are not multiples of 32 are refused in either dtype
    (f32 itself runs on the kernel's f32 form); so is a third dtype."""
    for dt in (BF16, torch.float32):
        with pytest.raises(ValueError):
            K7.conv3d_same(torch.zeros((1, 2, 3, 4, 16), device=cuda,
                                       dtype=dt),
                           torch.zeros((3, 3, 3, 16, 32), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        K7.conv3d_same(torch.zeros((1, 2, 3, 4, 32), device=cuda,
                                   dtype=torch.float16),
                       torch.zeros((3, 3, 3, 32, 32), device=cuda))


@pytest.mark.gpu
def test_k7_cases_cover_every_instantiation(cuda):
    """The cases above reach each (N, KC, M, one channel tile or
    several) the launch can pick."""
    seen = set()
    for ci, co, D, H, W in K7_CASES:
        p = K7.conv3d_same_plan(2, D, H, W, ci, co)
        assert p["TD"] * p["TH"] * p["TW"] <= p["M"] and p["blocks"] >= 1
        seen.add((p["N"], p["KC"], p["M"], p["N"] == co))
    assert seen == {(n, kc, m, one) for n in (32, 64, 128)
                    for kc, m in ((32, 128), (64, 128), (32, 256))
                    for one in (True, False)}, sorted(seen)


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,D,H,W", [(512, 512, 15, 15, 10),
                                         (32, 32, 6, 40, 24),
                                         (64, 128, 8, 30, 40)])
def test_conv3d_same_two_runs_bit_identical(cuda, ci, co, D, H, W):
    """No float atomics: two launches on the same inputs give the same
    bits (batch 1, the deepest benchmark shape among them), and agree
    with the plain version."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((1, D, H, W, ci), device=cuda, generator=g).to(BF16)
    w = (torch.randn((3, 3, 3, ci, co), device=cuda, generator=g)
         * 0.05).to(BF16)
    y1, y2 = K7.conv3d_same(x, w), K7.conv3d_same(x, w)
    assert torch.equal(y1, y2)
    ref = K7.wtile_conv3d_plain(x, w)
    d = (y1.float() - ref.float()).abs().max().item()
    assert d <= 2 ** -7 * ref.float().abs().max().item(), d


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 64, 128])
def test_wgmma_tile_product_matches_matmul(cuda, n):
    """K7's operand path alone: one 64 x n x 16 wgmma (A through ldmatrix,
    B through the weight-slab layout and its descriptor) against
    torch.matmul of the same bf16 tiles; f32 sums of 16 exact products."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn((64, 16), device=cuda, generator=g).to(BF16)
    b = torch.randn((16, n), device=cuda, generator=g).to(BF16)
    d = K7.wgmma_tile_product(a, b)
    torch.cuda.synchronize()
    ref = torch.matmul(a.double(), b.double()).float()
    assert d.shape == ref.shape and d.dtype == torch.float32
    assert (d - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# ---------------------------------------------------------------- f32 forms

F32 = torch.float32


@pytest.fixture
def f32_exact(cuda):
    """The plain versions' library calls in full f32 for the test,
    backwards included."""
    with full_f32():
        yield cuda


def _rel_close(a, b, rel=1e-5):
    assert a.dtype == b.dtype == F32 and a.shape == b.shape
    d = (a - b).abs().max().item()
    assert d <= rel * max(b.abs().max().item(), 1e-3), d


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 5, 9, 20, 32), (1, 4, 4, 4, 64)])
def test_pack_halo_f32_kernel_matches_plain(f32_exact, shape):
    x = torch.randn(shape, device=f32_exact)
    before = T.pack_halo.launches
    y = T.pack_halo(x)
    torch.testing.assert_close(y, T.pack_halo_plain(x), rtol=0, atol=0)
    assert T.pack_halo.launches == before + 1 and y.dtype == F32


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 6, 10, 40, 32), (4, 66, 66, 66, 32)])
def test_pool_into_halo_f32_kernel_matches_plain(f32_exact, shape):
    """Over a halo tensor (the second: the server's level-0 skip,
    (4, 130^3, 32) pooled into (4, 66^3, 32), at half the width)."""
    B, D, H, W, C = shape
    x = T.pack_halo(torch.randn((B, D - 2, H - 2, W - 2, C),
                                device=f32_exact))
    before = T.pool_into_halo.launches
    y = T.pool_into_halo(x)
    torch.testing.assert_close(y, T.pool_into_halo_plain(x), rtol=0, atol=0)
    assert T.pool_into_halo.launches == before + 1 and y.dtype == F32
    assert (y * (1 - T.halo_mask(y))).abs().max() == 0


def _k1_f32_inputs(device, cis, co, affine, mul0, shape, seed=1):
    xs, w, kw = _k1_inputs(device, cis, co, affine, mul0, shape, seed)
    g = torch.Generator(device=device).manual_seed(seed + 100)
    # f32 values that bf16 does not hold
    xs = [x.float() + 1e-3 * torch.randn(x.shape, device=device, generator=g)
          * T.halo_mask(x).float() for x in xs]
    w = w.float() + 1e-3 * torch.randn(w.shape, device=device, generator=g)
    return xs, w, {k: v.float() for k, v in kw.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co,affine,relu,mul0,stats,shape", K1_CASES)
def test_conv3d_halo_f32_kernel_matches_plain(f32_exact, cis, co, affine,
                                              relu, mul0, stats, shape):
    xs, w, kw = _k1_f32_inputs(f32_exact, cis, co, affine, mul0, shape)
    _dirty((shape[0], shape[1] + 2, shape[2] + 2, shape[3] + 2, co), F32)
    before = T.conv3d_halo.launches
    got = T.conv3d_halo(xs, w, in_relu=relu, emit_stats=stats, **kw)
    again = T.conv3d_halo(xs, w, in_relu=relu, emit_stats=stats, **kw)
    ref = T.conv3d_halo_plain(xs, w, in_relu=relu, emit_stats=stats, **kw)
    torch.cuda.synchronize()
    assert T.conv3d_halo.launches == before + 2
    y, y2, yr = (got[0], again[0], ref[0]) if stats else (got, again, ref)
    _rel_close(y, yr)
    assert torch.equal(y, y2)
    assert (y * (1 - T.halo_mask(y))).abs().max() == 0
    if stats:
        for s, s2, sr in zip(got[1], again[1], ref[1]):
            assert torch.equal(s, s2)
            torch.testing.assert_close(
                s, sr, rtol=0, atol=1e-5 * sr.abs().max().item())


@pytest.mark.gpu
def test_k1_f32_plans(cuda):
    """The f32 form's plans at the K1 cases: bf16 wgmma passes over an
    exact split: N 16 for co = 16, else 64 where it divides co, else 32
    (an f32 total beside each accumulator), chunks of KC = 16 channels,
    M = 128 GEMM rows holding the patch, two blocks an SM in shared
    memory, and one block per patch and channel tile."""
    for cis, co, _, _, _, _, (B, D, H, W) in K1_CASES:
        p = T.conv3d_halo_plan(B, D, H, W, cis[0], sum(cis[1:]), co, F32)
        assert p["N"] == (16 if co == 16 else 64 if co % 64 == 0
                          else 32), p
        assert p["KC"] == 16 and p["M"] == 128, p
        assert p["TD"] * p["TH"] * p["TW"] <= 128 and p["TD"] <= 4, p
        assert p["smem"] <= 115712, p
        assert p["blocks"] == p["blocks_per_item"] * B * (co // p["N"]) >= 1


def _f64_conv(xs, w, relu, kw):
    """K1's function in float64 on the card: the inputs transformed in f32
    as the kernel and the plain version transform them (x'), the weights
    rounded to bf16, one VALID conv over the halo -> (B, D, H, W, co)."""
    vs = T._transform_inputs(xs, kw.get("in_scale"), kw.get("in_shift"),
                             relu, kw.get("in_mul0"))
    xcat = torch.cat(vs, -1).double().permute(0, 4, 1, 2, 3).contiguous()
    wd = w.to(BF16).double().permute(4, 3, 0, 1, 2).contiguous()
    return torch.nn.functional.conv3d(xcat, wd).permute(0, 2, 3, 4, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co,affine,relu,mul0,stats,shape", K1_CASES)
def test_conv3d_halo_f32_split_error_vs_float64(f32_exact, cis, co, affine,
                                                relu, mul0, stats, shape):
    """Three bf16 passes over an exact split of x' lose nothing: the
    kernel's max |error| against the float64 conv of the same x' and
    rounded w is at most 4x the plain f32 conv's own (a split that lost
    its third part would err by about 2^-17 a product, some hundred
    times more)."""
    xs, w, kw = _k1_f32_inputs(f32_exact, cis, co, affine, mul0, shape)
    ref = _f64_conv(xs, w, relu, kw)
    y = T.halo_to_normal(T.conv3d_halo(xs, w, in_relu=relu, **kw))
    yp = T.halo_to_normal(T.conv3d_halo_plain(xs, w, in_relu=relu, **kw))
    err = (y.double() - ref).abs().max().item()
    err_plain = (yp.double() - ref).abs().max().item()
    assert err <= 4 * err_plain, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co", [((32,), 32), ((32, 32), 32),
                                    ((64,), 96), ((32, 64), 128)])
def test_conv3d_halo_train_f32_kernel_matches_plain(f32_exact, cis, co):
    """K6 in f32: forward, data gradients (K1's f32 form) and weight
    gradient against autograd through the plain conv, with garbage in
    the cotangent's halo; the weight gradient is not rounded to bf16."""
    g = torch.Generator(device=f32_exact).manual_seed(2)
    B, D, H, W = 2, 3, 19, 37

    def rnd(shape, s=1.0):
        return torch.randn(shape, device=f32_exact, generator=g) * s

    xs0 = [T.pack_halo(rnd((B, D, H, W, c))) for c in cis]
    w0 = rnd((3, 3, 3, sum(cis), co), 0.1)
    r = rnd((B, D + 2, H + 2, W + 2, co))
    r = r + 100 * r * (1 - T.halo_mask(r))      # garbage on the halo

    def run(fn):
        xs = [x.clone().requires_grad_() for x in xs0]
        w = w0.clone().requires_grad_()
        y = fn(xs, w)
        (y * r).sum().backward()
        return y.detach(), [x.grad for x in xs], w.grad

    before = T.conv3d_halo.launches
    y, dxs, dw = run(T.conv3d_halo_train)
    torch.cuda.synchronize()
    assert T.conv3d_halo.launches == before + 1 + len(cis)
    yr, dxs_r, dw_r = run(T.conv3d_halo_train_plain)
    _rel_close(y, yr)
    for a, b in zip(dxs, dxs_r):
        _rel_close(a, b)
        assert (a * (1 - T.halo_mask(a))).abs().max() == 0
    _rel_close(dw, dw_r)
    assert not torch.equal(dw, dw.to(BF16).float())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ci,co,with_bias", K2_CASES)
def test_up_k2s2_into_halo_f32_kernel_matches_plain(f32_exact, shape, ci,
                                                    co, with_bias):
    x, w, b = _k2_inputs(f32_exact, shape, ci, co, with_bias)
    x, w = x.float() + 1e-3, w.float() + 1e-4     # not bf16 values
    B, D2, H2, W2 = shape
    _dirty((B, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2, co), F32)
    before = T.up_k2s2_into_halo.launches
    got = T.up_k2s2_into_halo(x, w, b)
    again = T.up_k2s2_into_halo(x, w, b)
    torch.cuda.synchronize()
    assert T.up_k2s2_into_halo.launches == before + 2
    _rel_close(got, T.up_k2s2_into_halo_plain(x, w, b))
    assert torch.equal(got, again)
    assert (got * (1 - T.halo_mask(got))).abs().max() == 0


@pytest.mark.gpu
def test_k2_f32_cases_cover_every_plan(cuda):
    """The f32 form's plans at the K2 cases reach each of its kernel
    instantiations (slabs of 64, 128 and 256 columns), K whole and in
    chunks, tiles of several rows, of a row and of part of a row, slabs of
    4, 2 and 1 pairs and of part of co, every one within one block's
    shared memory an SM and K in chunks of 32-multiples. The main path's
    two forms: K whole; all 8 phases a slab with three input buffers at
    level 0, one (a, p) pair of two input rows a tile at level 1."""
    plans = [T.up_k2s2_plan(*shape, ci, co, F32)
             for shape, ci, co, _ in K2_CASES]
    assert {p["NS"] for p in plans} == {64, 128, 256}
    assert {p["nK"] > 1 for p in plans} == {False, True}
    assert {p["P"] for p in plans} == {1, 2, 4}
    assert {(p["R"] > 1, p["tpr"] > 1) for p in plans} == {
        (True, False), (False, False), (False, True)}
    assert any(p["CW"] < co for p, (_, _, co, _) in zip(plans, K2_CASES))
    for p, (_, ci, co, _) in zip(plans, K2_CASES):
        assert p["KC"] % 32 == 0 and p["KC"] * p["nK"] >= ci, p
        assert p["NS"] == 2 * p["P"] * p["CW"] and co % p["CW"] == 0, p
        assert p["slabs"] == 4 // p["P"] * co // p["CW"], p
        assert p["smem"] <= 227 * 1024 and p["blocks"] >= p["slabs"], p
    assert plans[0]["nK"] == plans[1]["nK"] == 1
    assert (plans[0]["P"], plans[0]["R"], plans[0]["NS"], plans[0]["S"]) \
        == (4, 1, 256, 3), plans[0]
    assert (plans[1]["P"], plans[1]["R"], plans[1]["NS"]) == (1, 2, 128), \
        plans[1]


def _k2_f32_inputs(device, shape, ci, co, seed=11):
    """f32 values of full precision (x normal, w and bias * 0.1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((*shape, ci), device=device, generator=g)
    w = torch.randn((2, 2, 2, ci, co), device=device, generator=g) * 0.1
    b = torch.randn((co,), device=device, generator=g) * 0.1
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ci,co", [((4, 64, 64, 64), 64, 32),
                                         ((4, 32, 32, 32), 128, 64)])
def test_up_k2s2_into_halo_f32_split_error_vs_float64(f32_exact, shape, ci,
                                                      co):
    """Six bf16 passes over an exact split of x and of the phase weights
    lose nothing, at the main path's two forms: against the float64
    transposed conv of the same x, w and bias the kernel's max |error| is
    at most 4x the plain f32 GEMM's, and it holds none of the share d of
    each of its three smallest passes (x_hi w_lo, x_mid w_mid, x_lo w_hi):
    <err, d> / <d, d> is ~0 where the pass is computed, -1 where it is
    dropped."""
    x, w, b = _k2_f32_inputs(f32_exact, shape, ci, co)
    f64 = torch.float64
    ref = T._phases_into_halo(
        torch.matmul(x.double(), T._phase_matrix(w.double(), f64))
        + b.double().repeat(8), x.shape)
    r = T.up_k2s2_into_halo(x, w, b).double() - ref
    err = r.abs().max().item()
    err_plain = (T.up_k2s2_into_halo_plain(x, w, b).double()
                 - ref).abs().max().item()
    assert err <= 4 * err_plain, (err, err_plain)
    for p in ((0, 2), (1, 1), (2, 0)):
        d = T.up_k2s2_into_halo_split6(x, w, None, F32, (p,)).double()
        beta = ((r * d).sum() / (d * d).sum()).item()
        assert abs(beta) <= 0.5, (p, beta)


@pytest.mark.gpu
@pytest.mark.parametrize("W2", [37, 70])
@pytest.mark.parametrize("ci,co", [(8, 16), (24, 24)])
def test_up_k2s2_into_halo_f32_thin_and_wide(f32_exact, W2, ci, co):
    """Rows of part of a tile (W2 = 37) and of two tiles (70), with K
    mostly zero padding (ci = 8 and 24 of a K of 32) and slabs of part of
    co (24: three of 8 channels), within 1e-5 * max|ref| of the plain
    version, the halo exactly zero over a NaN-filled allocation."""
    shape = (2, 3, 2, W2)
    x, w, b = _k2_f32_inputs(f32_exact, shape, ci, co, seed=W2 + ci)
    _dirty((2, 8, 6, 2 * W2 + 2, co), F32)
    got = T.up_k2s2_into_halo(x, w, b)
    torch.cuda.synchronize()
    _rel_close(got, T.up_k2s2_into_halo_plain(x, w, b))
    assert (got * (1 - T.halo_mask(got))).abs().max() == 0


# K7's f32 cases, which reach every instantiation of its f32 form
# (test_k7_f32_plans), and two thin volumes whose patch needs a TH below
# the balanced most (test_k7_f32_plans_thin)
K7_F32_CASES = K7_CASES[:13] + K7_CASES[-3:] + [(32, 32, 1, 64, 64),
                                                (32, 64, 4, 64, 1)]


def _k7_f32_inputs(dev, ci, co, D, H, W):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((2, D, H, W, ci), device=dev, generator=g)
    w = torch.randn((3, 3, 3, ci, co), device=dev, generator=g) * 0.05
    return x, w


def _check_k7_f32_plan(p, B, D, H, W, co):
    """K7 f32's plan: N = 64 where it divides co, else 32; chunks of
    KC = 16 channels, M = 128 GEMM rows holding the patch, two blocks an
    SM in shared memory, one block per patch and channel tile."""
    assert p["KC"] == 16 and p["M"] == 128, p
    assert p["TD"] * p["TH"] * p["TW"] <= 128 and p["TD"] <= 4, p
    assert p["smem"] <= 115712, p
    patches = (-(-D // p["TD"])) * (-(-H // p["TH"])) * (-(-W // p["TW"]))
    assert p["blocks"] == patches * B * (co // p["N"]), p
    assert p["N"] == (64 if co % 64 == 0 else 32), p


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,D,H,W", K7_F32_CASES)
def test_conv3d_same_f32_kernel_matches_plain(f32_exact, ci, co, D, H, W):
    x, w = _k7_f32_inputs(f32_exact, ci, co, D, H, W)
    before = K7.conv3d_same.launches
    y = K7.conv3d_same(x, w)
    again = K7.conv3d_same(x, w)
    torch.cuda.synchronize()
    assert K7.conv3d_same.launches == before + 2 and y.dtype == F32
    _rel_close(y, K7.wtile_conv3d_plain(x, w))
    assert torch.equal(y, again)
    _check_k7_f32_plan(K7.conv3d_same_plan(2, D, H, W, ci, co, F32), 2, D,
                       H, W, co)


@pytest.mark.gpu
def test_k7_f32_plans(cuda):
    """The f32 form's plans at its cases reach each of its four
    instantiations: N 32 and 64, each with one channel tile and with
    several (it has one step size, three taps)."""
    seen = set()
    for ci, co, D, H, W in K7_F32_CASES:
        p = K7.conv3d_same_plan(2, D, H, W, ci, co, F32)
        _check_k7_f32_plan(p, 2, D, H, W, co)
        seen.add((p["N"], p["N"] == co))
    assert seen == {(n, one) for n in (32, 64) for one in (True, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("B,D,H,W", [(1, 1, 64, 64), (1, 1, 240, 240),
                                     (2, 4, 64, 1), (1, 2, 200, 1),
                                     (1, 1, 300, 1), (1, 3, 1, 1000),
                                     (1, 1, 1, 1)])
def test_k7_f32_plans_thin(cuda, B, D, H, W):
    """Thin volumes, where the largest balanced TH's box would not fit,
    still get a plan (a smaller TH), at both N."""
    for co in (32, 64):
        _check_k7_f32_plan(K7.conv3d_same_plan(B, D, H, W, 32, co, F32), B,
                           D, H, W, co)


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,D,H,W", K7_CASES)
def test_conv3d_same_f32_split_error_vs_float64(f32_exact, ci, co, D, H, W):
    """Six bf16 passes over an exact split of x and of w lose nothing:
    the kernel's max |error| against the float64 conv of the same x and
    w is at most 4x the plain f32 conv's own. That alone would pass a
    kernel without one of the small passes (x_hi w_lo, x_mid w_mid,
    x_lo w_hi: some 2^-18 a product, summed as sqrt(K)), so the kernel's
    error must also hold none of each such pass's share d of the conv:
    <err, d> / <d, d> is ~0 where the pass is computed, -1 where it is
    dropped."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv import (
        conv3d_split6)
    x, w = _k7_f32_inputs(f32_exact, ci, co, D, H, W)
    ref = torch.nn.functional.conv3d(
        x.double().permute(0, 4, 1, 2, 3),
        w.double().permute(4, 3, 0, 1, 2).contiguous(),
        padding=1).permute(0, 2, 3, 4, 1)
    r = K7.conv3d_same(x, w).double() - ref
    err = r.abs().max().item()
    err_plain = (K7.wtile_conv3d_plain(x, w).double() - ref).abs().max().item()
    assert err <= 4 * err_plain, (err, err_plain)
    for p in ((0, 2), (1, 1), (2, 0)):
        d = conv3d_split6(x, w, F32, (p,)).double()
        beta = ((r * d).sum() / (d * d).sum()).item()
        assert abs(beta) <= 0.5, (p, beta)


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,D,H,W", [(32, 32, 3, 19, 37),
                                         (64, 128, 2, 10, 40)])
def test_wtile_conv3d_f32_grads_match_plain(f32_exact, ci, co, D, H, W):
    g = torch.Generator(device=f32_exact).manual_seed(5)
    x0 = torch.randn((2, D, H, W, ci), device=f32_exact, generator=g)
    w0 = torch.randn((3, 3, 3, ci, co), device=f32_exact, generator=g) * 0.05

    def run(fn):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(x, w) ** 2).sum().backward()
        return x.grad, w.grad

    before = K7.conv3d_same.launches
    dx, dw = run(K7.wtile_conv3d)
    torch.cuda.synchronize()
    assert K7.conv3d_same.launches == before + 2
    for a, b in zip((dx, dw), run(K7.wtile_conv3d_plain)):
        _rel_close(a, b)


# Q8, the int8 conv (ops/conv_int8.py, csrc/conv3d_int8.cu), against its
# plain version (a float64 conv of the quantized integers, exact, then
# the same f32 epilogue): bit-equal bf16 outputs, two runs bit-identical.
# (ci, co, (B, D, H, W), x dtype, bias): the DoubleConv widths (ci = 4
# packed, one and several 32-channel chunks, N = 32 and 64 tiles) over
# ragged volumes, ci not a multiple of 8 (scalar loads), co = 8 and 48 (a
# partly masked channel tile), small volumes whose patch holds several
# samples (the bottleneck's 4^3 at batch 4), 1024 -> 1024; then x at and
# beside the rounding ties (k + 0.5) * act_scale ("-ties"), ci = 4 on
# ragged volumes at B = 1 and 3, the split-K shapes (512 -> 512 and
# 1024 -> 512 at (4, 8^3); 1024 -> 640 at (1, 4^3) splits 32 chunks 13
# ways, unevenly), D = 1 and 2
Q8_CASES = [
    (4, 32, (2, 5, 19, 37), "bf16", False),
    (4, 32, (2, 5, 19, 37), "f32", True),
    (32, 32, (2, 6, 17, 23), "bf16", False),
    (64, 32, (1, 9, 16, 16), "bf16", True),
    (32, 64, (2, 8, 24, 40), "bf16", False),
    (96, 64, (2, 5, 9, 11), "f32", False),
    (128, 128, (4, 8, 8, 8), "bf16", False),
    (12, 16, (2, 3, 7, 10), "bf16", True),
    (20, 8, (1, 4, 5, 6), "f32", False),
    (64, 48, (2, 4, 6, 9), "bf16", True),
    (512, 1024, (4, 4, 4, 4), "bf16", False),
    (1024, 1024, (4, 4, 4, 4), "bf16", False),
    (32, 32, (3, 1, 2, 3), "bf16", False),
    (32, 32, (2, 6, 17, 23), "bf16-ties", False),
    (64, 64, (1, 5, 9, 11), "f32-ties", True),
    (4, 32, (2, 5, 19, 37), "bf16-ties", False),
    (4, 32, (1, 7, 13, 21), "bf16", True),
    (4, 64, (3, 5, 9, 6), "f32", False),
    (512, 512, (4, 8, 8, 8), "bf16", False),
    (1024, 512, (4, 8, 8, 8), "bf16", True),
    (1024, 640, (1, 4, 4, 4), "bf16", False),
    (32, 32, (2, 1, 12, 20), "bf16", True),
    (64, 64, (1, 2, 16, 16), "f32", False),
]


def _q8_inputs(dev, ci, co, shape, dt, bias):
    g = torch.Generator(device=dev).manual_seed(ci * 7 + co)
    if dt.endswith("-ties"):
        # act_scale a power of two and x = (k + 0.5) * s exactly (bf16
        # holds k + 0.5 for |k| <= 127), each tie, the values one ulp of
        # x's dtype below and above it, and a few past the clip
        s = torch.tensor(2.0 ** -3, device=dev)
        k = torch.randint(-130, 130, (*shape, ci), device=dev, generator=g)
        tie = (k.float() + 0.5) * s
        x = tie.to(BF16 if dt.startswith("bf16") else torch.float32)
        # a neighbour in the bit pattern: one ulp off (x is never 0)
        bits = x.view(torch.int16 if x.dtype == BF16 else torch.int32)
        step = torch.randint(-1, 2, x.shape, device=dev, generator=g)
        x = (bits + step.to(bits.dtype)).view(x.dtype)
    else:
        x = torch.randn((*shape, ci), device=dev, generator=g)
        x = x.to(BF16) if dt == "bf16" else x
        s = (x.float().abs().amax() * 0.8 / 127).reshape(())
    w = torch.randn((3, 3, 3, ci, co), device=dev, generator=g) * 0.05
    b = torch.randn((co,), device=dev, generator=g) if bias else None
    return x, w, s, b


@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,shape,dt,bias", Q8_CASES)
def test_conv3d_int8_kernel_matches_plain(cuda, ci, co, shape, dt, bias):
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import conv_int8 as Q8
    x, w, s, b = _q8_inputs(cuda, ci, co, shape, dt, bias)
    if dt.endswith("-ties"):   # ties are there, and the ulp either side
        r = x.float() / s
        assert (r - r.floor() == 0.5).any() and (r - r.floor() != 0.5).any()
    before = Q8.conv3d_int8.launches
    prep = Q8.prepare_weights_int8(w)
    y = Q8.conv3d_int8(x, w, s, b)                  # weights in the call
    cached = Q8.conv3d_int8(x, w, s, b, prep)
    again = Q8.conv3d_int8(x, w, s, b, prep)
    torch.cuda.synchronize()
    assert Q8.conv3d_int8.launches == before + 3
    assert y.dtype == BF16 and tuple(y.shape) == (*shape, co)
    ref = Q8.conv3d_int8_plain(x, w, s, b)
    assert torch.equal(y, ref), (y.float() - ref.float()).abs().max().item()
    assert torch.equal(cached, y) and torch.equal(again, cached)
    wq, ws = Q8.quantize_weights_int8(w)
    assert torch.equal(prep.wq, Q8.int8_weight_layout(wq))
    assert torch.equal(prep.w_scale, ws)
    p = Q8.conv3d_int8_plan(*shape, ci, co)
    assert p == Q8.conv3d_int8_plan_of(*shape, ci, co)
    assert p["TB"] * p["TD"] * p["TH"] * p["TW"] <= 256 * (2 - p["resident"]), p
    assert p["N"] in (32, 64) and p["smem"] <= 227 * 1024, p
    if (ci, co, shape) == (1024, 640, (1, 4, 4, 4)):
        assert p["splits"] == 13 and p["chunks"] % p["splits"], p


@pytest.mark.gpu
def test_conv3d_int8_plan_matches_mirror_at_the_model_shapes(cuda):
    """The card's plan equals ``conv3d_int8_plan_of`` at the 17 distinct
    DoubleConv shapes of a full-width 4 x 128^3 batch."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.compare_builds import q8_shapes
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import conv_int8 as Q8
    shapes = q8_shapes()
    assert len(shapes) == 17 and sum(map(len, shapes.values())) == 22
    for ci, co, s in sorted(shapes):
        assert (Q8.conv3d_int8_plan(4, s, s, s, ci, co)
                == Q8.conv3d_int8_plan_of(4, s, s, s, ci, co)), (ci, co, s)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 64])
def test_conv3d_int8_wgmma_tile_step(cuda, n):
    """One int8 wgmma through the kernel's fragment loads, weight layout
    and descriptor (the C entry ``conv3d_int8_wgmma_probe``: d (64, n)
    int32 = a (64, 32) int8 @ b (n, 32) int8 transposed) equals the
    integer product."""
    import ctypes
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.ps2d import _lib, _stream
    g = torch.Generator(device=cuda).manual_seed(n)
    a = torch.randint(-127, 128, (64, 32), device=cuda, generator=g)
    b = torch.randint(-127, 128, (n, 32), device=cuda, generator=g)
    a8, b8 = a.to(torch.int8).contiguous(), b.to(torch.int8).contiguous()
    d = torch.empty((64, n), dtype=torch.int32, device=cuda)
    lib = _lib()
    fn = lib._dll.conv3d_int8_wgmma_probe
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    lib.check("conv3d_int8_wgmma_probe", fn(a8.data_ptr(), b8.data_ptr(),
                                            d.data_ptr(), n, _stream()))
    assert torch.equal(d.cpu(), (a.cpu() @ b.cpu().T).int())


@pytest.mark.gpu
def test_conv3d_int8_python_scale_and_refusals(cuda):
    """A Python float scale gives the tensor scale's bits; co not a
    multiple of 8 and a non-float x are refused."""
    from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import conv_int8 as Q8
    x, w, s, _ = _q8_inputs(cuda, 32, 32, (1, 4, 8, 8), "bf16", False)
    assert torch.equal(Q8.conv3d_int8(x, w, float(s)), Q8.conv3d_int8(x, w, s))
    with pytest.raises(ValueError):
        Q8.conv3d_int8(x, w[..., :12], s)
    with pytest.raises(ValueError):
        Q8.conv3d_int8(x.to(torch.float16), w, s)
