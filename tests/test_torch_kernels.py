"""Each CUDA kernel of the port against its plain PyTorch version, on
the card (marker ``gpu``; they skip without a CUDA device).

This file imports no JAX, so it also runs on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

(``tests/conftest.py`` imports JAX, hence ``--noconftest``.) Tolerances
as in test_torch_ps2d.py: pack bit-exact; the transposed conv within
1 bf16 ulp of max|ref|; the conv within 2^-7 * max|ref| and its sums
within 1e-3 of the largest sum (f32 sums in another order, atomics).
"""

import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

BF16 = torch.bfloat16


def _ulp(m):
    """One bf16 ulp at magnitude m."""
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


# (cis, co, affine, relu, mul0, stats): the region's three call forms
# and the remaining combinations
K1_CASES = [
    ((32,), 32, None, False, False, False),
    ((32,), 32, "both", True, False, True),
    ((32, 32), 32, None, False, True, True),
    ((32, 32), 16, "both", False, True, True),
    ((64,), 64, "scale", True, False, False),
    ((32, 32), 32, "shift", True, False, True),
]


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
def test_up_k2s2_into_halo_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 3, 5, 6, 64), device=cuda, generator=g).to(BF16)
    w = (torch.randn((2, 2, 2, 64, 32), device=cuda, generator=g)
         * 0.1).to(BF16)
    b = torch.randn((32,), device=cuda, generator=g) * 0.1
    before = T.up_k2s2_into_halo.launches
    got, ref = T.up_k2s2_into_halo(x, w, b), T.up_k2s2_into_halo_plain(x, w, b)
    assert T.up_k2s2_into_halo.launches == before + 1
    d = (got.float() - ref.float()).abs().max().item()
    assert d <= _ulp(ref.float().abs().max().item()), d


@pytest.mark.gpu
@pytest.mark.parametrize("cis,co,affine,relu,mul0,stats", K1_CASES)
def test_conv3d_halo_kernel_matches_plain(cuda, cis, co, affine, relu,
                                          mul0, stats):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, D, H, W = 2, 3, 19, 37     # ragged against the 8x32 output tiles

    def rnd(shape, s=1.0):
        return (torch.randn(shape, device=cuda, generator=g) * s).to(BF16)

    xs = [T.pack_halo(rnd((B, D, H, W, c))) for c in cis]
    w = rnd((3, 3, 3, sum(cis), co), 0.1)
    kw = {}
    if affine in ("scale", "both"):
        kw["in_scale"] = rnd((B, sum(cis)), 0.3) + 1
    if affine in ("shift", "both"):
        kw["in_shift"] = rnd((B, sum(cis)), 0.3)
    if mul0:
        kw["in_mul0"] = T.pack_halo(rnd((B, D, H, W, cis[0]), 0.5))
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
def test_kernels_refuse_unsupported_inputs(cuda):
    with pytest.raises(ValueError):
        T.pack_halo(torch.zeros((1, 2, 2, 2, 12), device=cuda, dtype=BF16))
    with pytest.raises(ValueError):
        T.conv3d_halo([torch.zeros((1, 4, 4, 4, 16), device=cuda,
                                   dtype=BF16)],
                      torch.zeros((3, 3, 3, 16, 32), device=cuda))
