"""K1's f32 form computes on the tensor cores as three bf16 passes over an
exact split of its activations (``csrc/ps2d_conv3d_f32.cu``). Here, on
the CPU, the split's plain mirror (``ops/ps2d.py::split3_bf16``) and the
three-pass conv built on it:

  * the split reconstructs every finite f32 bit pattern with
    2^-110 <= |x| <= 3.3895e38 (bf16's largest finite value) exactly,
    ``hi.float() + mid.float() + lo.float() == x`` bit for bit
    (hypothesis, a million seeded patterns, and fixed cases: the range's
    edges, bf16 rounding ties, +-1 +- 2^-9 +- 2^-17), and +-0 as zero
    (-0 comes back as +0: under round to nearest a sum of a -0 and +0
    parts is +0);
  * its two edges, pinned: below 2^-110 (subnormals included) the error
    stays under 2^-133 absolute, bf16's subnormal grid; from the rounding
    midpoint above bf16's largest finite value on, hi is infinite;
  * the three passes' plain convs with the bf16-rounded weights, summed in
    float64, equal the float64 conv of x' within 1e-12 * max|ref|;
  * summed in f32, they hold to JAX's f32 K1 (its Pallas kernel in
    interpret mode, run as ``test_torch_f32_region._k1_pair`` runs it)
    within 1e-5 * max|ref|, at one input with the affine and ReLU and at
    two inputs with the mask.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.pallas import ps2d as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import ps2d as T

from test_torch_f32_region import _close, _k1_pair

BF16_MAX = float(torch.finfo(torch.bfloat16).max)     # 3.3895e38
LO_BITS = 17 << 23                                    # 2^-110
HI_BITS = int(np.array(BF16_MAX, np.float32).view(np.uint32))


def _f32(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32))


def _sum3(x: torch.Tensor) -> torch.Tensor:
    hi, mid, lo = T.split3_bf16(x)
    return hi.float() + mid.float() + lo.float()


def _assert_exact(x: torch.Tensor) -> None:
    got = _sum3(x)
    bad = got.view(torch.int32) != x.view(torch.int32)
    assert not bad.any(), (x[bad][:4].tolist(), got[bad][:4].tolist())


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(LO_BITS, HI_BITS), st.booleans()),
                min_size=1, max_size=64))
def test_split3_reconstructs_exactly(patterns):
    _assert_exact(_f32([b | (s << 31) for b, s in patterns]))


def test_split3_exact_over_random_bit_patterns():
    rng = np.random.default_rng(0)
    bits = rng.integers(LO_BITS, HI_BITS, size=1 << 20, endpoint=True,
                        dtype=np.uint32)
    bits |= rng.integers(0, 2, size=bits.size, dtype=np.uint32) << 31
    _assert_exact(_f32(bits))


def test_split3_fixed_cases():
    tie = 1 + 2.0 ** -8          # halfway between two bf16 values: to even
    vals = [2.0 ** -110, -(2.0 ** -110), BF16_MAX, -BF16_MAX,
            tie, -tie, 1 + 3 * 2.0 ** -8, 3 * 2.0 ** -9, 2.0 ** 100 * tie,
            np.float32(np.pi), np.float32(1 / 3)]
    vals += [s0 * (1 + s1 * 2.0 ** -9 + s2 * 2.0 ** -17)
             for s0 in (1, -1) for s1 in (1, -1) for s2 in (1, -1)]
    x = torch.tensor(vals, dtype=torch.float32)
    _assert_exact(x)
    zeros = _sum3(torch.tensor([0.0, -0.0]))
    assert torch.equal(zeros.view(torch.int32),
                       torch.zeros(2, dtype=torch.int32))
    hi, mid, lo = T.split3_bf16(torch.tensor([tie]))
    assert hi.item() == 1.0 and mid.item() == 2.0 ** -8 and lo.item() == 0


def test_split3_below_range_errs_under_bf16_subnormal_grid():
    """Below 2^-110 the third part falls under bf16's subnormal grid
    (2^-133): the sum misses x by less than 2^-133 (and often does)."""
    rng = np.random.default_rng(1)
    bits = rng.integers(1, LO_BITS, size=1 << 18, dtype=np.uint32)
    bits = np.concatenate([bits, [1, LO_BITS - 1, 1 << 23]])  # subnormals too
    x = _f32(bits | (rng.integers(0, 2, bits.size, np.uint32) << 31))
    err = (_sum3(x).double() - x.double()).abs()
    assert err.max().item() < 2.0 ** -133
    assert (err > 0).any()


def test_split3_hi_infinite_past_bf16_range():
    """Up to bf16's largest finite value the split is exact; from the
    rounding midpoint above it (0x7F7F8000, 3.3896e38) on, hi rounds to
    infinity."""
    _assert_exact(_f32([HI_BITS, HI_BITS | 1 << 31]))
    mid = HI_BITS + 0x8000
    x = _f32([mid, mid + 1, 0x7F7FFFFF, mid | 1 << 31])
    hi, _, _ = T.split3_bf16(x)
    assert torch.isinf(hi).all() and (hi.float().sign() == x.sign()).all()


def _three_pass_case(rng, cis, co, affine, mul0):
    """A K1 call's x' (its inputs after the on-load transform, f32) and
    bf16-rounded weights, the level-0 region's widths at a small size."""
    B, D, H, W = 2, 3, 6, 7
    xs = [T.pack_halo(torch.from_numpy(rng.normal(size=(B, D, H, W, c))
                                       .astype(np.float32))) for c in cis]
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, sum(cis), co)) * 0.1)
                         .astype(np.float32))
    kw = {}
    if affine:
        kw = dict(in_scale=torch.from_numpy(
            1 + 0.3 * rng.normal(size=(B, sum(cis))).astype(np.float32)),
            in_shift=torch.from_numpy(
                0.3 * rng.normal(size=(B, sum(cis))).astype(np.float32)))
    if mul0:
        kw["in_mul0"] = T.pack_halo(torch.from_numpy(
            rng.random((B, D, H, W, cis[0])).astype(np.float32)))
    return xs, w, kw


def _x_prime(xs, kw, relu):
    vs = T._transform_inputs(xs, kw.get("in_scale"), kw.get("in_shift"),
                             relu, kw.get("in_mul0"))
    return torch.cat(vs, -1)


def _conv(x, w, dtype):
    """VALID conv of a halo tensor (== SAME over its interior) in dtype,
    NDHWC / DHWIO -> NDHWC."""
    y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3),
                 w.to(dtype).permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("cis,co,affine,relu,mul0", [
    ((32,), 32, True, True, False),
    ((32, 32), 32, False, False, True),
    ((64,), 64, True, False, False),
])
def test_three_pass_conv_equals_float64_conv(cis, co, affine, relu, mul0):
    rng = np.random.default_rng(sum(cis) + co)
    xs, w, kw = _three_pass_case(rng, cis, co, affine, mul0)
    xp = _x_prime(xs, kw, relu)
    wr = w.to(torch.bfloat16)
    ref = _conv(xp, wr, torch.float64)
    got = sum(_conv(p, wr, torch.float64) for p in T.split3_bf16(xp))
    d = (got - ref).abs().max().item()
    assert d <= 1e-12 * ref.abs().max().item(), d
    # the weights' rounding is the kernel's: unrounded weights miss
    assert (_conv(xp, w, torch.float64) - ref).abs().max() > 1e-4


@pytest.mark.parametrize("cis,co,affine,mul0", [
    ((32,), 32, True, False),
    ((32, 32), 32, False, True),
])
def test_three_pass_conv_matches_jax_f32_k1(monkeypatch, cis, co, affine,
                                            mul0):
    """The three passes summed in f32, on the inputs of JAX's f32 K1 (the
    port's call on them is intercepted for its x' and weights)."""
    calls = []
    real = T.conv3d_halo

    def spy(xs, w, **kw):
        calls.append((xs, w, kw))
        return real(xs, w, **kw)

    monkeypatch.setattr(T, "conv3d_halo", spy)
    res_j, _, plan, _, _ = _k1_pair(cis, co, affine, mul0, stats=False)
    (xs, w, kw), = calls
    xp = _x_prime(xs, kw, kw.get("in_relu", False))
    wr = w.to(torch.bfloat16)
    hi, mid, lo = (_conv(p, wr, torch.float32) for p in T.split3_bf16(xp))
    got = (hi + mid) + lo
    _close(got, J.flat_to_normal(res_j, plan))
