"""K5's launch plan and its order of summation, on the CPU (no JAX).

``ops/groupnorm.py::group_norm_plan`` mirrors the C code's plan
(``csrc/group_norm.cu::make_plan``), ``group_norm_ranges`` and
``group_norm_block_of`` its walk: every row of every sample lies in
exactly one block's range, the stages' bulk copies are 16 B multiples at
16 B aligned addresses, the resident area and the ring fit a block's
227 KB, and the grid is no larger than the blocks that may run at once.
``fused_group_norm_mirror`` sums per-item partials in the plan's block
order and folds them with ``group_affine``: within 1e-6 of max|ref| of
``fused_group_norm_plain`` in f32 (f32 sums in another order), and within
1 bf16 ulp of max|ref| in bf16 (one rounding of nearly equal f32 values).
The card's plan is held to this one in ``tests/test_torch_kernels.py``.
"""

import math

import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import groupnorm as K5

F32, BF16 = torch.float32, torch.bfloat16
SMEM = K5.H100_SMEM_PER_BLOCK          # 227 KB

# (n, m, c, dtype, residual dtype): chip_smoke.py's forms,
# tests/test_torch_kernels.py's K5 cases, many samples of few rows
# (n > grid), C = 12 and 24 (one value an access, 16 B every 2 or 4 rows;
# a bf16 residual beside f32 x sets the granule), C = 3 in bf16 (every 8
# rows), wide rows (more vectors a row than consumer threads), a prime
# row count, and an f32 residual beside bf16 x (a residual ring twice x's)
PLAN_CASES = [
    (4, 128 ** 3, 32, F32, None), (4, 128 ** 3, 32, BF16, None),
    (4, 128 ** 3, 32, BF16, BF16), (4, 128 ** 3, 32, F32, F32),
    (1, 240 * 240 * 160, 32, BF16, BF16),
    (2, 5 * 9 * 20, 32, F32, None), (1, 5 * 3 * 7, 32, BF16, F32),
    (3, 64, 16, F32, None), (2, 105, 24, BF16, BF16),
    (2, 105, 12, F32, BF16), (2, 105, 12, BF16, None),
    (1, 30, 512, F32, F32), (2, 16 * 32 * 40, 32, BF16, F32),
    (300, 8, 32, F32, None), (300, 3, 12, BF16, F32),
    (5, 99991, 8, BF16, None), (7, 1001, 3, BF16, BF16),
    (1, 5, 4096, F32, None), (65535, 2, 8, F32, BF16),
]
NAME = {F32: "f32", BF16: "bf16", None: "none"}


def _id(case):
    n, m, c, dt, rd = case
    return f"{n}x{m}x{c}-{NAME[dt]}-res-{NAME[rd]}"


def _plan(case, **kw):
    n, m, c, dt, rd = case
    return K5.group_norm_plan(n, m, c, dt, res_dtype=rd, **kw)


def _stages(plan, r0, r1):
    """An item's bulk-copied stages (first flat row, rows), as the
    kernel's ``set_item`` cuts them: from the first 16 B boundary at or
    after r0 to the last at or before r1."""
    g, sr = plan["gran"], plan["stage_rows"]
    ra, rb = -(-r0 // g) * g, r1 // g * g
    return [(r, min(sr, rb - r)) for r in range(ra, rb, sr)] if ra < rb \
        else []


@pytest.mark.parametrize("case", PLAN_CASES, ids=_id)
def test_every_row_lies_in_exactly_one_range(case):
    n, m = case[:2]
    plan = _plan(case)
    ranges = K5.group_norm_ranges(plan, n, m)
    assert len(ranges) == plan["grid"]
    end = 0
    for b, items in enumerate(ranges):
        assert items, f"block {b} has no rows"
        assert items[0][1] % plan["gran"] == 0  # cut at 16 B boundaries
        for k, r0, r1 in items:
            assert r0 == end and r1 > r0       # contiguous, no overlap
            assert k * m <= r0 and r1 <= (k + 1) * m   # inside sample k
            end = r1
        assert [k for k, _, _ in items] == list(
            range(items[0][0], items[-1][0] + 1))
    assert end == n * m
    # each sample's rows, in its items' order, are [k m, (k + 1) m)
    per = {}
    for items in ranges:
        for k, r0, r1 in items:
            per.setdefault(k, []).append((r0, r1))
    assert sorted(per) == list(range(n))
    for k, spans in per.items():
        assert spans[0][0] == k * m and spans[-1][1] == (k + 1) * m


@pytest.mark.parametrize("case", PLAN_CASES, ids=_id)
def test_block_of_finds_each_range(case):
    n, m = case[:2]
    plan = _plan(case)
    for b, items in enumerate(K5.group_norm_ranges(plan, n, m)):
        lo, hi = items[0][1], items[-1][2]
        for r in {lo, lo + 1, (lo + hi) // 2, hi - 2, hi - 1}:
            if lo <= r < hi:
                assert K5.group_norm_block_of(plan, r) == b, (r, b)
    if n * m <= 5000:                          # every row
        owner = [b for b, items in enumerate(K5.group_norm_ranges(plan, n, m))
                 for _, r0, r1 in items for _ in range(r0, r1)]
        assert [K5.group_norm_block_of(plan, r) for r in range(n * m)] == owner


@pytest.mark.parametrize("case", PLAN_CASES, ids=_id)
def test_plan_fits_shared_memory_and_copies_are_16_bytes(case):
    n, m, c, dt, rd = case
    plan = _plan(case)
    rows_of = [c * dt.itemsize] + ([c * rd.itemsize] if rd else [])
    row = rows_of[0]
    sb, rsb = plan["stage_bytes"], plan["res_stage_bytes"]
    assert sb % 16 == 0 and sb == plan["stage_rows"] * row
    assert rsb == (plan["stage_rows"] * c * rd.itemsize if rd else 0)
    assert rsb % 16 == 0 and rsb < 1 << 20
    assert plan["stage_rows"] % plan["gran"] == 0
    assert plan["gran"] == max(math.lcm(w, 16) // w for w in rows_of)
    assert (plan["depth"] * (sb + rsb) + plan["nres"] * sb
            <= plan["smem"] <= SMEM)
    assert plan["resident_bytes"] == plan["nres"] * sb
    assert 2 <= plan["depth"] <= 4 and sb < 1 << 20
    for items in K5.group_norm_ranges(plan, n, m)[:3]:
        for _, r0, r1 in items:
            for r, rows in _stages(plan, r0, r1):
                for w in rows_of:               # x and the residual
                    assert r * w % 16 == 0 and rows * w % 16 == 0
                assert 0 < rows <= plan["stage_rows"]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("case", PLAN_CASES, ids=_id)
def test_grid_within_coresident_blocks(case, sms):
    plan = _plan(case, sms=sms)
    assert 1 <= plan["grid"] <= sms
    assert plan["grid"] <= max(1, plan["units"])   # no block without rows


def test_plan_of_the_timed_forms():
    """The (4, 128^3, 32) forms: one block an SM, 33 a sample, 32 KB
    stages; without a residual a ring of 4 and 2 resident stages (64 KB
    a block, 192 KB with the ring's last stages on chip between the
    passes), with one of x's type rings of 3 and none resident."""
    for dt in (F32, BF16):
        for rd, depth, nres in ((None, 4, 2), (dt, 3, 0)):
            p = K5.group_norm_plan(4, 128 ** 3, 32, dt, res_dtype=rd)
            assert (p["grid"], p["blocks_per_sample"], p["stage_bytes"],
                    p["depth"], p["nres"]) == (132, 33, 32768, depth, nres)
            assert p["smem"] <= SMEM


def test_a_residual_that_is_x_streams_nothing():
    x = torch.zeros((2, 8, 16))
    assert K5.residual_stream_dtype(x, None) is None
    assert K5.residual_stream_dtype(x, x) is None
    assert K5.residual_stream_dtype(x, x.clone()) == F32
    assert K5.residual_stream_dtype(x, x.to(BF16)) == BF16


def test_plan_refuses_rows_too_wide():
    with pytest.raises(ValueError):
        K5.group_norm_plan(1, 4, 1 << 17, F32)


# (shape, groups): tests/test_torch_kernels.py's K5 cases, many samples
# of few voxels (n > grid), and C = 12 and 24 (the scalar path)
MIRROR_CASES = [
    ((2, 5, 9, 20, 32), 8),
    ((1, 5, 3, 7, 32), 4),
    ((3, 4, 4, 4, 16), 1),
    ((2, 3, 5, 7, 24), 4),
    ((2, 3, 5, 7, 12), 4),
    ((1, 2, 3, 5, 512), 8),
    ((2, 16, 32, 40, 32), 8),
    ((300, 2, 2, 2, 32), 8),
    ((300, 3, 1, 1, 12), 4),
    ((4, 6, 5, 7, 24), 8),
]


def _ulp(m):
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu,residual", [(False, None), (True, "same"),
                                           (False, "f32")])
@pytest.mark.parametrize("shape,groups", MIRROR_CASES)
def test_mirror_matches_plain(shape, groups, relu, residual, dtype):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 2
                         + 0.5).to(dtype)
    gamma = torch.from_numpy(1 + 0.3 * rng.normal(size=shape[-1])).float()
    beta = torch.from_numpy(0.3 * rng.normal(size=shape[-1])).float()
    r = None
    if residual is not None:
        r = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            dtype if residual == "same" else F32)
    got, plan = K5.fused_group_norm_mirror(x, gamma, beta, groups,
                                           residual=r, relu=relu)
    ref = K5.fused_group_norm_plain(x, gamma, beta, groups, residual=r,
                                    relu=relu)
    assert got.dtype == dtype and got.shape == x.shape
    m = ref.float().abs().max().item()
    d = (got.float() - ref.float()).abs().max().item()
    assert d <= (1e-6 * m if dtype == F32 else _ulp(m)), d
    if shape[0] == 300:
        assert plan["grid"] < shape[0]         # blocks walk many samples


def test_mirror_adds_partials_of_blocks_that_share_a_sample():
    """Five samples on a grid of 7: ranges cross samples, so samples
    take partials from two or three blocks; the mirror still matches."""
    n, c = 5, 16
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, 4000, c)).astype(np.float32))
    plan = K5.group_norm_plan(n, 4000, c, F32, sms=7)
    ranges = K5.group_norm_ranges(plan, n, 4000)
    assert plan["grid"] == 7 and any(len(items) > 1 for items in ranges)
    gamma, beta = torch.ones(c), torch.zeros(c)
    got, _ = K5.fused_group_norm_mirror(x, gamma, beta, 4, plan=plan)
    ref = K5.fused_group_norm_plain(x, gamma, beta, 4)
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
