"""Q8, the int8 conv of int8 serving (``csrc/conv3d_int8.cu``), on the
CPU: its launch plan's Python mirror (``ops/conv_int8.py::
conv3d_int8_plan_of``, which the wrapper sizes its scratch by; a ``gpu``
test in ``tests/test_torch_kernels.py`` holds the card's plan to it), an
emulation of the kernel's K order bit-equal to JAX's
``conv3d_zcat_int8``, and the weight cache of ``FastConv3D``'s int8 mode.

  * The plan's invariants at the 17 distinct DoubleConv shapes of a
    full-width 4 x 128^3 window batch and at the card tests' shapes:
    every output voxel and channel tile is written by one item a split
    and every 32-channel chunk of K by exactly one split, the patch has
    at most 256 voxels (128 where N = 64 or packed; twice that streamed)
    and its input tile at most 1024, shared memory
    fits 232,448 B with a ring of two to six stages, and the int32
    sum cannot overflow (27 * cip * 127^2 < 2^31).
  * The emulation walks the plan's blocks and items as the kernel does:
    x quantized once into an int8 copy padded to cip channels (zeros
    outside the volume), the weights in the kernel's layout
    (``int8_weight_layout``), per item and chunk the 27 taps' products
    (packed: K over (tap, channel) pairs), each split's partial sums
    added in int64, then the f32 epilogue. Bit-equal to JAX's bf16
    output: the sums are exact integers, whatever their order.
  * The weight cache: an int8 forward keeps its prepared weights across
    calls; weights loaded by ``load_state_dict``, by the weight bridge
    (``load_flax_params``) or from a port checkpoint change the next
    forward to those weights' result; a ``with_quant_mode`` clone starts
    with no entry; the cache is no part of ``state_dict``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.conv import (
    conv3d_zcat_int8 as j_conv3d_zcat_int8)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    calibrate_int8)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, load_flax_params, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import (
    conv_int8 as Q8)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv import (
    FastConv3D, quantize_weights_int8)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.checkpoints import (
    load_inference_weights, save_params_only)

S = 128

# the 17 distinct (ci, co, side) of the full-width UNet's 22 DoubleConv
# convs at a 4 x 128^3 window batch
MODEL_SHAPES = sorted({(4, 32, 128), (32, 32, 128), (64, 32, 128),
                       (32, 64, 64), (64, 64, 64), (128, 64, 64),
                       (64, 128, 32), (128, 128, 32), (256, 128, 32),
                       (128, 256, 16), (256, 256, 16), (512, 256, 16),
                       (256, 512, 8), (512, 512, 8), (1024, 512, 8),
                       (512, 1024, 4), (1024, 1024, 4)})
# the card tests' shapes (tests/test_torch_kernels.py Q8_CASES and the
# split, tie and ragged cases)
CARD_SHAPES = [(4, 32, (2, 5, 19, 37)), (32, 32, (2, 6, 17, 23)),
               (64, 32, (1, 9, 16, 16)), (32, 64, (2, 8, 24, 40)),
               (96, 64, (2, 5, 9, 11)), (128, 128, (4, 8, 8, 8)),
               (12, 16, (2, 3, 7, 10)), (20, 8, (1, 4, 5, 6)),
               (64, 48, (2, 4, 6, 9)), (512, 1024, (4, 4, 4, 4)),
               (1024, 1024, (4, 4, 4, 4)), (32, 32, (3, 1, 2, 3)),
               (4, 32, (1, 7, 13, 21)), (4, 64, (3, 5, 9, 6)),
               (512, 512, (4, 8, 8, 8)), (1024, 512, (4, 8, 8, 8)),
               (1024, 640, (1, 4, 4, 4)), (32, 32, (2, 1, 12, 20)),
               (64, 64, (1, 2, 16, 16))]
ALL = ([(ci, co, (4, s, s, s)) for ci, co, s in MODEL_SHAPES]
       + CARD_SHAPES)


def _ids(cases):
    return [f"{ci}-{co}-{'x'.join(map(str, sh))}" for ci, co, sh in cases]


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("ci,co,shape", ALL, ids=_ids(ALL))
def test_plan_invariants(ci, co, shape):
    p = Q8.conv3d_int8_plan_of(*shape, ci, co)
    assert p["TB"] * p["TD"] * p["TH"] * p["TW"] <= (
        Q8.ROWS if p["N"] == 32 and not p["packed"] else Q8.ROWS // 2) * (
        2 - p["resident"]), p
    assert p["tile_voxels"] <= Q8.MAX_TILE, p
    assert p["smem"] <= Q8.SMEM_MAX and 2 <= p["stages"] <= Q8.MAX_STAGES, p
    assert 27 * p["cip"] * 127 ** 2 < 2 ** 31
    assert p["chunks"] == (1 if p["packed"] else p["cip"] // 32)
    assert p["k16"] * 16 == (128 if p["packed"] else 27 * p["cip"])
    assert 1 <= p["splits"] <= p["chunks"]
    assert p["splits"] == 1 or not p["resident"]
    # every (voxel, channel tile, chunk) once, over the blocks' items
    B, D, H, W = shape
    cov = np.zeros((B, D, H, W, p["n_tiles"], p["chunks"]), np.uint8)
    n_local = p["patches"] if p["resident"] else p["items"]
    for by in range(p["grid_y"]):
        for bx in range(p["grid_x"]):
            for it in range(bx, n_local, p["grid_x"]):
                m = Q8.conv3d_int8_item(p, shape, it, by)
                cov[m["b0"]:m["b0"] + p["TB"], m["d0"]:m["d0"] + p["TD"],
                    m["h0"]:m["h0"] + p["TH"], m["w0"]:m["w0"] + p["TW"],
                    m["nt"], m["c_lo"]:m["c_hi"]] += 1
    assert (cov == 1).all(), (cov.min(), cov.max())


def test_plan_forms_at_the_model_shapes():
    """Level 0 (and 64^3 but 128 -> 64) keeps its weights resident, ci = 4
    is packed, the 8^3 and 4^3 levels split K; the int8 copy of x is read
    2.34 times an element at level 0's 4 x 8 x 8 patch."""
    forms = {(ci, co, s): Q8.conv3d_int8_plan_of(4, s, s, s, ci, co)
             for ci, co, s in MODEL_SHAPES}
    assert forms[(4, 32, S)]["form"] == "packed"
    for k in [(32, 32, S), (64, 32, S), (32, 64, 64), (64, 64, 64)]:
        assert forms[k]["form"] == "resident", (k, forms[k])
    assert forms[(32, 32, S)]["overlap"] == pytest.approx(600 / 256)
    for k, p in forms.items():
        if k[2] <= 8:
            assert p["form"] == "streamed" and p["splits"] > 1, (k, p)
            assert p["items"] <= Q8.SMS, (k, p)
    assert forms[(1024, 1024, 4)]["splits"] == 8


def test_plan_refuses_what_the_kernel_refuses():
    for bad in [(1, 4, 4, 4, 32, 12), (1, 4, 4, 4, 32, 0),
                (0, 4, 4, 4, 32, 32)]:
        with pytest.raises(ValueError):
            Q8.conv3d_int8_plan_of(*bad)


def test_weight_layout_is_the_kernels():
    """Row (o, k16) of the layout holds K rows 16 k16 .. 16 k16 + 15 of
    channel o: k = t * cip + c, or packed k = t * 4 + c, zeros past."""
    rng = np.random.default_rng(3)
    for ci, co in [(4, 16), (3, 8), (20, 24), (64, 32)]:
        wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, ci, co),
                                           dtype=np.int8))
        lay = Q8.int8_weight_layout(wq).numpy()
        cip = 4 if ci <= 4 else -(-ci // 32) * 32
        kp = 128 if ci <= 4 else 27 * cip
        assert lay.shape == (co * kp,)
        lay = lay.reshape(co // 8, kp // 16, 8, 16)
        w = wq.numpy().reshape(27, ci, co)
        for o in range(co):
            for k in range(kp):
                t, c = divmod(k, cip)
                want = w[t, c, o] if t < 27 and c < ci else 0
                assert lay[o // 8, k // 16, o % 8, k % 16] == want


# ------------------------------------------------------------- emulation
def emulate(x, w, act_scale, bias=None):
    """Q8's arithmetic in the kernel's order (the module docstring)."""
    B, D, H, W, ci = x.shape
    co = w.shape[-1]
    p = Q8.conv3d_int8_plan_of(B, D, H, W, ci, co)
    N, cip, k16 = p["N"], p["cip"], p["k16"]
    wq, ws = quantize_weights_int8(w)
    lay = Q8.int8_weight_layout(wq).reshape(co // 8, k16, 8, 16)
    bm = lay.permute(1, 3, 0, 2).reshape(k16 * 16, co).double()   # (K, co)
    s = torch.tensor(act_scale, dtype=torch.float32)
    xq = F.pad(Q8.quantize_act_int8(x, s).double(),
               (0, cip - ci, 1, 1, 1, 1, 1, 1))   # zero channels and halo
    acc = torch.zeros((B, D, H, W, co), dtype=torch.int64)
    n_local = p["patches"] if p["resident"] else p["items"]
    for by in range(p["grid_y"]):
        for bx in range(p["grid_x"]):
            for it in range(bx, n_local, p["grid_x"]):
                m = Q8.conv3d_int8_item(p, (B, D, H, W), it, by)
                b0, d0, h0, w0 = m["b0"], m["d0"], m["h0"], m["w0"]
                b1, d1 = min(b0 + p["TB"], B), min(d0 + p["TD"], D)
                h1, w1 = min(h0 + p["TH"], H), min(w0 + p["TW"], W)
                n0, n1 = m["nt"] * N, min(m["nt"] * N + N, co)

                def win(kd, kh, kw):
                    return xq[b0:b1, d0 + kd:d1 + kd, h0 + kh:h1 + kh,
                              w0 + kw:w1 + kw]
                part = torch.zeros((b1 - b0, d1 - d0, h1 - h0, w1 - w0,
                                    n1 - n0), dtype=torch.float64)
                for c in range(m["c_lo"], m["c_hi"]):
                    if p["packed"]:
                        a = torch.cat([win(t // 9, t // 3 % 3, t % 3)
                                       for t in range(27)], -1)
                        a = F.pad(a, (0, 128 - 108))
                        part += a @ bm[:, n0:n1]
                        continue
                    for t in range(27):
                        a = win(t // 9, t // 3 % 3, t % 3)[
                            ..., 32 * c:32 * c + 32]
                        k0 = t * cip + 32 * c
                        part += a @ bm[k0:k0 + 32, n0:n1]
                # the split's int32 partial sums, added (exact)
                acc[b0:b1, d0:d1, h0:h1, w0:w1, n0:n1] += part.to(
                    torch.int64)
    assert acc.abs().max() < 2 ** 31
    y = acc.to(torch.int32).float() * (s * ws)
    if bias is not None:
        y = y + bias.float()
    return y.to(torch.bfloat16)


# (ci, co, (B, D, H, W), x dtype, bias): packed ci = 4 on ragged volumes
# (B = 1 and 3), one and several chunks, D = 1 and 2 (the tile's halo at
# both D ends), a partly masked channel tile, several samples a patch,
# the streamed form with an even and an uneven split of K
EMU_CASES = [
    (4, 32, (1, 5, 9, 11), "bf16", True),
    (4, 16, (3, 3, 6, 10), "f32", False),
    (32, 32, (2, 6, 17, 23), "bf16", False),
    (64, 48, (1, 9, 8, 8), "bf16", True),
    (20, 8, (1, 2, 5, 6), "f32", False),
    (96, 64, (1, 1, 4, 4), "bf16", False),
    (32, 64, (3, 2, 3, 5), "bf16", True),
    (256, 128, (1, 4, 4, 4), "bf16", False),
    (1024, 640, (1, 4, 4, 4), "f32", True),
]


@pytest.mark.parametrize("ci,co,shape,dt,bias", EMU_CASES,
                         ids=_ids([c[:3] for c in EMU_CASES]))
def test_emulation_bit_equal_to_jax(ci, co, shape, dt, bias):
    p = Q8.conv3d_int8_plan_of(*shape, ci, co)
    if ci == 256:
        assert p["form"] == "streamed" and p["splits"] == p["chunks"] == 8
    if ci == 1024:   # 32 chunks over 13 splits: two or three each
        assert p["splits"] == 13 and p["chunks"] % p["splits"], p
    rng = np.random.default_rng(ci * 31 + co)
    x = rng.normal(size=(*shape, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32) if bias else None
    s = np.float32(np.abs(x).max() * 0.9 / 127)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dt == "bf16"
                else (torch.float32, jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    got = emulate(xt, torch.from_numpy(w), s,
                  None if b is None else torch.from_numpy(b))
    want = j_conv3d_zcat_int8(jnp.asarray(x, jdt), jnp.asarray(w),
                              jnp.float32(s),
                              None if b is None else jnp.asarray(b))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ------------------------------------------------------------ the cache
def _calibrated(seed=0):
    """An int8 UNet (features (8, 16), CPU) with calibrated scales, its
    float model, and an input."""
    v = np.random.default_rng(seed).normal(size=(16, 16, 16, 4)).astype(
        np.float32)
    m = UNet3D(features=(8, 16), device="cpu", seed=seed)
    m.eval()
    qm = m.with_quant_mode("int8")
    qm.load_state_dict(load_flax_params(calibrate_int8(m, None, [v])))
    return qm, m, torch.from_numpy(v)[None]


def _weights_of(seed):
    other = UNet3D(features=(8, 16), device="cpu", seed=seed)
    return {k: v for k, v in other.state_dict().items()}


def _fresh(qm, state):
    """A new int8 model with ``qm``'s scales and ``state``'s weights."""
    m = UNet3D(features=(8, 16), device="cpu", seed=0)
    m.eval()
    q = m.with_quant_mode("int8")
    q.load_state_dict(state, strict=False)
    q.load_state_dict({k: v for k, v in qm.state_dict().items()
                       if k.endswith("act_scale")}, strict=False)
    return q


def _convs(m):
    return [c for c in m.modules() if isinstance(c, FastConv3D)
            and c.quant_mode == "int8"]


def test_cache_kept_across_calls_and_not_state():
    qm, _, x = _calibrated()
    with torch.no_grad():
        y0 = qm(x)
        kept = [c._int8_weights.weights for c in _convs(qm)]
        y1 = qm(x)
    assert kept and all(k is not None for k in kept)
    assert all(c._int8_weights.weights is k
               for c, k in zip(_convs(qm), kept))
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)
    assert not any("_int8" in k for k in qm.state_dict())


def _load_state(qm, state):
    qm.load_state_dict(state, strict=False)


def _load_bridge(qm, state):
    variables = to_flax_variables(state)
    qm.load_state_dict(load_flax_params(variables), strict=False)


def _load_checkpoint(qm, state, tmp_path):
    variables = to_flax_variables(state)
    path = save_params_only(str(tmp_path / "int8_ckpt"),
                            variables["params"])
    params, _ = load_inference_weights(path)
    qm.load_state_dict(load_flax_params({"params": params}), strict=False)


@pytest.mark.parametrize("how", ["load_state_dict", "load_flax_params",
                                 "checkpoint"])
def test_new_weights_reach_the_next_forward(how, tmp_path):
    qm, _, x = _calibrated()
    with torch.no_grad():
        before = qm(x)
        state = _weights_of(5)
        if how == "load_state_dict":
            _load_state(qm, state)
        elif how == "load_flax_params":
            _load_bridge(qm, state)
        else:
            _load_checkpoint(qm, state, tmp_path)
        after = qm(x)
        want = _fresh(qm, state)(x)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, want, rtol=0, atol=0)


def test_in_place_and_replaced_kernels_are_seen():
    qm, _, x = _calibrated()
    conv = _convs(qm)[0]
    with torch.no_grad():
        qm(x)
        old = conv._int8_weights.weights
        conv.kernel.mul_(0.5)                      # in place: _version
        qm(x)
        assert conv._int8_weights.weights is not old
        torch.testing.assert_close(conv._int8_weights.weights.wq,
                                   quantize_weights_int8(conv.kernel)[0])
        conv.kernel = torch.nn.Parameter(conv.kernel.detach() * 3)   # new
        qm(x)
    torch.testing.assert_close(conv._int8_weights.weights.w_scale,
                               quantize_weights_int8(conv.kernel)[1])


def test_with_quant_mode_clone_sees_no_stale_entry():
    qm, m, x = _calibrated()
    with torch.no_grad():
        qm(x)
        clone = qm.with_quant_mode("int8")
        assert all(c._int8_weights.weights is None for c in _convs(clone))
        # the clone shares the kernels: weights loaded into one are the
        # other's, and both forwards follow
        _load_state(qm, _weights_of(7))
        a, b = qm(x), clone(x)
        want = _fresh(qm, _weights_of(7))(x)
    torch.testing.assert_close(a, want, rtol=0, atol=0)
    torch.testing.assert_close(b, want, rtol=0, atol=0)
    off = qm.with_quant_mode("off")
    assert all(c._int8_weights.weights is None for c in off.modules()
               if isinstance(c, FastConv3D))
