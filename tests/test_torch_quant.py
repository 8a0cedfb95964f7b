"""int8 serving of the port against the JAX package's, on the CPU: the int8
conv (``ops/conv.py::conv3d_zcat_int8``, its plain version here),
``calibrate_int8`` / ``quant_scales_from_stats`` and
``UNet3D(quant_mode=...)``, with the same inputs (numpy, from a seed) and
the same weights (moved by the weight bridge).

Bounds:

  * the conv: bf16 outputs bit-equal to JAX's. The int8 products summed
    in int32 are exact, and every f32 step (the quantization's division
    and rounding, the scale product, the bias) is the same IEEE operation
    in both; ``quantize_weights_int8`` equal to JAX's ``wq`` and
    ``w_scale`` element for element;
  * the calibrated scales: within 1e-5 relative of JAX's in f32 compute
    (the f32 convs before each conv sum in another order); in bf16 each
    maximum (a bf16 activation, one of those that drift by a few bf16 ulp
    between the packages) within 2 bf16 ulp of JAX's: measured 0.55-1.16
    x 2^-7 relative over 30 leaves of three seeds, 2 ulp at one of them
    (3.40625 against 3.4375 at bottleneck.conv2);
  * the int8 model (features (8, 16), f32 compute, input (1, 16, 16, 16,
    4)): its logits within a quarter of JAX's own int8-against-normal
    drift of JAX's int8 logits (measured: 0.045 against JAX's 0.522, a
    ratio of 0.085), and no label flipped where JAX's int8 top-2 margin
    exceeds twice that drift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference.quantize import (
    calibrate_int8 as j_calibrate_int8)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.models import (
    UNet3D as JUNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops.conv import (
    conv3d_zcat_int8 as j_conv3d_zcat_int8)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    calibrate_int8, quant_scales_from_stats)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, load_flax_params, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import unet3d as T_unet
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv import (
    conv3d_zcat_int8, quantize_weights_int8)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.conv_int8 import (
    conv3d_int8, conv3d_int8_plain)

FEATS = (8, 16)


def _conv_inputs(ci, co, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 6, 7, 9, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32) if bias else None
    s = np.float32(np.abs(x).max() * 0.9 / 127)    # clips the top 10%
    return x, w, b, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("ci,co", [(4, 32), (32, 32), (64, 32), (96, 64),
                                   (64, 128)])
def test_int8_conv_bit_equal_to_jax(ci, co, bias, dtype):
    x, w, b, s = _conv_inputs(ci, co, bias, seed=ci + co)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bfloat16"
                else (torch.float32, jnp.float32))
    want = j_conv3d_zcat_int8(jnp.asarray(x, jdt), jnp.asarray(w),
                              jnp.float32(s),
                              None if b is None else jnp.asarray(b))
    got = conv3d_zcat_int8(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                           torch.tensor(s),
                           None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 6, 7, 9, co)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_int8_conv_exact_on_grid():
    """Inputs and weights on the int8 grid (tests/test_quant.py:25-41):
    the port equals JAX bit for bit, and both the f32 conv within JAX's
    tolerance there; a Python float scale gives the same bits."""
    rng = np.random.default_rng(3)
    x = rng.integers(-100, 100, size=(1, 5, 6, 7, 8)).astype(np.float32) * 0.25
    wint = rng.integers(-127, 128, size=(3, 3, 3, 8, 4)).astype(np.float32)
    wint[0, 0, 0, 0, :] = 127.0          # pin the per-channel max
    w = wint / 127.0 * 0.5
    want = np.asarray(j_conv3d_zcat_int8(jnp.asarray(x), jnp.asarray(w),
                                         jnp.float32(0.25)), np.float32)
    got = conv3d_zcat_int8(torch.from_numpy(x), torch.from_numpy(w),
                           torch.tensor(0.25, dtype=torch.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(conv3d_zcat_int8(
        torch.from_numpy(x), torch.from_numpy(w), 0.25).float().numpy(), want)
    f32 = torch.nn.functional.conv3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3),
        torch.from_numpy(w).permute(4, 3, 0, 1, 2), padding=1
    ).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(want, f32, rtol=2e-2, atol=2e-2)


def test_quantize_weights_equal_to_jax():
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(3, 3, 3, 24, 40)) * 0.07).astype(np.float32)
    w[..., 5] = 0.0                      # an all-zero channel: 1e-12 / 127
    # JAX conv3d_zcat_int8's weight quantization (ops/conv.py:225-228)
    jw = jnp.asarray(w)
    j_scale = jnp.maximum(jnp.max(jnp.abs(jw), axis=(0, 1, 2, 3)),
                          1e-12) / 127.0
    j_wq = jnp.clip(jnp.round(jw / j_scale), -127, 127).astype(jnp.int8)
    wq, w_scale = quantize_weights_int8(torch.from_numpy(w))
    assert wq.dtype == torch.int8 and w_scale.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(j_wq))
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(j_scale))
    assert int(wq.abs().max()) == 127


def test_int8_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; the plain version refuses a kernel that is not 3x3x3."""
    x, w, b, s = _conv_inputs(16, 24, True, seed=9)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    before = conv3d_int8.launches
    got = conv3d_int8(xt, wt, torch.tensor(s), bt)
    assert conv3d_int8.launches == before
    assert torch.equal(got, conv3d_int8_plain(xt, wt, torch.tensor(s), bt))
    with pytest.raises(ValueError):
        conv3d_zcat_int8(xt, wt[:1], torch.tensor(s))


# ---------------------------------------------------------------------
# calibration and the int8 model
# ---------------------------------------------------------------------


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = float(np.asarray(v))
    return out


@pytest.fixture(scope="module")
def f32_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32)
    model = UNet3D(features=FEATS, seed=1, device="cpu",
                   compute_dtype="float32")
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.float32)
    jq = j_calibrate_int8(jm, variables, [x[0]])
    return model, variables, x, jm, jq


def test_calibration_matches_jax_f32(f32_case):
    model, variables, x, _, jq = f32_case
    q = calibrate_int8(model, variables, [x[0]])
    assert set(q) == {"params", "batch_stats", "quant"}
    got, want = _leaves(q["quant"]), _leaves(jq["quant"])
    # 2 encoder + bottleneck + 2 decoder blocks x 2 convs
    assert set(got) == set(want) and len(got) == 10
    assert not any(k.startswith(("head", "att")) for k in got)
    assert all(k.endswith("/act_scale") for k in got)
    for k, v in want.items():
        assert v > 0 and abs(got[k] - v) <= 1e-5 * v, (k, got[k], v)


def test_calibration_matches_jax_bf16():
    rng = np.random.default_rng(1)
    vols = [rng.normal(size=(16, 16, 16, 4)).astype(np.float32)
            for _ in range(2)]
    model = UNet3D(features=FEATS, seed=2, device="cpu")
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.bfloat16)
    want = _leaves(j_calibrate_int8(jm, variables, vols)["quant"])
    # the model's own weights (variables None), batched volumes
    got = _leaves(calibrate_int8(model, None, [v[None] for v in vols])[
        "quant"])
    assert set(got) == set(want) and len(got) == 10
    for k, v in want.items():
        m = v * 127                      # the maximum, a bf16 value
        ulp = 2.0 ** (np.floor(np.log2(m)) - 7)
        assert abs(got[k] * 127 - m) <= 2 * ulp, (k, got[k], v)


def test_quant_scales_from_stats_rename_and_margin():
    stats = {"down0": {"conv1": {"absmax": np.float32(12.7)}},
             "dec1": {"conv2": {"absmax": np.float32(0.0)}}}
    q = quant_scales_from_stats(stats)
    np.testing.assert_allclose(float(q["down0"]["conv1"]["act_scale"]), 0.1,
                               rtol=1e-6)
    # the 1e-6 floor of JAX's jnp.maximum
    np.testing.assert_allclose(float(q["dec1"]["conv2"]["act_scale"]),
                               1e-6 / 127, rtol=1e-6)
    q2 = quant_scales_from_stats(stats, margin=1.5)
    np.testing.assert_allclose(float(q2["down0"]["conv1"]["act_scale"]), 0.15,
                               rtol=1e-6)
    assert "absmax" not in str(q)


def test_calibration_needs_a_volume(f32_case):
    model, variables, *_ = f32_case
    with pytest.raises(ValueError):
        calibrate_int8(model, variables, [])
    with pytest.raises(ValueError):
        calibrate_int8(model, variables, iter(()))


def test_calibration_margin_widens_the_scales(f32_case):
    model, variables, x, *_ = f32_case
    a = _leaves(calibrate_int8(model, variables, [x[0]])["quant"])
    b = _leaves(calibrate_int8(model, variables, [x[0]], margin=2.0)["quant"])
    for k in a:
        np.testing.assert_allclose(b[k], 2 * a[k], rtol=1e-6)


def test_quant_blocks_quantizes_only_those_blocks():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32)
    model = UNet3D(features=FEATS, seed=1, device="cpu",
                   compute_dtype="float32", quant_blocks=("dec",))
    variables = to_flax_variables(model.state_dict())
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.float32,
                 quant_blocks=("dec",))
    want = _leaves(j_calibrate_int8(jm, variables, [x[0]])["quant"])
    q = calibrate_int8(model, variables, [x[0]])
    got = _leaves(q["quant"])
    assert set(got) == set(want) and len(got) == 4
    assert all(k.startswith("dec") for k in got)
    qm = model.with_quant_mode("int8")
    assert {k for k in qm.state_dict() if k.endswith("act_scale")} == {
        k.replace("/act_scale", ".act_scale").replace("/", ".")
        for k in got}
    qm.load_state_dict(load_flax_params(q))
    assert torch.isfinite(qm(torch.from_numpy(x))).all()


def _count_region_kernels(monkeypatch):
    """Count the calls of the region's kernel wrappers (K1-K4) in the
    model module; on the CPU they run their plain versions and count no
    launch of their own."""
    calls = []
    for name in ("conv3d_halo", "up_k2s2_into_halo", "pack_halo",
                 "pool_into_halo"):
        real = getattr(T_unet, name)
        monkeypatch.setattr(
            T_unet, name,
            lambda *a, _real=real, _n=name, **k: calls.append(_n)
            or _real(*a, **k))
    return calls


def test_calibration_with_the_region_on_launches_no_region_kernel(
        monkeypatch):
    """With ps2d_eval (levels 2) the calib forward runs the normal path, as
    JAX's (models/unet3d.py:576-580): no K1-K4 call, every scale."""
    calls = _count_region_kernels(monkeypatch)
    model = UNet3D(features=(32, 64), ps2d_eval=True, ps2d_levels=2, seed=5,
                   device="cpu")
    x = np.random.default_rng(5).normal(size=(1, 8, 16, 16, 4)).astype(
        np.float32)
    assert model.halo_levels(x.shape[1:4]) == 2
    model(torch.from_numpy(x))
    assert calls                      # the region runs without quant_mode
    calls.clear()
    q = calibrate_int8(model, None, [x])
    assert not calls
    assert len(_leaves(q["quant"])) == 10
    qm = model.with_quant_mode("int8")
    assert qm.halo_levels(x.shape[1:4]) == 0
    assert model.halo_levels(x.shape[1:4]) == 2     # the model is unchanged
    qm.load_state_dict(load_flax_params(q))
    assert torch.isfinite(qm(torch.from_numpy(x))).all()
    assert not calls


def test_calibration_with_s2d_eval_matches_jax():
    """tests/test_quant.py:128-149 for the port: s2d_eval on, every block
    gets its scale, the same as JAX's, and the int8 model applies."""
    model = UNet3D(features=FEATS, seed=4, device="cpu",
                   compute_dtype="float32", s2d_eval=True)
    variables = to_flax_variables(model.state_dict())
    rng = np.random.default_rng(0)
    vols = [rng.normal(size=(16, 16, 16, 4)).astype(np.float32)]
    jm = JUNet3D(out_channels=4, features=FEATS, dtype=jnp.float32,
                 remat=False, s2d_eval=True)
    want = _leaves(j_calibrate_int8(jm, variables, vols)["quant"])
    q = calibrate_int8(model, variables, vols)
    got = _leaves(q["quant"])
    assert set(got) == set(want) and len(got) == 10
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * v, (k, got[k], v)
    qm = model.with_quant_mode("int8")
    qm.load_state_dict(load_flax_params(q))
    out = qm(torch.zeros((1, 16, 16, 16, 4)))
    assert out.shape == (1, 16, 16, 16, 4) and torch.isfinite(out).all()


def test_int8_model_matches_jax_int8_model(f32_case):
    model, variables, x, jm, jq = f32_case
    qm = model.with_quant_mode("int8")
    qm.load_state_dict(load_flax_params(jq))
    out = qm(torch.from_numpy(x)).numpy()
    jqm = jm.clone(quant_mode="int8")
    ref = np.asarray(jax.jit(lambda v, a: jqm.apply(v, a, train=False)[
        "logits"])(jq, jnp.asarray(x)))
    normal = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False)[
        "logits"])(variables, jnp.asarray(x)))
    jax_drift = np.abs(ref - normal).max()
    drift = np.abs(out - ref).max()
    assert out.shape == ref.shape == (1, 16, 16, 16, 4)
    assert jax_drift > 0.05, jax_drift            # int8 changes the logits
    assert drift <= 0.25 * jax_drift, (drift, jax_drift)
    top2 = np.sort(ref, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    flips = out.argmax(-1) != ref.argmax(-1)
    assert not (flips & (margin > 2 * drift)).any(), (margin[flips].max(),
                                                      drift)


def test_quant_mode_off_is_unchanged(f32_case):
    model, variables, x, *_ = f32_case
    off = UNet3D(features=FEATS, seed=1, device="cpu",
                 compute_dtype="float32", quant_mode="off")
    assert off.quant_mode == model.quant_mode == "off"
    assert set(off.state_dict()) == set(model.state_dict())
    assert not any(k.endswith("act_scale") for k in off.state_dict())
    xt = torch.from_numpy(x)
    assert torch.equal(off(xt), model(xt))
    assert torch.equal(model.with_quant_mode("off")(xt), model(xt))


def test_with_quant_mode_shares_the_weights(f32_case):
    model, *_ = f32_case
    qm = model.with_quant_mode("int8")
    assert qm is not model and qm.quant_mode == "int8"
    assert model.quant_mode == "off"
    for (n, p), (m, r) in zip(model.named_parameters(),
                              qm.named_parameters()):
        assert n == m and p is r
    assert model.down0.conv1.quant_mode == "off"
    assert qm.down0.conv1.quant_mode == "int8"
    assert qm.head_conv.quant_mode == "off"
    assert not hasattr(model.down0.conv1, "act_scale")
    with pytest.raises(ValueError):
        qm.forward_train(torch.zeros((1, 16, 16, 16, 4)))
    with pytest.raises(ValueError):
        UNet3D(features=FEATS, device="cpu", quant_mode="int4")


def test_weight_bridge_carries_the_quant_collection(f32_case):
    _, _, _, _, jq = f32_case
    model = UNet3D(features=FEATS, device="cpu", compute_dtype="float32",
                   quant_mode="int8")
    state = load_flax_params(jq)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    assert float(model.down0.conv1.act_scale) == float(
        jq["quant"]["down0"]["conv1"]["act_scale"])
    back = to_flax_variables(model.state_dict())
    assert set(back) == {"params", "batch_stats", "quant"}
    assert _leaves(back["quant"]) == _leaves(jax.tree_util.tree_map(
        np.asarray, jq["quant"]))
    off = to_flax_variables(UNet3D(features=FEATS, device="cpu").state_dict())
    assert set(off) == {"params", "batch_stats"}
