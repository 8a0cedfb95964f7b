"""The upload's front end of the port against the JAX package's, on the
CPU: the intensity statistics (``ops/stats.py``), the deterministic
preprocessing chain (``data/preprocess.py``), the NIfTI codec
(``data/nifti.py``), ``load_any_volume`` and the predictor's
``preprocess_image``.

Tolerances:
  * the percentile clip bounds (``percentile_bisect``) bit-exact, one
    volume above 2^24 values included, where the float32 cast of the
    count decides the answer; the sort form (``percentile``) bit-exact;
  * the z-score and what follows it within 1e-6 * max|x| of JAX's, plus
    JAX's own float32 error on that input. JAX's mean and std are
    float32 sums that XLA's CPU backend takes in order; on raw
    intensities they drift from the float64 value by up to ~4e-5 of
    max|z| (20 k voxels), where the port's stay within 1e-6. So each
    case first holds the port to 1e-6 * max|z| of a float64 z-score
    with the same (bit-exact) clip bounds, then to JAX's output within
    1e-6 * max|x| + JAX's measured error against that float64 value
    (the resize after it takes convex combinations, which do not grow
    an error);
  * labels, decoded voxels, affines and encoded bytes exactly equal.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.data import (
    dataset as jdataset, nifti as jnifti, preprocess as jpre)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference import (
    predictor as jpredictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops import stats as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data import (
    dataset as tdataset, nifti as tnifti, preprocess as tpre)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    predictor as tpredictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import stats as T

from _torch_threads import two_torch_threads  # noqa: F401


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _volume(shape, seed=0):
    """Skull-stripped-like intensities: exact zeros outside, a skewed
    positive tissue distribution inside."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(2.0, 150.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.4] = 0.0
    return x


def _jax_error(x, clip=(1.0, 99.0)) -> float:
    """JAX's float32 error of the intensity chain on ``x`` against a
    float64 z-score with the same clip bounds; asserts the port's is
    within 1e-6 * max|z|."""
    lo, hi = np.asarray(J.percentile_bisect(jnp.asarray(x), clip))
    c = np.clip(x, lo, hi).astype(np.float64)
    z64 = (c - c.mean()) / (c.std() + 1e-8)
    port = T.preprocess_intensity(torch.from_numpy(x), clip).numpy()
    assert np.abs(port - z64).max() <= 1e-6 * np.abs(z64).max(), (
        np.abs(port - z64).max(), np.abs(z64).max())
    return float(np.abs(np.asarray(J.preprocess_intensity(
        jnp.asarray(x), clip)) - z64).max())


def _close(got, ref, slack=0.0, rel=1e-6):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max() + slack, (
        np.abs(got - ref).max(), np.abs(ref).max(), slack)


# ----------------------------------------------------------------------
# ops/stats.py
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(17,), (8, 9, 10), (12, 10, 8, 4),
                                   (30, 31, 33)])
@pytest.mark.parametrize("qs", [(1.0, 99.0), (0.5, 50.0, 99.5),
                                (0.0, 100.0), (25.0, 75.0)])
def test_percentile_bisect_bit_exact(shape, qs):
    x = _volume(shape, seed=len(shape))
    ref = J.percentile_bisect(jnp.asarray(x), qs)
    got = T.percentile_bisect(torch.from_numpy(x), qs)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    if len(qs) == 2:
        ref = J.percentile_clip(jnp.asarray(x), *qs)
        got = T.percentile_clip(torch.from_numpy(x), *qs)
        np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_percentile_bisect_above_2_24_values():
    """260 x 260 x 250 = 16.9 M values. First a realistic volume at (1,
    99); then one built so that a count above 2^24 sits one above the
    target: JAX's float32 cast of the count rounds it onto the target
    and the bisection goes right, to ~1.0, where counts compared in
    int64 go left, to ~0.0. The port must follow JAX."""
    shape = (260, 260, 250)
    n = int(np.prod(shape))
    x = _volume(shape, seed=5)
    np.testing.assert_array_equal(
        _bits(T.percentile_bisect(torch.from_numpy(x), (1.0, 99.0))),
        _bits(J.percentile_bisect(jnp.asarray(x), (1.0, 99.0))))

    q = 99.5
    target = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    assert target > 2 ** 24 and int(target) % 4 == 0   # a tie rounds down
    below = int(target) + 1
    y = np.ones(n, np.float32)
    y[np.random.default_rng(6).permutation(n)[:below]] = 0.0
    y = y.reshape(shape)
    ref = J.percentile_bisect(jnp.asarray(y), (q,))
    got = T.percentile_bisect(torch.from_numpy(y), (q,))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert float(got[0]) > 0.99                      # went right
    # the same bisection with int64 counts goes the other way: the case
    # tells the two apart
    lo, hi = 0.0, 1.0
    for _ in range(26):
        mid = 0.5 * (lo + hi)
        count = below if mid > 0.0 else 0          # values below mid
        lo, hi = (mid, hi) if count <= int(target) else (lo, mid)
    assert 0.5 * (lo + hi) < 0.01


@pytest.mark.parametrize("axis", [None, 0, 1, 2])
def test_percentile_sort_form_bit_exact(axis):
    x = _volume((9, 11, 13), seed=2)
    for q in (1.0, 37.5, 99.0, [1.0, 50.0, 99.0]):
        ref = J.percentile(jnp.asarray(x), q, axis=axis)
        got = T.percentile(torch.from_numpy(x), q, axis=axis)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    ref = J.percentile_clip(jnp.asarray(x), 2.0, 98.0, exact=True)
    got = T.percentile_clip(torch.from_numpy(x), 2.0, 98.0, exact=True)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(6, 7, 8), (10, 12, 9, 4)])
def test_zscore_and_intensity_chain(shape):
    x = _volume(shape, seed=3)
    x64 = x.astype(np.float64)
    z64 = (x64 - x64.mean()) / (x64.std() + 1e-8)
    err = np.abs(np.asarray(J.zscore_normalize(jnp.asarray(x))) - z64).max()
    got = T.zscore_normalize(torch.from_numpy(x))
    assert np.abs(got.numpy() - z64).max() <= 1e-6 * np.abs(z64).max()
    _close(got, J.zscore_normalize(jnp.asarray(x)), slack=err)
    _close(T.preprocess_intensity(torch.from_numpy(x)),
           J.preprocess_intensity(jnp.asarray(x)), slack=_jax_error(x))
    # the population std, as jnp.std: torch's default would miss
    xf = torch.from_numpy(x)
    sample = (xf - xf.mean()) / (xf.std() + 1e-8)
    assert (sample - T.zscore_normalize(xf)).abs().max() > \
        1e-6 * float(T.zscore_normalize(xf).abs().max())


# ----------------------------------------------------------------------
# data/preprocess.py and the predictor's preprocess_image
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,out_size", [
    ((20, 22, 24), None), ((20, 22, 24), (16, 16, 16)),
    ((18, 20, 14, 4), None), ((18, 20, 14, 4), (12, 16, 12)),
    ((16, 16, 16), (16, 16, 16))])
def test_preprocess_image_matches_jax(shape, out_size):
    """(D, H, W) and (D, H, W, 4), native and resized. A 4-channel volume
    is normalised as one tensor across its channels, as JAX does."""
    x = _volume(shape, seed=4)
    err = _jax_error(x)
    ref = jpre.preprocess_image(jnp.asarray(x), out_size)
    got = tpre.preprocess_image(torch.from_numpy(x), out_size)
    _close(got, ref, slack=err)
    ref = jpredictor.preprocess_image(x, out_size)
    got = tpredictor.preprocess_image(x, out_size, device="cpu")
    assert isinstance(got, np.ndarray)
    _close(got, ref, slack=err)


def test_preprocess_multimodal_and_segmentation():
    x = _volume((14, 12, 10, 3), seed=8)
    err = max(_jax_error(x[..., m]) for m in range(3))
    _close(tpre.preprocess_multimodal(torch.from_numpy(x), (8, 8, 8)),
           jpre.preprocess_multimodal(jnp.asarray(x), (8, 8, 8)),
           slack=err)
    seg = np.random.default_rng(9).choice(
        np.array([0, 1, 2, 4], np.uint8), size=(14, 12, 10))
    for size in (None, (8, 16, 6)):
        ref = np.asarray(jpre.preprocess_segmentation(jnp.asarray(seg), size))
        got = tpre.preprocess_segmentation(torch.from_numpy(seg), size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 4 not in got.numpy()


def test_preprocess_image_from_a_file(tmp_path):
    x = _volume((12, 14, 10, 4), seed=10)
    p = str(tmp_path / "scan.nii.gz")
    tnifti.save(p, x)
    _close(tpredictor.preprocess_image(p, None, device="cpu"),
           jpredictor.preprocess_image(p, None), slack=_jax_error(x))


def test_preprocess_image_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        tpredictor.preprocess_image(np.zeros((4, 4, 4), np.float32), None)


# ----------------------------------------------------------------------
# data/nifti.py and load_any_volume
# ----------------------------------------------------------------------

def _affine():
    aff = np.array([[0.9, 0.1, 0.0, -90.0],
                    [0.0, 1.1, 0.05, 12.5],
                    [0.02, 0.0, 2.0, 7.0],
                    [0.0, 0.0, 0.0, 1.0]])
    return aff


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_nifti_bytes_and_decode_match_jax(tmp_path, dtype, ext):
    rng = np.random.default_rng(12)
    data = (rng.normal(50, 20, (7, 9, 5, 2)) if dtype is np.float32 else
            rng.integers(0, 200, (7, 9, 5))).astype(dtype)
    aff = _affine()
    raw = tnifti.encode(data, affine=aff)
    assert raw == jnifti.encode(data, affine=aff)
    p = tmp_path / f"v{ext}"
    p.write_bytes(gzip.compress(raw) if ext.endswith(".gz") else raw)
    got, ref = tnifti.load(str(p)), jnifti.load(str(p))
    assert got.data.dtype == ref.data.dtype and got.pixdim == ref.pixdim
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.data, data)          # round trip
    np.testing.assert_array_equal(got.affine, ref.affine)
    np.testing.assert_allclose(got.affine, aff, atol=1e-5)  # float32 srow
    vol = tnifti.load_volume(str(p))
    assert vol.dtype == np.float32
    np.testing.assert_array_equal(vol, jnifti.load_volume(str(p)))
    np.testing.assert_array_equal(tnifti.load_affine(str(p)),
                                  jnifti.load_affine(str(p)))
    a = tnifti.load_affine(str(p))
    assert tnifti.affine_spacing(a) == jnifti.affine_spacing(a)
    assert tnifti.affine_voxel_volume(a) == jnifti.affine_voxel_volume(a)
    np.testing.assert_array_equal(tdataset.load_any_volume(str(p)),
                                  jdataset.load_any_volume(str(p)))


def test_nifti_qform_scaling_and_refusals_match_jax(tmp_path):
    """The qform path (sform_code 0, a quaternion, qfac -1), scl_slope /
    scl_inter scaling, and the header checks."""
    import struct
    data = np.arange(60, dtype=np.int16).reshape(3, 4, 5)
    hdr = bytearray(tnifti.encode(data))
    struct.pack_into("<h", hdr, 254, 0)                    # sform off
    struct.pack_into("<h", hdr, 252, 1)                    # qform on
    struct.pack_into("<3f", hdr, 256, 0.1, -0.2, 0.3)      # b, c, d
    struct.pack_into("<3f", hdr, 268, 5.0, -6.0, 7.5)      # offsets
    struct.pack_into("<f", hdr, 76, -1.0)                  # qfac
    struct.pack_into("<2f", hdr, 112, 2.5, -1.0)           # slope, inter
    p = tmp_path / "q.nii"
    p.write_bytes(bytes(hdr))
    got, ref = tnifti.load(str(p)), jnifti.load(str(p))
    assert got.data.dtype == ref.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.affine, ref.affine)
    assert tnifti.affine_spacing(got.affine) == \
        jnifti.affine_spacing(ref.affine)
    assert tnifti.affine_spacing(None) is None
    assert tnifti.affine_voxel_volume(np.zeros((4, 4))) is None
    for bad in (b"\x00" * 100, bytes(hdr[:344]) + b"xxxx" + bytes(hdr[348:])):
        q = tmp_path / "bad.nii"
        q.write_bytes(bad)
        for codec in (tnifti, jnifti):
            with pytest.raises(ValueError):
                codec.load(str(q))


def test_load_any_volume_npy_and_nii_gz(tmp_path):
    x = _volume((6, 5, 4, 2), seed=13)
    p = str(tmp_path / "v.npy")
    np.save(p, x.astype(np.float64))
    got = tdataset.load_any_volume(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jdataset.load_any_volume(p))
    q = str(tmp_path / "v.nii.gz")
    jnifti.save(q, x)
    got = tdataset.load_any_volume(q)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, jdataset.load_any_volume(q))
