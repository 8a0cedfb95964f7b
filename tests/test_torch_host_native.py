"""The port's native host library (``…_torch/data/native.py`` and its own
copy of ``csrc/host_preprocess.cpp``) against the JAX package's
``data/native.py``, and the routes that take it (``dataset._zoom_to``,
``load_any_volume``).

* ``_zoom_to`` is the half-pixel trilinear resample of
  ``jax.image.resize`` in both packages, bit for bit (the port used
  ``scipy.ndimage.zoom`` before, which maps the grid differently: max
  |d| 0.675 and 0.493 on the two inputs below);
* ``read_nifti`` bit-equal to JAX's native reader and to the NumPy codec;
  a corrupt header gives None;
* ``zoom`` orders 0 and 1 bit-equal to JAX's; the plain torch resample
  (the route without g++) within 1e-5 of it;
* ``clip_zscore`` within 1e-6 of JAX's (same C code; OpenMP may order the
  reduction differently run to run);
* the library lies under the port's ``build/``, and editing the ``.cpp``
  leaves the CUDA build's name as it was.
"""

import shutil
import struct
import time

import numpy as np
import pytest

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.data import (
    dataset as jdataset, native as jnative)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data import (
    dataset, native, nifti)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import (
    native as cuda_native)

PORT_ROOT = native.PACKAGE_DIR.parent


@pytest.fixture(scope="module")
def libs():
    assert native.available(), "the port's host library did not build"
    # the JAX package writes its library in place: another test worker
    # may be half-way through that build, so a failed load is retried
    deadline = time.monotonic() + 180
    while not jnative.available() and time.monotonic() < deadline:
        time.sleep(2)
        jnative._tried = False
    assert jnative.available(), "the JAX package's host library did not build"


@pytest.mark.parametrize("src,size,dist", [
    ((7, 9, 5), (14, 13, 8), "normal"),
    ((240, 240, 155), (128, 128, 128), "uniform"),
])
def test_zoom_to_equals_jax(libs, src, size, dist):
    rng = np.random.default_rng(0)
    vol = (rng.standard_normal(src) if dist == "normal"
           else rng.random(src)).astype(np.float32)
    want = jdataset._zoom_to(vol, size)
    got = dataset._zoom_to(vol, size)
    assert got.shape == tuple(size) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ext", ["nii", "nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_read_nifti_equals_jax_and_codec(tmp_path, libs, ext, dtype):
    rng = np.random.default_rng(1)
    if np.issubdtype(dtype, np.floating):
        data = rng.normal(size=(9, 7, 5)).astype(dtype)
    else:
        data = rng.integers(0, 90, size=(9, 7, 5)).astype(dtype)
    p = str(tmp_path / f"v.{ext}")
    nifti.save(p, data)
    if dtype != np.float32:         # scl_slope / scl_inter applied
        raw = bytearray(nifti._open(p, "rb").read())
        struct.pack_into("<ff", raw, 112, 3.0, -1.0)
        with nifti._open(p, "wb") as f:
            f.write(bytes(raw))
    got = native.read_nifti(p)
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.read_nifti(p))
    np.testing.assert_array_equal(got, nifti.load_volume(p))
    np.testing.assert_array_equal(dataset.load_any_volume(p), got)
    np.testing.assert_array_equal(dataset.load_any_volume(p),
                                  jdataset.load_any_volume(p))


def test_corrupt_headers_give_none(tmp_path, libs):
    vol = np.random.default_rng(2).normal(size=(6, 6, 6))
    good = tmp_path / "good.nii"
    nifti.save(str(good), vol)                  # float64: datatype 64
    raw = bytes(good.read_bytes())

    def variant(name, edit):
        b = bytearray(raw)
        edit(b)
        p = tmp_path / name
        p.write_bytes(bytes(b))
        return str(p)
    cases = [
        # bitpix lies small while the data section is short
        variant("lying.nii", lambda b: (struct.pack_into("<h", b, 72, 8),
                                        b.__delitem__(slice(352 + 216,
                                                            None)))),
        variant("neg.nii", lambda b: struct.pack_into("<h", b, 42, -6)),
        variant("ndim.nii", lambda b: struct.pack_into("<h", b, 40, 30000)),
        # big-endian: the library reads little-endian files only
        variant("big.nii", lambda b: struct.pack_into(">i", b, 0, 348)),
        # dims over the 1<<30 voxel cap
        variant("huge.nii", lambda b: struct.pack_into("<3h", b, 42,
                                                       32000, 32000, 32000)),
    ]
    junk = tmp_path / "junk.nii"
    junk.write_bytes(b"definitely not a nifti file")
    for p in cases + [str(junk)]:
        assert native.read_nifti(p) is None, p
        assert jnative.read_nifti(p) is None, p
    assert native.read_nifti(str(good)).shape == (6, 6, 6)


@pytest.mark.parametrize("order", [0, 1])
def test_zoom_equals_jax_and_plain(libs, order):
    rng = np.random.default_rng(3)
    for src, size in [((6, 7, 9), (12, 5, 20)), ((17, 11, 8), (9, 23, 8)),
                      ((40, 36, 30), (32, 48, 31))]:
        vol = (rng.integers(0, 5, src) if order == 0
               else rng.normal(size=src)).astype(np.float32)
        got = native.zoom(vol, size, order=order)
        np.testing.assert_array_equal(got, jnative.zoom(vol, size,
                                                        order=order))
        plain = native.zoom_plain(vol, size, order=order)
        np.testing.assert_allclose(plain, got, rtol=0, atol=1e-5)
    assert native.zoom(vol, size, order=3) is None
    assert native.zoom(vol[0], size[1:], order=1) is None


def test_zoom_without_the_library_is_plain(monkeypatch):
    """No g++: the port's zoom is the plain resample, never scipy's."""
    vol = np.random.default_rng(4).normal(size=(7, 9, 5)).astype(np.float32)
    want = native.zoom_plain(vol, (14, 13, 8))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(dataset._zoom_to(vol, (14, 13, 8)), want)
    assert native.read_nifti("any.nii") is None
    assert native.clip_zscore(vol) is None


def test_clip_zscore_equals_jax(libs):
    x = (np.random.default_rng(5).normal(size=(20, 20, 20)) * 30 + 5
         ).astype(np.float32)
    got = native.clip_zscore(x, 1.0, 99.0)
    np.testing.assert_allclose(got, jnative.clip_zscore(x, 1.0, 99.0),
                               rtol=0, atol=1e-6)
    c = np.clip(x, np.percentile(x, 1), np.percentile(x, 99))
    np.testing.assert_allclose(got, (c - c.mean()) / (c.std() + 1e-8),
                               atol=1e-3, rtol=1e-3)
    assert native.host_threads() >= 1


def test_library_lives_in_the_ports_build(libs):
    path = native.library_path()
    assert path.exists()
    assert path.parent == PORT_ROOT / "build" / "host_preprocess"
    assert native.SOURCE.parent == native.PACKAGE_DIR / "csrc"
    assert str(path) != jnative._LIB_PATH


def test_cpp_edit_leaves_the_cuda_build_name(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_native.CSRC_DIR, csrc)
    cpp = csrc / "host_preprocess.cpp"
    assert cpp.exists()
    before = cuda_native.source_digest(csrc)
    assert before == cuda_native.source_digest()
    cpp.write_text(cpp.read_text() + "\n// edited\n")
    assert cuda_native.source_digest(csrc) == before
