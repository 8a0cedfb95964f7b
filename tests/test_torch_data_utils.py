"""The port's ``data/data_utils.py`` against the JAX package's: every
function on the same inputs, the random ones under the same numpy seeds,
equal bit for bit (the port keeps JAX's numpy generators and its resample
is JAX's native one, tests/test_torch_host_native.py)."""

import numpy as np
import pytest

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.data import (
    data_utils as J, nifti as jnifti)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data import (
    data_utils as T)


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _vol(seed=0, shape=(12, 10, 8)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_load_nifti_volume(tmp_path):
    p = str(tmp_path / "v.nii.gz")
    jnifti.save(p, np.random.default_rng(1).integers(0, 50, (7, 6, 5))
                .astype(np.int16))
    _equal(T.load_nifti_volume(p), J.load_nifti_volume(p))


@pytest.mark.parametrize("target,normalize", [
    ((16, 16, 16), True), ((9, 7, 5), False), ((12, 10, 8), True)])
def test_preprocess_volume(target, normalize):
    v = _vol(2) * 40 + 7
    _equal(T.preprocess_volume(v, target, normalize),
           J.preprocess_volume(v, target, normalize))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("with_seg", [False, True])
def test_augment_volume_3d(seed, with_seg):
    v = _vol(3, (8, 10, 10))
    seg = (np.random.default_rng(4).integers(0, 4, v.shape).astype(np.uint8)
           if with_seg else None)
    got = T.augment_volume_3d(v, seg, rng=np.random.default_rng(seed),
                              noise_prob=0.5)
    want = J.augment_volume_3d(v, seg, rng=np.random.default_rng(seed),
                               noise_prob=0.5)
    _equal(got, want)


@pytest.mark.parametrize("axis,min_fg", [(0, 0), (2, 3)])
def test_create_2d_slices_from_3d(axis, min_fg):
    v = _vol(5)
    seg = np.zeros(v.shape, np.uint8)
    seg[3:6, 2:5, 1:4] = 1
    got = T.create_2d_slices_from_3d(v, seg, axis=axis, min_foreground=min_fg)
    want = J.create_2d_slices_from_3d(v, seg, axis=axis,
                                      min_foreground=min_fg)
    assert [g["index"] for g in got] == [w["index"] for w in want]
    for g, w in zip(got, want):
        _equal(g["image"], w["image"])
        _equal(g["segmentation"], w["segmentation"])
    assert len(T.create_2d_slices_from_3d(v)) == v.shape[0]


@pytest.mark.parametrize("with_mask", [False, True])
def test_elastic_transform_2d(with_mask):
    img = np.random.default_rng(6).random((20, 18, 3)).astype(np.float32)
    mask = (np.random.default_rng(7).random((20, 18)) > 0.5).astype(np.uint8)
    args = (img, mask if with_mask else None)
    _equal(T.elastic_transform_2d(*args, rng=np.random.default_rng(8)),
           J.elastic_transform_2d(*args, rng=np.random.default_rng(8)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("with_mask", [False, True])
def test_get_2d_augmentations(seed, with_mask):
    img = np.random.default_rng(9).random((16, 16)).astype(np.float32)
    mask = (img > 0.5).astype(np.uint8) if with_mask else None
    kw = dict(elastic_prob=0.6, rot_prob=0.7)
    got = T.get_2d_augmentations(**kw)(img, mask,
                                       rng=np.random.default_rng(seed))
    want = J.get_2d_augmentations(**kw)(img, mask,
                                        rng=np.random.default_rng(seed))
    _equal(got, want)


@pytest.mark.parametrize("segs", [
    [np.array([[0, 0, 1], [2, 3, 3]])],
    [np.zeros((3, 3), np.int64), np.full((2, 2), 2)],
    [np.zeros((4, 4), np.int64)],
])
def test_calculate_class_weights(segs):
    _equal(T.calculate_class_weights(segs), J.calculate_class_weights(segs))


def test_validate_data_integrity(tmp_path):
    a, b, c = (str(tmp_path / n) for n in ("a.npy", "b.npy", "c.npy"))
    np.save(a, np.zeros((4, 4, 4), np.float32))
    np.save(b, np.zeros((4, 4, 5), np.uint8))
    np.save(c, np.zeros((4, 4, 4), np.uint8))
    missing = str(tmp_path / "missing.npy")
    args = ([a, a, missing], [c, b, c])
    got = T.validate_data_integrity(*args)
    assert got == J.validate_data_integrity(*args)
    assert (len(got["valid"]), len(got["shape_mismatch"]),
            len(got["load_error"])) == (1, 1, 1)


@pytest.mark.parametrize("n,frac,seed", [(10, 0.2, 42), (7, 0.3, 1),
                                         (1, 0.5, 3)])
def test_create_train_val_split(n, frac, seed):
    items = [f"p{i}" for i in range(n)]
    assert (T.create_train_val_split(items, frac, seed)
            == J.create_train_val_split(items, frac, seed))


def test_get_dataset_statistics():
    vols = [_vol(10, (4, 5, 6)), _vol(11, (3, 3, 3)) * 2 + 1]
    assert T.get_dataset_statistics(vols) == J.get_dataset_statistics(vols)
    assert T.get_dataset_statistics([]) == J.get_dataset_statistics([])
