"""The port's cohort datasets, augmentation and loader against the JAX
package's, on the CPU at small shapes.

  * ``BraTS2024Dataset``'s sample lists (split and flat layouts) and its
    items: equal to JAX's.
  * ``BrainTumorDataset``: equal to JAX's with JAX's native zoom switched
    off inside the test (both take the SciPy branch).
  * The loader's shuffle order and ``_sample_patch`` on one normalised
    cache: bit-exact (the same numpy generators and arithmetic); its
    normalisation within float32 rounding of JAX's (the intensity chain's
    own tolerance, tests/test_torch_preprocess.py), the labels and the
    foreground table exact.
  * ``apply_augment`` given JAX's draws: equal to JAX's ``augment_pair``
    transform by transform (noise and gamma within 1e-5 of f32 rounding);
    ``torch.rot90`` and ``jnp.rot90`` turn the same way; the port's own
    draws by distribution, and rectangular planes keep their shape.
  * An abandoned epoch leaves no producer thread alive, and a decode
    error reaches the consumer.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    AugmentConfig as JAugmentConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.data import (
    dataset as jdataset, native as jnative, pipeline as jpipeline,
    preprocess as jpre)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.config import (
    AugmentConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data import (
    dataset as tdataset, pipeline as tpipeline, preprocess as tpre)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data.synthetic import (
    create_enhanced_synthetic_data)


@pytest.fixture
def no_native(monkeypatch):
    """JAX's readers take their NumPy / SciPy branches (the JAX package's
    native library is never built or loaded by these tests)."""
    monkeypatch.setattr(jnative, "read_nifti", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "zoom", lambda *a, **k: None)


def _cohort(root, n=5, shape=(20, 24, 16), fmt="npy", seed=3):
    return create_enhanced_synthetic_data(n, str(root), shape=shape,
                                          fmt=fmt, seed=seed,
                                          skull_stripped=True,
                                          size_range=(3, 6))


@pytest.mark.parametrize("layout", ["split", "flat"])
def test_brats_dataset_matches_jax(tmp_path, no_native, layout):
    root = _cohort(tmp_path / "c", n=6)
    if layout == "flat":
        # every patient straight under the root: the 80/20 index split
        flat = tmp_path / "flat"
        flat.mkdir()
        for split in ("train", "val"):
            for p in sorted((tmp_path / "c" / split).iterdir()):
                p.rename(flat / p.name)
        root = str(flat)
    for mode in ("train", "val", "test"):
        j = jdataset.BraTS2024Dataset(root, mode=mode)
        t = tdataset.BraTS2024Dataset(root, mode=mode)
        assert t.samples == j.samples, mode
    j = jdataset.BraTS2024Dataset(root, mode="train")
    t = tdataset.BraTS2024Dataset(root, mode="train")
    assert len(t) >= 3
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert a["patient_id"] == b["patient_id"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert a["mask"].dtype == np.uint8
    assert any((t[i]["mask"] == 4).any() for i in range(len(t)))
    assert t[0] is t[0]            # the LRU serves hits


def test_brats_dataset_nifti_and_missing_split(tmp_path, no_native):
    root = _cohort(tmp_path, n=2, fmt="nii.gz")
    j = jdataset.BraTS2024Dataset(root, mode="train")
    t = tdataset.BraTS2024Dataset(root, mode="train")
    np.testing.assert_array_equal(t[0]["image"], j[0]["image"])
    # a split layout without this split is empty, as in JAX
    assert tdataset.BraTS2024Dataset(root, mode="test").samples == []


def test_brain_tumor_dataset_matches_jax(tmp_path, no_native):
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate([(10, 14, 9), (16, 16, 16)]):
        p = tmp_path / f"vol{i}.npy"
        np.save(p, rng.normal(3.0, 2.0, shape).astype(np.float32))
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.npy"))
    j = jdataset.BrainTumorDataset(paths, target_size=(12, 12, 12))
    t = tdataset.BrainTumorDataset(paths, target_size=(12, 12, 12))
    for i in range(len(paths)):
        a, b = t[i], j[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        assert a["path"] == b["path"] and a["image"].shape == (12, 12, 12)


class _Arrays:
    """A dataset of fixed samples (the loaders' only interface)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        if isinstance(self.items[i], Exception):
            raise self.items[i]
        return self.items[i]


def _samples(n=5, shape=(20, 24, 18)):
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        img = np.zeros((*shape, 4), np.float32)
        img[2:-3, 3:-2, 1:-4] = rng.normal(100.0, 20.0, (
            shape[0] - 5, shape[1] - 5, shape[2] - 5, 4))
        mask = np.zeros(shape, np.uint8)
        if i % 4:
            mask[6:12, 8:13, 5:9] = 2
            mask[8:10, 9:11, 6:8] = 4
        out.append({"image": img, "mask": mask})
    return out


def test_shuffle_and_patches_bit_exact_to_jax():
    ds = _Arrays(_samples())
    kw = dict(batch_size=2, shuffle=True, seed=7, drop_last=True,
              patch_size=(8, 8, 8), fg_patch_prob=0.6)
    j = jpipeline.DeviceDataLoader(ds, **kw)
    t = tpipeline.DeviceDataLoader(ds, device="cpu", **kw)
    for epoch in range(1, 5):
        j._epoch = t._epoch = epoch
        for a, b in zip(t._batch_indices(), j._batch_indices()):
            np.testing.assert_array_equal(a, b)
    # the normalised cache: labels, box and foreground table exact, the
    # intensities within float32 rounding of the chain
    for idx in range(len(ds)):
        ti, tm, tfg = t._get_normalized(idx)
        ji, jm, jfg = j._get_normalized(idx)
        assert ti.shape == ji.shape and ti.dtype == np.float32
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tfg, jfg)
        assert np.abs(ti - ji).max() <= 1e-4 * np.abs(ji).max()
        # the same cache entry in both: the same patch, bit for bit
        t._norm_cache[idx] = j._norm_cache[idx]
    for epoch in range(1, 4):
        j._epoch = t._epoch = epoch
        for idx in range(len(ds)):
            for a, b in zip(t._sample_patch(idx), j._sample_patch(idx)):
                assert a.shape[:3] == (8, 8, 8)
                np.testing.assert_array_equal(a, b)


def test_loader_batches_match_jax_unaugmented():
    ds = _Arrays(_samples(4))
    for mode in ({"image_size": (8, 8, 8)}, {"patch_size": (8, 8, 8)}):
        kw = dict(batch_size=2, shuffle=True, seed=3, num_workers=2, **mode)
        jb = list(jpipeline.DeviceDataLoader(ds, **kw))
        tb = list(tpipeline.DeviceDataLoader(ds, device="cpu", **kw))
        assert len(tb) == len(jb) == 2
        for a, b in zip(tb, jb):
            assert a["image"].dtype == torch.float32
            assert a["mask"].dtype == torch.int32
            np.testing.assert_array_equal(a["mask"].numpy(),
                                          np.asarray(b["mask"]))
            ref = np.asarray(b["image"])
            assert np.abs(a["image"].numpy() - ref).max() <= (
                1e-4 * np.abs(ref).max())


def test_normalize_batch_matches_jax():
    rng = np.random.default_rng(4)
    imgs = rng.normal(50.0, 10.0, (2, 12, 10, 14, 3)).astype(np.float32)
    segs = rng.choice([0, 1, 2, 4], (2, 12, 10, 14)).astype(np.int32)
    for size in ((8, 8, 8), None):
        ref = jpre.normalize_batch(jnp.asarray(imgs), jnp.asarray(segs),
                                   out_size=size)
        got = tpre.normalize_batch(torch.from_numpy(imgs),
                                   torch.from_numpy(segs), out_size=size)
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(ref["mask"]))
        r = np.asarray(ref["image"])
        assert np.abs(got["image"].numpy() - r).max() <= 1e-4 * np.abs(
            r).max()


def _jax_draws(key, shape, cfg):
    """``augment_pair``'s draws from ``key``, as it makes them."""
    (k_rot, k_rotk, k_flip, k_noise_p, k_noise_s, k_noise, k_int_p,
     k_int, k_gam_p, k_gam) = jax.random.split(key, 10)
    square = shape[1] == shape[2]
    f = lambda a: float(np.asarray(a))     # noqa: E731
    return {
        "rot": bool(jax.random.bernoulli(k_rot, cfg.rot90_prob)),
        "k": int(jax.random.randint(k_rotk, (), 1, 4)) if square else 2,
        "flips": tuple(bool(b) for b in np.asarray(
            jax.random.bernoulli(k_flip, cfg.flip_prob, (3,)))),
        "noise": bool(jax.random.bernoulli(k_noise_p, cfg.noise_prob)),
        "sigma": f(jax.random.uniform(k_noise_s, (), minval=0.0,
                                      maxval=cfg.noise_sigma_max)),
        "noise_field": torch.from_numpy(np.array(
            jax.random.normal(k_noise, shape, jnp.float32))),
        "scale_on": bool(jax.random.bernoulli(k_int_p,
                                              cfg.intensity_prob)),
        "scale": f(jax.random.uniform(k_int, (), minval=cfg.intensity_range[0],
                                      maxval=cfg.intensity_range[1])),
        "gamma_on": bool(jax.random.bernoulli(k_gam_p, cfg.gamma_prob)),
        "gamma": f(jax.random.uniform(k_gam, (), minval=cfg.gamma_range[0],
                                      maxval=cfg.gamma_range[1])),
    }


@pytest.mark.parametrize("shape", [(6, 8, 8, 2), (6, 8, 10, 2)])
def test_augment_with_jax_draws_matches_jax(shape):
    rng = np.random.default_rng(5)
    img = rng.normal(size=shape).astype(np.float32)
    seg = rng.integers(0, 4, shape[:3]).astype(np.int32)
    # every transform on, in turn alone, then all of JAX's own draws
    cfg = JAugmentConfig(rot90_prob=0.6, flip_prob=0.5, noise_prob=0.5,
                         intensity_prob=0.5, gamma_prob=0.5)
    off = {"rot": False, "k": 1, "flips": (False,) * 3, "noise": False,
           "sigma": 0.0, "noise_field": None, "scale_on": False,
           "scale": 1.0, "gamma_on": False, "gamma": 1.0}
    jimg, jseg = jnp.asarray(img), jnp.asarray(seg)
    field = rng.normal(size=shape).astype(np.float32)
    alone = [({"rot": True, "k": k}, (jnp.rot90(jimg, k, axes=(1, 2)),
                                      jnp.rot90(jseg, k, axes=(1, 2))))
             for k in ((1, 2, 3) if shape[1] == shape[2] else (2,))]
    for ax in range(3):
        flips = tuple(a == ax for a in range(3))
        alone.append(({"flips": flips}, (jnp.flip(jimg, ax),
                                         jnp.flip(jseg, ax))))
    alone.append(({"noise": True, "sigma": 0.0625,
                   "noise_field": torch.from_numpy(field)},
                  (jimg + jnp.asarray(field) * 0.0625, jseg)))
    alone.append(({"scale_on": True, "scale": 1.0625},
                  (jimg * 1.0625, jseg)))
    mn, mx = jimg.min(), jimg.max()
    alone.append(({"gamma_on": True, "gamma": 1.25},
                  (((jimg - mn) / (mx - mn + 1e-8)) ** 1.25 * (mx - mn) + mn,
                   jseg)))
    aug = jax.jit(lambda k, i, s: jpre.augment_pair(k, i, s, cfg))
    cases = alone + [(_jax_draws(jax.random.PRNGKey(s), shape, cfg),
                      aug(jax.random.PRNGKey(s), jimg, jseg))
                     for s in range(12)]
    for draws, (ri, rs) in cases:
        d = {**off, **draws}
        gi, gs = tpre.apply_augment(torch.from_numpy(img),
                                    torch.from_numpy(seg), d)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
        assert gi.shape == img.shape
        np.testing.assert_allclose(gi.numpy(), np.asarray(ri), rtol=0,
                                   atol=1e-5)


def test_rot90_turns_as_jax():
    x = np.arange(2 * 3 * 4 * 1, dtype=np.float32).reshape(2, 3, 4, 1)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(
            torch.rot90(torch.from_numpy(x), k, dims=(1, 2)).numpy(),
            np.asarray(jnp.rot90(jnp.asarray(x), k, axes=(1, 2))))


def test_augment_draws_by_distribution():
    cfg = AugmentConfig()
    g = torch.Generator().manual_seed(0)
    n = 3000
    ds = [tpre.draw_augment(g, (4, 4, 4, 1), cfg) for _ in range(n)]

    def rate(key):
        return np.mean([d[key] for d in ds])

    assert abs(rate("rot") - cfg.rot90_prob) < 0.04
    ks = np.bincount([d["k"] for d in ds], minlength=4)[1:] / n
    assert np.all(np.abs(ks - 1 / 3) < 0.04), ks
    flips = np.mean([d["flips"] for d in ds], axis=0)
    assert np.all(np.abs(flips - cfg.flip_prob) < 0.04), flips
    assert abs(rate("noise") - cfg.noise_prob) < 0.04
    assert abs(rate("scale_on") - cfg.intensity_prob) < 0.04
    assert abs(rate("gamma_on") - cfg.gamma_prob) < 0.03
    for key, (lo, hi) in (("sigma", (0.0, cfg.noise_sigma_max)),
                          ("scale", cfg.intensity_range),
                          ("gamma", cfg.gamma_range)):
        v = np.array([d[key] for d in ds])
        assert v.min() >= lo and v.max() < hi
        assert abs(v.mean() - (lo + hi) / 2) < 0.03 * (hi - lo)
    for d in ds:
        assert (d["noise_field"] is not None) == d["noise"]
    # a rectangular (H != W) plane keeps its shape: k = 2 only
    rect = [tpre.draw_augment(g, (4, 4, 6, 1), cfg) for _ in range(50)]
    assert {d["k"] for d in rect} == {2}
    img, seg = tpre.augment_pair(torch.zeros((4, 4, 6, 2)),
                                 torch.zeros((4, 4, 6), dtype=torch.int32),
                                 cfg, torch.Generator().manual_seed(3))
    assert img.shape == (4, 4, 6, 2) and seg.shape == (4, 4, 6)
    # the same generator seed, the same augmentation
    x = torch.randn((4, 4, 4, 2))
    s = torch.zeros((4, 4, 4), dtype=torch.int32)
    a = tpre.augment_batch(x[None], s[None], torch.Generator().manual_seed(9))
    b = tpre.augment_batch(x[None], s[None], torch.Generator().manual_seed(9))
    assert torch.equal(a["image"], b["image"])


def test_loader_abandoned_and_decode_error():
    ds = _Arrays(_samples(6))
    loader = tpipeline.DeviceDataLoader(ds, batch_size=1, num_workers=2,
                                        image_size=(8, 8, 8), prefetch=1,
                                        device="cpu")
    it = iter(loader)
    next(it)
    it.close()      # abandon mid-epoch
    loader._producer.join(timeout=15)
    assert not loader._producer.is_alive()
    leaked = [t for t in threading.enumerate()
              if t.name == "loader-producer" and t.is_alive()]
    assert not leaked
    bad = _Arrays(_samples(2) + [ValueError("corrupt volume")])
    loader = tpipeline.DeviceDataLoader(bad, batch_size=1, num_workers=1,
                                        image_size=(8, 8, 8), device="cpu")
    t0 = time.time()
    with pytest.raises(ValueError, match="corrupt volume"):
        for _ in loader:
            pass
    assert time.time() - t0 < 30
    loader._producer.join(timeout=15)
    assert not loader._producer.is_alive()


def test_create_brats_data_loaders(tmp_path):
    root = _cohort(tmp_path, n=5)
    train, val = tpipeline.create_brats_data_loaders(
        root, batch_size=2, num_workers=2, image_size=(16, 16, 16),
        device="cpu", patch_size=(8, 8, 8))
    assert (train.augment, train.shuffle, train.drop_last) == (True, True,
                                                               True)
    assert (val.augment, val.shuffle, val.patch_size) == (False, False, None)
    batches = list(train)
    assert len(batches) == len(train) == 2
    assert batches[0]["image"].shape == (2, 8, 8, 8, 4)
    vb = list(val)
    assert vb[0]["image"].shape == (1, 16, 16, 16, 4)
    assert train.stats["batches"] == 2 and train.stats["wait_s"] >= 0
    assert train.h2d_ms() == 0.0
    assert tpipeline.get_data_loader(train.dataset, device="cpu"
                                     ).batch_size == 1
    assert tpre.create_data_transforms() == {"train": True, "val": False}
