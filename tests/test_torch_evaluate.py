"""The port's cohort scorer (``…_torch/inference/evaluate.py``) against the
JAX package's on the same arrays and files (the cases of
tests/test_evaluate.py): ``evaluate_case``, ``aggregate``,
``discover_pairs`` and ``evaluate_main`` (its JSON, CSV and printed
table) equal, NaN for NaN and inf for inf. The counts are integers and
HD95 is the same host EDT, so every value is equal, not close."""

import json
import math

import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.data import (
    nifti as jnifti)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference import (
    evaluate as J)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    evaluate as T)


def _cube(shape=(16, 16, 16), lo=4, hi=10, label=1):
    v = np.zeros(shape, np.int32)
    v[lo:hi, lo:hi, lo:hi] = label
    return v


def _shaved():
    pred = _cube()
    pred[:, :, 9] = 0
    return pred


def _raw_brats():
    gt = np.zeros((12, 12, 12), np.int32)
    gt[2:6, 2:6, 2:6] = 1
    gt[6:9, 6:9, 6:9] = 2
    gt[9:11, 9:11, 9:11] = 4
    return gt


def _label4():
    gt = np.zeros((8, 8, 8), np.int32)
    gt[0:4] = 3
    gt[4:8] = 4
    return gt


def _noisy():
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 5, (14, 12, 10)).astype(np.int32)
    return np.where(rng.random(gt.shape) < 0.2, 0, gt), gt


CASES = {
    "perfect": lambda: (_cube(label=2), _cube(label=2), {}),
    "shaved": lambda: (_shaved(), _cube(), {}),
    "empty_vs_present": lambda: (_cube(label=1), _cube(label=3), {}),
    "z_shift": lambda: (np.roll(_cube(), 2, axis=0), _cube(), {}),
    "z_shift_spacing": lambda: (np.roll(_cube(), 2, axis=0), _cube(),
                                {"spacing": (3.0, 1.0, 1.0)}),
    "raw_brats": lambda: (np.where(_raw_brats() == 4, 3, _raw_brats()),
                          _raw_brats(), {}),
    "label4_class": lambda: (_label4(), _label4(), {"num_classes": 5}),
    "noisy": lambda: (*_noisy(), {"spacing": (1.0, 0.9, 2.4)}),
    "all_background": lambda: (np.zeros((6, 6, 6), np.int32),
                               np.zeros((6, 6, 6), np.int32), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_case_equals_jax(name):
    pred, gt, kw = CASES[name]()
    want = J.evaluate_case(pred, gt, **kw)
    got = T.evaluate_case(pred, gt, device="cpu", **kw)
    assert list(got) == list(want)
    np.testing.assert_equal(got, want)
    # tensors in, the same numbers out
    again = T.evaluate_case(torch.from_numpy(pred), torch.from_numpy(gt),
                            device="cpu", **kw)
    np.testing.assert_equal(again, want)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        T.evaluate_case(np.zeros((8, 8, 8), np.int32),
                        np.zeros((8, 8, 9), np.int32), device="cpu")


def test_aggregate_equals_jax():
    per_case = {"a": {"x": 1.0, "y": 0.5}, "b": {"x": float("nan")},
                "c": {"x": float("inf"), "y": 0.25}, "d": {"x": 3.0}}
    got = T.aggregate(per_case)
    np.testing.assert_equal(got, J.aggregate(per_case))
    assert got["x"]["n"] == 2 and got["x"]["n_excluded"] == 2
    assert math.isnan(T.aggregate({"a": {"x": float("nan")}})["x"]["mean"])


@pytest.fixture()
def cohort_with_preds(tmp_path):
    gt_root = tmp_path / "gt"
    pred_dir = tmp_path / "pred"
    pred_dir.mkdir()
    for cid, shift in [("case_a", 0), ("case_b", 1), ("sub-01.ses-02", 2)]:
        d = gt_root / cid
        d.mkdir(parents=True)
        gt = _cube(label=1) + _cube(lo=6, hi=8, label=2)
        aff = np.diag([1.0, 1.0, 1.5 if shift else 1.0, 1.0])
        jnifti.save(str(d / f"{cid}_seg.nii.gz"), gt.astype(np.uint8),
                    affine=aff)
        jnifti.save(str(pred_dir / f"{cid}_seg.nii.gz"),
                    np.roll(gt, shift, axis=1).astype(np.uint8))
    # a flat GT named by the case and a prediction without the suffix
    flat = _cube(label=3)
    np.save(gt_root / "case_c.npy", flat)
    np.save(pred_dir / "case_c.npy", np.roll(flat, 1, axis=2))
    (pred_dir / "orphan_seg.nii.gz").write_bytes(b"")   # no GT: skipped
    return gt_root, pred_dir


def test_discover_pairs_equals_jax(cohort_with_preds):
    gt_root, pred_dir = cohort_with_preds
    got = T.discover_pairs(str(pred_dir), str(gt_root))
    assert got == J.discover_pairs(str(pred_dir), str(gt_root))
    assert [p["case_id"] for p in got] == ["case_a", "case_b", "case_c",
                                          "sub-01.ses-02"]
    with pytest.raises(SystemExit):
        T.discover_pairs(str(pred_dir / "missing"), str(gt_root))


@pytest.mark.parametrize("extra", [[], ["--spacing", "2", "1", "1"]])
def test_evaluate_main_equals_jax(cohort_with_preds, tmp_path, capsys,
                                  extra):
    gt_root, pred_dir = cohort_with_preds
    results, tables, csvs = [], [], []
    for mod, tag, dev in ((J, "jax", []), (T, "port", ["--device", "cpu"])):
        out, csv_path = tmp_path / f"{tag}.json", tmp_path / f"{tag}.csv"
        res = mod.evaluate_main(["--pred", str(pred_dir),
                                 "--gt", str(gt_root),
                                 "--output", str(out),
                                 "--csv", str(csv_path)] + extra + dev)
        tables.append(capsys.readouterr().out)
        results.append((res, json.load(open(out))))
        csvs.append(csv_path.read_text())
    (got, got_disk), (want, want_disk) = results[1], results[0]
    np.testing.assert_equal(got, want)
    np.testing.assert_equal(got_disk, want_disk)
    assert csvs[0] == csvs[1] and tables[0] == tables[1]
    assert got["n_cases"] == 4 and "dice_WT" in tables[1]
    if not extra:    # the GT header's 1.5 mm along axis 2 reaches HD95
        assert got["cases"]["sub-01.ses-02"]["hd95_WT"] > 0


def test_evaluate_main_needs_a_card_unless_told(cohort_with_preds):
    gt_root, pred_dir = cohort_with_preds
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.evaluate_main(["--pred", str(pred_dir), "--gt", str(gt_root)])
