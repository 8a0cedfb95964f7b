"""The port's data-parallel trainer and multi-device predict CLI on one
two-rank gloo world of CPU processes (tests/_torch_parallel_workers.py):
``ModernBrainTumorTrainer(mesh=...)`` for one epoch on a synthetic
cohort through the sharded loaders (f32, dropout at rate 0), then the
predict CLI with ``--window_parallel`` (cropped) and ``--data_parallel``
(whole_volume) in the same world. The trainer's history equals one
process's (1e-5 relative); checkpoints are saved by rank 0 only; the
CLI's outputs are written by rank 0 only, name 2 devices in the index and
equal a one-process run's (masks exactly, confidences within 1e-6)."""

import json
import os

import numpy as np
import pytest
from _torch_parallel_workers import run_world
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_inference_cli import TINY, cohort  # noqa: F401  (fixture)

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
    config as tcfg)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data.pipeline import (
    create_brats_data_loaders)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data.synthetic import (
    create_enhanced_synthetic_data)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    cli as TCLI)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.trainer import (
    ModernBrainTumorTrainer)


def _cli_args(cohort):  # noqa: F811
    return ["--input", str(cohort), "--checkpoint", "none",
            "--save_confidence", "--format", "npy", "--device",
            "cpu"] + TINY


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, cohort):  # noqa: F811
    tmp = tmp_path_factory.mktemp("dp_trainer")
    root = create_enhanced_synthetic_data(
        10, str(tmp / "data"), shape=(24, 24, 20), seed=1,
        size_range=(3, 6), skull_stripped=True)
    dirs = {"results_dir": str(tmp / "results"),
            "models_dir": str(tmp / "models")}
    ranks = run_world("trainer_and_cli", (root, dirs, _cli_args(cohort)),
                      tmp)
    return root, dirs, ranks


def test_dp_trainer_equals_one_process(two_ranks, tmp_path):
    root, dirs, ranks = two_ranks
    train, val = create_brats_data_loaders(
        root, batch_size=2, num_workers=1, image_size=(16, 16, 16),
        device="cpu")
    conf = tcfg.Config(use_tensorboard=False,
                       results_dir=str(tmp_path / "r"),
                       models_dir=str(tmp_path / "m"))
    one = ModernBrainTumorTrainer(
        UNet3D(features=(8, 16), seed=0, device="cpu", dropout_rate=0.0,
               compute_dtype="float32"), config=conf, experiment_name="one")
    hist = one.train(train, val, num_epochs=1)
    # 8 train cases: 4 batches of 2 rows, one row a rank
    assert [r["rows"] for r in ranks] == [[1, 1, 1, 1]] * 2
    for r in ranks:
        assert r["step"] == one.state.step == 4
        assert set(r["history"]) == set(hist)
        for k, v in hist.items():
            np.testing.assert_allclose(r["history"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert ranks[0]["history"] == ranks[1]["history"]


def test_dp_trainer_writes_from_rank_zero(two_ranks):
    _, dirs, ranks = two_ranks
    assert ranks[0]["saves"] and not ranks[1]["saves"]
    assert os.path.isfile(os.path.join(dirs["models_dir"], "best_dp",
                                       "state", "state.pt"))
    assert os.path.isfile(os.path.join(dirs["results_dir"], "reports",
                                       "dp_report.json"))


@pytest.mark.parametrize("flag,mode", [("--window_parallel", "cropped"),
                                       ("--data_parallel", "whole_volume")])
def test_two_rank_cli_equals_one_process(two_ranks, cohort, tmp_path,  # noqa: F811
                                         flag, mode):
    _, dirs, ranks = two_ranks
    out = os.path.join(dirs["results_dir"], f"pred{flag}")
    assert len(ranks[0]["writes"]) > 0 and not ranks[1]["writes"]
    TCLI.predict_main(_cli_args(cohort) + [flag, "--mode", mode,
                                           "--output", str(tmp_path)])
    index = json.load(open(os.path.join(out, "predictions.json")))
    assert index[flag.lstrip("-") + "_devices"] == 2
    for cid in ("case_a", "case_b"):
        np.testing.assert_array_equal(
            np.load(os.path.join(out, f"{cid}_seg.npy")),
            np.load(tmp_path / f"{cid}_seg.npy"))
        np.testing.assert_allclose(
            np.load(os.path.join(out, f"{cid}_conf.npy")),
            np.load(tmp_path / f"{cid}_conf.npy"), rtol=0, atol=1e-6)
    for r in ranks:
        assert [s["case_id"] for s in r["summaries"][flag]] == [
            "case_a", "case_b"]
