"""The port's data-parallel trainer and multi-device predict CLI on one
two-rank gloo world of CPU processes (tests/_torch_parallel_workers.py):
``ModernBrainTumorTrainer(mesh=...)`` for one epoch on a synthetic
cohort through the sharded loaders (f32, dropout at rate 0), then the
predict CLI with ``--window_parallel`` (cropped) and ``--data_parallel``
(whole_volume) in the same world. The trainer's history equals one
process's (1e-5 relative); checkpoints are saved by rank 0 only; the
CLI's outputs are written by rank 0 only, name 2 devices in the index and
equal a one-process run's (masks exactly, confidences within 1e-6).

Beside it, a second world runs the trainer on a data 1 x space 2 mesh
(each rank its D slab of every batch): its history equals one
process's, rank 0 alone writes the checkpoint, and the checkpoint
reloads bit for bit."""

import json
import os

import numpy as np
import pytest
import torch
from _torch_parallel_workers import World, run_world
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
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    checkpoints, create_train_state)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.trainer import (
    ModernBrainTumorTrainer)


def _cli_args(cohort):  # noqa: F811
    return ["--input", str(cohort), "--checkpoint", "none",
            "--save_confidence", "--format", "npy", "--device",
            "cpu"] + TINY


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_trainer")
    root = create_enhanced_synthetic_data(
        10, str(tmp / "data"), shape=(24, 24, 20), seed=1,
        size_range=(3, 6), skull_stripped=True)
    return tmp, root


@pytest.fixture(scope="module")
def spatial_started(synthetic):
    """The data 1 x space 2 trainer's world, started before the data
    world so that the two run together."""
    tmp, root = synthetic
    dirs = {"results_dir": str(tmp / "sp_results"),
            "models_dir": str(tmp / "sp_models")}
    return dirs, World("spatial_trainer", (root, dirs), tmp, timeout=240)


@pytest.fixture(scope="module")
def two_ranks(synthetic, cohort, spatial_started):  # noqa: F811
    tmp, root = synthetic
    dirs = {"results_dir": str(tmp / "results"),
            "models_dir": str(tmp / "models")}
    ranks = run_world("trainer_and_cli", (root, dirs, _cli_args(cohort)),
                      tmp)
    return root, dirs, ranks


@pytest.fixture(scope="module")
def one_process(synthetic, tmp_path_factory):
    """One process's trainer on the same cohort: (history, steps)."""
    _, root = synthetic
    tmp = tmp_path_factory.mktemp("one_trainer")
    train, val = create_brats_data_loaders(
        root, batch_size=2, num_workers=1, image_size=(16, 16, 16),
        device="cpu")
    conf = tcfg.Config(use_tensorboard=False,
                       results_dir=str(tmp / "r"),
                       models_dir=str(tmp / "m"))
    one = ModernBrainTumorTrainer(
        UNet3D(features=(8, 16), seed=0, device="cpu", dropout_rate=0.0,
               compute_dtype="float32"), config=conf, experiment_name="one")
    return one.train(train, val, num_epochs=1), one.state.step


def test_dp_trainer_equals_one_process(two_ranks, one_process):
    root, dirs, ranks = two_ranks
    hist, steps = one_process
    # 8 train cases: 4 batches of 2 rows, one row a rank
    assert [r["rows"] for r in ranks] == [[1, 1, 1, 1]] * 2
    for r in ranks:
        assert r["step"] == steps == 4
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


@pytest.fixture(scope="module")
def spatial_ranks(spatial_started):
    dirs, world = spatial_started
    return dirs, world.results()


def test_spatial_trainer_equals_one_process(spatial_ranks, one_process):
    """Each rank trains on the D slabs (8 of 16 planes) of the same
    batches; the history, validation's Dice included, is one process's
    within 1e-5 relative. The validation loss within 1e-4: head_conv's
    bias has a gradient of zero in exact arithmetic at train (the
    BatchNorm on batch statistics takes it away), so Adam moves it by
    rounding noise over the rate, a different move in each run; at
    validation the BatchNorm's running statistics keep it, and the loss
    moves with it (by 1.8e-5 here; the Dice does not)."""
    _, ranks = spatial_ranks
    hist, steps = one_process
    for r in ranks:
        assert r["step"] == steps == 4
        assert r["shapes"] == [(2, 8, 16, 16, 4)] * 4 + [(2, 8, 16, 16)]
        assert set(r["history"]) == set(hist)
        for k, v in hist.items():
            np.testing.assert_allclose(
                r["history"][k], v, rtol=1e-4 if k == "val_loss" else 1e-5,
                atol=1e-7, err_msg=k)
    np.testing.assert_equal(ranks[0]["history"], ranks[1]["history"])


def test_spatial_trainer_checkpoint_from_rank_zero_reloads(spatial_ranks):
    dirs, ranks = spatial_ranks
    assert ranks[0]["saves"] and not ranks[1]["saves"]
    path = os.path.join(dirs["models_dir"], "best_sp")
    fresh = create_train_state(
        UNet3D(features=(8, 16), seed=7, device="cpu", dropout_rate=0.0,
               compute_dtype="float32"), tcfg.Config())
    restored, meta = checkpoints.restore_checkpoint(path, fresh)
    assert meta["epoch"] == 0
    got = dict(restored.model.named_parameters())
    for r in ranks:
        assert set(r["params"]) == set(got)
        for k, v in r["params"].items():
            assert torch.equal(got[k].detach(), torch.from_numpy(v)), k
