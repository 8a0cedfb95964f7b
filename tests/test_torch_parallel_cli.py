"""The port's multi-device entry points on the CPU:

* the predict CLI at world 1 with ``--device cpu``: ``--data_parallel``
  (whole_volume) and ``--window_parallel`` (cropped) against JAX's CLI
  with the same flag, on tests/test_torch_inference_cli.py's cohort and
  checkpoint, both in float32: masks equal, confidences within 1.8e-5,
  and the index's device count;
* ``Predictor(config.inference.window_parallel)``: a no-op at world 1;
* with ``space > 1``: the trainer taking a ``ps2d_train`` model, and
  what stays refused (a slab depth that pools to an odd depth);
  ``--mesh_data 2`` in a world of one refused as JAX's mesh refuses it,
  and the train CLI with ``--mesh_space 2`` for one epoch on a two-rank
  world of CPU processes.

The trainer and the CLIs on two ranks are in
tests/test_torch_parallel_trainer.py.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401
from _torch_parallel_workers import run_world
from test_torch_inference_cli import (  # noqa: F401  (fixtures)
    TINY, checkpoints, cohort, float32_presets)

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.inference import (
    cli as JCLI)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
    config as tcfg)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data import (
    nifti)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference import (
    cli as TCLI)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.predictor import (
    Predictor)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.parallel import (
    mesh as M)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.cli import (
    train_main)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.trainer import (
    ModernBrainTumorTrainer)


@pytest.mark.parametrize("flag,mode", [("--data_parallel", "whole_volume"),
                                       ("--window_parallel", "cropped")])
def test_cli_parallel_flags_equal_jax(cohort, checkpoints, tmp_path,  # noqa: F811
                                      float32_presets, flag, mode):  # noqa: F811
    src, converted = checkpoints
    common = ["--input", str(cohort), "--mode", mode, "--save_confidence",
              flag] + TINY
    oj, ot = tmp_path / "jax", tmp_path / "port"
    JCLI.predict_main(common + ["--output", str(oj), "--checkpoint", src])
    st = TCLI.predict_main(common + ["--output", str(ot), "--checkpoint",
                                     converted, "--device", "cpu"])
    assert [s["case_id"] for s in st] == ["case_a", "case_b"]
    ij = json.load(open(oj / "predictions.json"))
    it = json.load(open(ot / "predictions.json"))
    assert list(it) == list(ij)
    key = flag.lstrip("-") + "_devices"
    assert it[key] == 1 and ij[key] == jax.device_count()
    for cid in ("case_a", "case_b"):
        a = nifti.load(str(oj / f"{cid}_seg.nii.gz")).data
        b = nifti.load(str(ot / f"{cid}_seg.nii.gz")).data
        np.testing.assert_array_equal(b, a)
        a = nifti.load(str(oj / f"{cid}_conf.nii.gz")).data
        b = nifti.load(str(ot / f"{cid}_conf.nii.gz")).data
        np.testing.assert_allclose(b, a, rtol=0, atol=1.8e-5)


# ---------------------------------------------------------------- refusals

def test_predictor_window_parallel_config_at_world_one():
    conf = tcfg.Config(model=tcfg.ModelConfig(features=(8, 16),
                                              compute_dtype="float32"))
    conf = conf.replace(inference=dataclasses.replace(
        conf.inference, window_parallel=True, roi_size=(16, 16, 16)))
    pred = Predictor(conf, device="cpu")
    assert pred.window_mesh is None          # one process: JAX's rule too
    pred.enable_window_parallel(M.create_mesh())
    vol = np.random.default_rng(0).normal(size=(20, 20, 16, 4)).astype(
        np.float32)
    ref = Predictor(conf, device="cpu")
    a = pred.segment_with_confidence(vol, mode="sliding_window")
    b = ref.segment_with_confidence(vol, mode="sliding_window")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-6)


def test_space_sharding_is_refused(tmp_path):
    """What stays refused with ``space`` > 1, and the train CLI with
    ``--mesh_space 2`` for one epoch on a two-rank world of CPU
    processes, which then refuses an image depth whose slabs pool to an
    odd depth. The trainer takes a ``ps2d_train`` model on a data x
    space mesh (the region runs on the slabs)."""
    mesh = M.Mesh(np.arange(2).reshape(1, 2), rank=0)
    trainer = ModernBrainTumorTrainer(
        UNet3D(features=(32, 64), device="cpu", ps2d_train=True),
        config=tcfg.Config(use_tensorboard=False,
                           results_dir=str(tmp_path / "results")),
        mesh=mesh)
    assert trainer.mesh is mesh and trainer.model.ps2d_train
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        train_main(["--mesh_data", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_main(["--mesh_data", "2"])
    args = ["--epochs", "1", "--synthetic_shape", "20", "20", "16",
            "--features", "8", "16", "--batch_size", "2", "--num_workers",
            "1", "--dtype", "float32", "--device", "cpu", "--data_dir",
            "data/syn", "--mesh_space", "2"]
    ranks = run_world("spatial_cli", (
        str(tmp_path), args + ["--create_synthetic", "--num_samples", "4",
                               "--image_size", "16", "16", "16",
                               "--experiment_name", "sp"],
        args + ["--image_size", "12", "16", "16", "--experiment_name",
                "odd"]), tmp_path)
    for r in ranks:
        assert r["mesh"] == {"data": 1, "space": 2} and r["step"] >= 1
        assert np.isfinite(r["history"]["train_loss"][0])
        kind, msg = r["odd"]
        assert kind == "ValueError" and "multiple of space * 2^2 = 8" in msg
    np.testing.assert_equal(ranks[0]["history"], ranks[1]["history"])
    assert (tmp_path / "results" / "models" / "best_sp").is_dir()
