"""The port's trainer path on the CPU at tiny sizes: ``ModernBrainTumorTrainer``
end to end on a synthetic cohort (its metrics-history keys as JAX's),
save-on-best, early stopping, ``val_interval``, resume at the
checkpoint's epoch, ``save_latest_every`` and an empty validation split;
the training CLI with ``--dtype float32 --device cpu``; the app's
training routes over HTTP in demo and real modes, and serving's
adoption of the trained ``best_*`` checkpoint."""

import dataclasses
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    Config as JConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train.trainer import (
    ModernBrainTumorTrainer as JTrainer)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import config as tcfg
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data.pipeline import (
    create_brats_data_loaders)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.data.synthetic import (
    create_enhanced_synthetic_data)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.serve import app as tapp
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import (
    checkpoints as ck)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.cli import (
    train_main)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train.trainer import (
    ModernBrainTumorTrainer)

FEATS = (8, 16)
REGION_KEYS = {"val_dice_WT", "val_dice_TC", "val_dice_ET"}


def _config(tmp_path, **kw):
    return tcfg.Config(results_dir=str(tmp_path / "results"),
                       models_dir=str(tmp_path / "models"),
                       use_tensorboard=False, **kw)


def _model(seed=0):
    return UNet3D(features=FEATS, seed=seed, device="cpu")


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.normal(size=(2, 8, 8, 8, 4))
                                       .astype(np.float32)),
             "mask": torch.from_numpy(rng.integers(0, 4, (2, 8, 8, 8))
                                      .astype(np.int32))}
            for _ in range(n)]


def test_trainer_end_to_end_on_a_cohort(tmp_path):
    root = create_enhanced_synthetic_data(
        5, str(tmp_path / "cohort"), shape=(24, 24, 20), seed=1,
        size_range=(3, 6), skull_stripped=True)
    train, val = create_brats_data_loaders(
        root, batch_size=2, num_workers=2, image_size=(16, 16, 16),
        device="cpu", patch_size=(16, 16, 16))
    conf = _config(tmp_path)
    with pytest.raises(ValueError):
        ModernBrainTumorTrainer(_model(), device="cuda", config=conf)
    trainer = ModernBrainTumorTrainer(_model(), device="cpu", config=conf,
                                      experiment_name="e2e")
    hist = trainer.train(train, val, num_epochs=2)
    jkeys = set(JTrainer(None, config=JConfig(use_tensorboard=False),
                         use_wandb=False).metrics_history)
    assert set(hist) == jkeys | REGION_KEYS
    assert all(len(v) == 2 for v in hist.values())
    assert all(np.isfinite(hist["train_loss"]))
    assert trainer.state.step == 4 and len(trainer.timing["step_s"]) == 4
    assert len(trainer.timing["loader_wait_s"]) == 4
    assert os.path.isfile(os.path.join(conf.models_dir, "best_e2e", "state",
                                       "state.pt"))
    report = json.load(open(os.path.join(conf.results_dir, "reports",
                                         "e2e_report.json")))
    assert report["epochs_trained"] == 2
    assert set(report["metrics_history"]) == set(hist)


def _scripted(trainer, dice):
    """Validation answers the given Dice per epoch."""
    it = iter(dice)

    def validate(loader, epoch=0):
        return {"loss": 1.0, "dice": next(it), "hausdorff": float("nan")}
    trainer.validate_epoch = validate


def test_save_on_best_early_stopping_and_latest(tmp_path):
    conf = _config(tmp_path, early_stopping_patience=2)
    trainer = ModernBrainTumorTrainer(_model(), config=conf,
                                      experiment_name="es",
                                      save_latest_every=2)
    saves = []
    save = trainer.save_model
    trainer.save_model = lambda epoch=0, path=None: saves.append(
        (epoch, path)) or save(epoch, path)
    _scripted(trainer, [0.1, 0.3, 0.2, 0.25, 0.9])
    hist = trainer.train(_batches(1), _batches(1), num_epochs=10)
    # best at epoch 1; two epochs without a gain stop the run at epoch 3,
    # before its latest_ save
    assert len(hist["val_dice"]) == 4 and trainer.best_dice == 0.3
    latest = os.path.join(conf.models_dir, "latest_es")
    assert saves == [(0, None), (1, None), (2, latest)]
    meta = json.load(open(os.path.join(conf.models_dir, "best_es",
                                       "trainer_meta.json")))
    assert meta["epoch"] == 1 and meta["best_dice"] == 0.3


def test_val_interval_and_empty_validation(tmp_path):
    conf = _config(tmp_path, val_interval=2)
    trainer = ModernBrainTumorTrainer(_model(), config=conf,
                                      experiment_name="vi")
    calls = []
    real = trainer.validate_epoch
    trainer.validate_epoch = lambda loader, epoch=0: (
        calls.append(epoch) or real(loader, epoch))
    hist = trainer.train(_batches(1), _batches(1), num_epochs=4)
    assert calls == [0, 2, 3]           # every 2nd epoch and the last
    assert hist["val_loss"][1] == hist["val_loss"][0]
    # an empty validation split: the final weights are still saved
    conf = _config(tmp_path / "empty")
    trainer = ModernBrainTumorTrainer(_model(), config=conf,
                                      experiment_name="nv")
    hist = trainer.train(_batches(2), [], num_epochs=2)
    assert hist["val_dice"] == [0.0, 0.0]
    assert os.path.isdir(os.path.join(conf.models_dir, "best_nv", "state"))


def test_resume_starts_at_the_checkpoints_epoch(tmp_path):
    conf = _config(tmp_path)
    first = ModernBrainTumorTrainer(_model(), config=conf,
                                    experiment_name="r")
    _scripted(first, [0.2, 0.4])
    first.train(_batches(2), _batches(1), num_epochs=2)
    path = os.path.join(conf.models_dir, "best_r")
    saved = ck.state_tree(first.state)
    second = ModernBrainTumorTrainer(_model(seed=5), config=conf,
                                     experiment_name="r")
    second.load_checkpoint(path)
    epochs = []
    real = second.train_epoch
    second.train_epoch = lambda loader, epoch: (
        epochs.append(epoch) or real(loader, epoch))
    _scripted(second, [0.5, 0.6])
    second.train(_batches(2), _batches(1), num_epochs=3)
    assert epochs == [1, 2]             # best_r was saved at epoch 1
    assert second.metrics_history["val_dice"][:2] == [0.2, 0.4]
    assert second.state.step == saved["step"] + 4
    # resuming into its own path does not archive it
    assert not os.path.exists(os.path.join(conf.models_dir, "archive"))


def test_cli_float32_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer, hist = train_main([
        "--create_synthetic", "--num_samples", "4", "--epochs", "1",
        "--image_size", "16", "16", "16", "--synthetic_shape", "20", "20",
        "16", "--features", "8", "16", "--batch_size", "2",
        "--num_workers", "1", "--dtype", "float32", "--device", "cpu",
        "--data_dir", "data/syn", "--experiment_name", "cli"])
    assert trainer.model.compute_dtype == torch.float32
    assert trainer.config.model.compute_dtype == "float32"
    assert np.isfinite(hist["train_loss"][0])
    assert os.path.isdir(tmp_path / "results" / "models" / "best_cli")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        train_main(["--mesh_space", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_main(["--epochs", "1"])


def _serve(app):
    server = tapp.create_server("127.0.0.1", 0, app=app)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _wait(port, sid, statuses, timeout=240):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status, prog = _call(port, "GET", f"/training_progress?session_id={sid}")
        assert status == 200
        if prog["status"] in statuses:
            return prog
        time.sleep(0.2)
    raise AssertionError(f"session {sid}: {prog}")


def test_training_routes_over_http_and_adoption(tmp_path):
    feats = (16, 32, 64, 128)          # the web sessions' compact ladder
    conf = tcfg.Config(
        model=tcfg.ModelConfig(features=feats),
        data=tcfg.DataConfig(image_size=(16, 16, 16)),
        inference=tcfg.InferenceConfig(roi_size=(16, 16, 16),
                                       crop_bucket_ladder=()),
        data_dir=str(tmp_path / "data"), models_dir=str(tmp_path / "models"))
    app = tapp.BrainTumorApp(conf, upload_dir=str(tmp_path / "u"),
                             device="cpu")
    server, thread = _serve(app)
    port = server.server_address[1]
    try:
        status, ans = _call(port, "POST", "/start_training",
                            {"mode": "demo", "epochs": 2,
                             "epoch_seconds": 0.01})
        assert status == 200 and ans["success"]
        demo = ans["session_id"]
        prog = _wait(port, demo, ("completed",))
        assert prog["current_epoch"] == 2 and "config" not in prog
        status, ans = _call(port, "POST", "/start_training",
                            {"epochs": 2, "num_samples": 2,
                             "image_size": [16, 16, 16], "batch_size": 1})
        real = ans["session_id"]
        prog = _wait(port, real, ("completed", "error"))
        assert prog["status"] == "completed", prog
        assert np.isfinite(prog["train_loss"])
        ckpt = prog["checkpoint"]
        assert os.path.basename(ckpt) == f"best_web_{real}"
        assert os.path.isfile(os.path.join(ckpt, "state", "state.pt"))
        # a third session, stopped
        _, ans = _call(port, "POST", "/start_training",
                       {"mode": "demo", "epochs": 500, "epoch_seconds": 0.05})
        third = ans["session_id"]
        status, ans = _call(port, "POST", "/stop_training",
                            {"session_id": third})
        assert status == 200 and ans["stopped"] is True
        assert _wait(port, third, ("stopped",))["current_epoch"] < 500
        status, ans = _call(port, "POST", "/start_training",
                            {"data_dir": "../../etc"})
        assert status == 400
        status, health = _call(port, "GET", "/health")
        assert health["sessions"] == [demo, real, third]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        app.jobs.join(timeout=60)
    # checkpoint "" serves the newest compatible best_*: the web session's
    served = tapp.BrainTumorApp(conf, upload_dir=str(tmp_path / "u"),
                                device="cpu")
    pred = served._get_predictor()
    assert served.weights_source == ckpt
    params, _ = ck.load_inference_weights(ckpt)
    tree = to_flax_variables(pred.seg_model.state_dict())["params"]
    assert ck.compatible_tree(tree, params)
    np.testing.assert_array_equal(tree["head_out"]["kernel"],
                                  params["head_out"]["kernel"])
    # an explicit path that does not fit the model is refused
    other = dataclasses.replace(conf, model=tcfg.ModelConfig(
        features=(8, 16)), inference=dataclasses.replace(
        conf.inference, checkpoint=ckpt))
    with pytest.raises(ValueError):
        tapp.BrainTumorApp(other, upload_dir=str(tmp_path / "u"),
                           device="cpu")._get_predictor()
