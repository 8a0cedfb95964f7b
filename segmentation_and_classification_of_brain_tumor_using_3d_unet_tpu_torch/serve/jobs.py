"""Training jobs of the web tier (counterpart of the JAX package's
``serve/jobs.py``).

``TrainingJobManager`` runs each session in a thread of its own:
``mode="real"`` trains a model on the manager's device on a synthetic
cohort (or a ``data_dir``) and saves its best epoch as
``best_web_<session>`` under ``models_dir``, where serving's checkpoint
discovery finds it; ``mode="demo"`` replays the reference's simulated
curves. Sessions are guarded by a lock, ``stop`` is honoured between
batches and epochs, and the magnitudes of a request are capped. The web
sessions build their ``UNet3D`` without the ps2d region, as JAX's do.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _arch_features(arch: str):
    """The feature ladder of a ``model_arch`` value: "enhanced" and
    "*_full" train the full 32..512 ladder, anything else the compact
    16..128 one."""
    if arch.endswith("_full") or arch == "enhanced":
        return (32, 64, 128, 256, 512)
    return (16, 32, 64, 128)


class TrainingJobManager:
    """Web training sessions. ``models_dir`` is where real sessions save
    their checkpoints; ``device`` is the one they train on."""

    def __init__(self, models_dir: str = "results/models", device="cuda"):
        self.models_dir = models_dir
        self.device = device
        self._lock = threading.RLock()
        self._sessions: Dict[str, Dict] = {}
        self._stop_flags: Dict[str, threading.Event] = {}
        self._threads: Dict[str, threading.Thread] = {}

    # ------------------------------------------------------------------

    def start_training_session(self, config: Optional[Dict] = None) -> str:
        config = dict(config or {})
        with self._lock:
            # the id is made under the lock: two requests in one second
            # must not share one
            session_id = (f"train_{time.strftime('%Y%m%d_%H%M%S')}"
                          f"_{len(self._sessions)}")
            self._sessions[session_id] = {
                "status": "starting",
                "config": config,
                "current_epoch": 0,
                "total_epochs": int(config.get("epochs", 10)),
                "train_loss": 0.0,
                "val_loss": 0.0,
                "dice_score": 0.0,
                "best_dice": 0.0,
                "learning_rate": float(config.get("learning_rate", 1e-4)),
                "logs": [],
                "started_at": time.time(),
            }
            self._stop_flags[session_id] = threading.Event()
            t = threading.Thread(target=self._run, args=(session_id, config),
                                 daemon=True, name=session_id)
            self._threads[session_id] = t
        t.start()
        return session_id

    def stop_training_session(self, session_id: str) -> bool:
        with self._lock:
            if session_id not in self._sessions:
                return False
            self._stop_flags[session_id].set()
            if self._sessions[session_id]["status"] in ("starting",
                                                        "running"):
                self._sessions[session_id]["status"] = "stopping"
        return True

    def get_training_progress(self, session_id: str) -> Optional[Dict]:
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None:
                return None
            snap = {k: v for k, v in s.items() if k != "config"}
            snap["logs"] = list(s["logs"])[-10:]
            return snap

    def list_sessions(self) -> List[str]:
        with self._lock:
            return list(self._sessions)

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for every session's thread to end."""
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.join(timeout)

    # ------------------------------------------------------------------

    def _log(self, sid: str, msg: str) -> None:
        with self._lock:
            if sid in self._sessions:
                self._sessions[sid]["logs"].append(
                    f"[{time.strftime('%H:%M:%S')}] {msg}")
        logger.info("[%s] %s", sid, msg)

    def _update(self, sid: str, **kw) -> None:
        with self._lock:
            if sid in self._sessions:
                self._sessions[sid].update(kw)

    def _run(self, sid: str, config: Dict) -> None:
        try:
            if config.get("mode", "real") == "demo":
                self._run_demo(sid, config)
            else:
                self._run_real(sid, config)
        except Exception as e:
            logger.exception("training session %s failed", sid)
            self._log(sid, f"error: {e}")
            self._update(sid, status="error", error=str(e))

    def _stopped(self, sid: str) -> bool:
        if not self._stop_flags[sid].is_set():
            return False
        self._log(sid, "stopped by user")
        self._update(sid, status="stopped")
        return True

    # ---- real: training on the device ----

    def _run_real(self, sid: str, config: Dict) -> None:
        import dataclasses

        import torch

        from ..config import Config
        from ..data.pipeline import create_brats_data_loaders
        from ..data.synthetic import create_enhanced_synthetic_data
        from ..models import UNet3D, UNet3DWithClassifier
        from ..train import checkpoints
        from ..train.loop import (make_eval_step, make_joint_train_step,
                                  make_train_step)
        from ..train.state import (create_train_state, current_lr,
                                   ema_eval_state)

        # unauthenticated JSON: cap the magnitudes
        epochs = max(1, min(int(config.get("epochs", 10)), 10_000))
        batch_size = max(1, min(int(config.get("batch_size", 2)), 32))
        lr = float(config.get("learning_rate", 1e-4))
        num_samples = max(1, min(int(config.get("num_samples", 8)), 500))
        arch = config.get("model_arch", "attention_unet")
        data_dir = config.get("data_dir")
        save_ckpt = bool(config.get("save_checkpoint", True))
        feats = _arch_features(arch)
        img = tuple(max(8, min(int(s), 256)) for s in
                    config.get("image_size", (64, 64, 64)))[:3]

        made_dir = None
        if not data_dir:
            self._log(sid, f"preparing data ({num_samples} synthetic "
                           f"samples)")
            data_dir = made_dir = tempfile.mkdtemp(prefix="web_train_")
            create_enhanced_synthetic_data(
                num_samples, data_dir, shape=(96, 96, 64),
                seed=int(time.time()) % 2 ** 31)
        try:
            if self._stopped(sid):
                return
            base = Config()
            cfg = base.replace(
                model=dataclasses.replace(base.model, features=feats),
                data=dataclasses.replace(base.data, image_size=img),
                batch_size=batch_size, use_tensorboard=False,
                models_dir=self.models_dir,
                ema_decay=float(config.get("ema_decay") or 0.0),
                grad_accum=max(int(config.get("grad_accum") or 1), 1))
            train_loader, val_loader = create_brats_data_loaders(
                data_dir, batch_size=batch_size, num_workers=2,
                image_size=img, aug_cfg=cfg.augment, device=self.device)
            if len(train_loader.dataset) == 0:
                raise RuntimeError(f"no training data in {data_dir}")
            self._log(sid, f"building the model (arch={arch}, "
                           f"features={feats}, image={img})")
            if arch.startswith("joint"):
                if cfg.grad_accum > 1:
                    raise ValueError("grad_accum > 1 is not supported for "
                                     "the joint arch")
                # trunk + grade head; serving adopts the "unet" trunk
                model = UNet3DWithClassifier(out_channels=4, features=feats,
                                             device=self.device)
                tstep = make_joint_train_step(cfg)
            else:
                model = UNet3D(out_channels=4, features=feats,
                               device=self.device)
                tstep = make_train_step(cfg)
            steps = max(len(train_loader), 1)
            state = create_train_state(model, cfg, steps, lr)
            estep = make_eval_step(cfg)
            dev = next(model.parameters()).device
            gen = torch.Generator(device=dev).manual_seed(1)
            self._update(sid, status="running", total_epochs=epochs)
            best = 0.0
            for epoch in range(epochs):
                if self._stopped(sid):
                    return
                tl, n = None, 0
                for batch in train_loader:
                    if self._stopped(sid):
                        return
                    state, m = tstep(state, batch, gen)
                    tl = m["loss"] if tl is None else tl + m["loss"]
                    n += 1
                vl = vd = None
                nv = 0
                # the EMA weights, when tracked, are what is validated
                # and saved on best
                eval_state = ema_eval_state(state)
                for batch in val_loader:
                    m = estep(eval_state, batch)
                    vl = m["loss"] if vl is None else vl + m["loss"]
                    vd = m["dice"] if vd is None else vd + m["dice"]
                    nv += 1
                train_loss = float(tl) / n if n else 0.0
                val_loss = float(vl) / nv if nv else 0.0
                dice = float(vd) / nv if nv else 0.0
                if save_ckpt and (dice > best or epoch == 0):
                    path = os.path.join(cfg.models_dir, f"best_web_{sid}")
                    try:
                        checkpoints.save_checkpoint(
                            path, state, best_dice=dice, epoch=epoch + 1)
                        self._update(sid, checkpoint=path)
                        self._log(sid, f"saved checkpoint {path}")
                    except Exception as e:    # a full disk: keep training
                        logger.warning("checkpoint save failed: %s", e)
                best = max(best, dice)
                self._update(sid, current_epoch=epoch + 1,
                             train_loss=round(train_loss, 4),
                             val_loss=round(val_loss, 4),
                             dice_score=round(dice, 4),
                             best_dice=round(best, 4),
                             learning_rate=current_lr(
                                 state, cfg.optimizer, steps, lr))
                self._log(sid, f"epoch {epoch + 1}/{epochs} "
                               f"loss {train_loss:.4f} dice {dice:.4f}")
            self._update(sid, status="completed")
            self._log(sid, f"training complete; best dice {best:.4f}")
        finally:
            if made_dir:
                shutil.rmtree(made_dir, ignore_errors=True)

    # ---- demo: the reference's simulated curves ----

    def _run_demo(self, sid: str, config: Dict) -> None:
        epochs = int(config.get("epochs", 10))
        rng = np.random.default_rng(0)
        self._update(sid, status="running", total_epochs=epochs)
        best = 0.0
        for epoch in range(epochs):
            if self._stopped(sid):
                return
            time.sleep(float(config.get("epoch_seconds", 1.0)))
            dice = min(0.95, 0.3 + 0.012 * epoch
                       + float(rng.normal(0, 0.01)))
            best = max(best, dice)
            self._update(
                sid, current_epoch=epoch + 1,
                train_loss=round(max(0.05, 1.5 * np.exp(-0.08 * epoch)
                                     + float(rng.normal(0, 0.02))), 4),
                val_loss=round(max(0.07, 1.6 * np.exp(-0.07 * epoch)
                                   + float(rng.normal(0, 0.03))), 4),
                dice_score=round(dice, 4), best_dice=round(best, 4))
            self._log(sid, f"[demo] epoch {epoch + 1}/{epochs}")
        self._update(sid, status="completed")
        self._log(sid, "[demo] training complete")


# the module's manager and its functional facade (the reference's)
training_manager = TrainingJobManager()


def start_web_training(config: Optional[Dict] = None) -> str:
    return training_manager.start_training_session(config)


def stop_web_training(session_id: str) -> bool:
    return training_manager.stop_training_session(session_id)


def get_web_training_progress(session_id: str) -> Optional[Dict]:
    return training_manager.get_training_progress(session_id)
