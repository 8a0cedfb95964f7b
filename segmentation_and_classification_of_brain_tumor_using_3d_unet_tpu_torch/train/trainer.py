"""ModernBrainTumorTrainer — the training runtime (counterpart of the JAX
package's ``train/trainer.py``).

The same surface: ``train`` / ``train_epoch`` / ``validate_epoch``, the
metric shims, ``save_model``, ``log_metrics`` and
``generate_training_report``; the metrics-history dict, early stopping,
save-on-best of the validation Dice, ``val_interval``,
``save_latest_every`` and TensorBoard / wandb sinks (both optional).

  * Each step is ``loop.make_train_step``'s (forward, deep-supervision
    loss, backward, AdamW, Dice on the device). An epoch's loss and Dice
    sums stay on the device, and the host reads them once per epoch: no
    step waits on the host.
  * Validation scores the EMA weights when they are tracked, with HD95
    (the exact EDT on the device, ``ops/edt.py``) every
    ``hausdorff_every`` epochs and the WT / TC / ET region Dice.
  * The dropout masks draw from a ``torch.Generator`` on the model's
    device seeded with ``config.seed``; the model is built by the caller
    (the CLI seeds it with ``config.seed`` too).
  * ``timing`` records, per train step, the host seconds the step took
    to enqueue and the seconds the loop waited on the loader.
  * With a ``mesh`` (one process per device), the steps are the
    sharded ones of ``loop``, the loaders give each rank its rows (and,
    when the ``space`` axis is longer than 1, its D slab of them), every
    rank reads the same global metrics and so takes the same decisions,
    and only the first rank writes checkpoints, TensorBoard, wandb and
    the report. Every rank loads for ``resume``. The dropout masks of
    the ranks at data coordinate i draw from ``config.seed + i``: the
    slabs of one sample share its (sample, channel) mask.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..metrics import hausdorff_distance, mean_foreground_dice
from ..parallel.mesh import all_gather, is_primary
from . import checkpoints
from .loop import make_eval_step, make_train_step
from .state import (TrainState, create_train_state, current_lr,
                    ema_eval_state)

logger = logging.getLogger(__name__)


class ModernBrainTumorTrainer:
    """The trainer of a built model (``UNet3D`` or
    ``UNet3DWithClassifier``'s trunk) on its device. ``device``, when
    given, must be the model's; ``mesh``: a (data, space) mesh
    (``parallel.mesh.create_mesh``); on a ``space`` axis longer than 1
    the model runs its slab forward, its ps2d regions included."""

    def __init__(self, model, device=None, learning_rate: float = 1e-4,
                 experiment_name: Optional[str] = None,
                 config: Optional[Config] = None,
                 mesh=None, use_wandb: Optional[bool] = None,
                 hausdorff_every: int = 1,
                 save_latest_every: int = 0):
        self.mesh = mesh
        self.primary = is_primary()
        self.model = model
        self.device = next(model.parameters()).device
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != self.device.type or (
                want.index is not None and want.index != self.device.index)):
            raise ValueError(f"the model is on {self.device}, not on "
                             f"{device}")
        self.learning_rate = learning_rate
        self.config = config or Config()
        self.experiment_name = experiment_name or (
            f"brain_tumor_{time.strftime('%Y%m%d_%H%M%S')}")
        self.hausdorff_every = hausdorff_every
        # save-on-best alone loses every epoch after the last
        # improvement when a run is killed: also checkpoint the current
        # state to latest_<experiment> every N epochs
        self.save_latest_every = save_latest_every

        self.state: Optional[TrainState] = None
        self._train_step = None
        self._eval_step = None
        self._eval_step_hd = None
        self._steps_per_epoch = 1
        row = 0 if mesh is None else mesh.index("data")
        self._generator = torch.Generator(
            device=self.device).manual_seed(self.config.seed + row)

        self.best_dice = 0.0
        self.start_epoch = 0
        self.patience = self.config.early_stopping_patience
        self.patience_counter = 0
        self.metrics_history: Dict[str, list] = {
            "train_loss": [], "val_loss": [], "train_dice": [],
            "val_dice": [], "val_hausdorff": [], "learning_rates": [],
        }
        self.timing: Dict[str, list] = {"step_s": [], "loader_wait_s": [],
                                        "val_epoch_s": []}
        self._pending_resume: Optional[str] = None
        self._resumed_from: Optional[str] = None
        self._saved_any = False
        self._guarded_paths: set = set()
        self._setup_tracking(
            (self.config.use_wandb if use_wandb is None else use_wandb)
            and self.primary)

    # ------------------------------------------------------------------
    # experiment tracking (both optional)
    # ------------------------------------------------------------------

    def _setup_tracking(self, use_wandb: bool) -> None:
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                wandb.init(project="brain-tumor-segmentation",
                           name=self.experiment_name,
                           config=self.config.to_dict())
                self.wandb = wandb
            except Exception as e:
                logger.warning("wandb unavailable: %s", e)
        self.writer = None
        if self.config.use_tensorboard and self.primary:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(
                    os.path.join(self.config.results_dir, "runs",
                                 self.experiment_name))
            except Exception as e:
                logger.warning("tensorboard unavailable: %s", e)

    # ------------------------------------------------------------------
    # the state and the steps, built from the first batch
    # ------------------------------------------------------------------

    def _ensure_state(self, steps_per_epoch: int) -> None:
        if self.state is not None:
            return
        self._steps_per_epoch = max(steps_per_epoch, 1)
        self.state = create_train_state(
            self.model, self.config, self._steps_per_epoch,
            self.learning_rate)
        n = batch_num_classes(self.model)
        self._train_step = make_train_step(self.config, num_classes=n,
                                           mesh=self.mesh)
        self._eval_step = make_eval_step(self.config, num_classes=n,
                                         mesh=self.mesh)
        self._eval_step_hd = make_eval_step(self.config, num_classes=n,
                                            with_hausdorff=True,
                                            mesh=self.mesh)
        if self._pending_resume:
            self.state, meta = checkpoints.restore_checkpoint(
                self._pending_resume, self.state)
            self.best_dice = meta.get("best_dice", 0.0)
            self.start_epoch = meta.get("epoch", 0)
            for k, v in (meta.get("metrics_history") or {}).items():
                self.metrics_history[k] = list(v)
            logger.info("resumed from %s (epoch %d, best dice %.4f)",
                        self._pending_resume, self.start_epoch,
                        self.best_dice)
            self._pending_resume = None

    def load_checkpoint(self, path: str) -> None:
        """Queue a resume, applied when the state is first built."""
        self._pending_resume = path
        self._resumed_from = os.path.abspath(path)

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------

    def _batches(self, loader: Iterable):
        """``loader``'s batches, the host seconds waited on each recorded."""
        it = iter(loader)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.timing["loader_wait_s"].append(time.perf_counter() - t)
            yield batch

    def train_epoch(self, train_loader: Iterable, epoch: int
                    ) -> Dict[str, float]:
        n_steps = len(train_loader) if hasattr(train_loader,
                                               "__len__") else 1
        loss_sum = dice_sum = None
        n = 0
        for batch in self._batches(train_loader):
            self._ensure_state(n_steps)
            t = time.perf_counter()
            self.state, m = self._train_step(self.state, batch,
                                             self._generator)
            loss_sum = m["loss"] if loss_sum is None else loss_sum + m["loss"]
            dice_sum = m["dice"] if dice_sum is None else dice_sum + m["dice"]
            self.timing["step_s"].append(time.perf_counter() - t)
            n += 1
        if not n:
            return {"loss": 0.0, "dice": 0.0}
        # the epoch's one read of the device
        sums = torch.stack([loss_sum, dice_sum]).cpu().tolist()
        return {"loss": sums[0] / n, "dice": sums[1] / n}

    def validate_epoch(self, val_loader: Iterable, epoch: int = 0
                       ) -> Dict[str, float]:
        """Loss, Dice, WT / TC / ET region Dice and, every
        ``hausdorff_every`` epochs, HD95 over every validation sample, all
        on the device; one read of the device at the end."""
        t0 = time.perf_counter()
        compute_hd = (self.hausdorff_every > 0
                      and epoch % max(self.hausdorff_every, 1) == 0)
        names = ("loss", "dice", "dice_WT", "dice_TC", "dice_ET")
        sums, hds, n = None, [], 0
        n_batches = len(val_loader) if hasattr(val_loader, "__len__") else 1
        eval_state = None
        for batch in val_loader:
            self._ensure_state(n_batches)
            if eval_state is None:
                # the EMA weights, when tracked, are what validation
                # scores, save-on-best keeps and serving adopts
                eval_state = ema_eval_state(self.state)
            step = self._eval_step_hd if compute_hd else self._eval_step
            m = step(eval_state, batch)
            vals = torch.stack([m[k].float() for k in names])
            sums = vals if sums is None else sums + vals
            if compute_hd:
                hds.append(m["hausdorff"].float())
            n += 1
        if not n:
            return {"loss": 0.0, "dice": 0.0, "hausdorff": float("nan"),
                    "dice_WT": 0.0, "dice_TC": 0.0, "dice_ET": 0.0}
        means = (sums / n).cpu().tolist()
        out = dict(zip(names, means))
        hd_out = float("nan")
        if hds:
            hd_all = torch.cat(hds)
            if self.mesh is not None:
                # every rank's samples, as JAX reads its sharded output
                hd_all = torch.cat(all_gather(hd_all,
                                              self.mesh.group("data")))
            hd_all = hd_all.cpu().numpy()
            fin = hd_all[np.isfinite(hd_all)]
            hd_out = float(fin.mean()) if fin.size else float("nan")
        out["hausdorff"] = hd_out
        self.timing["val_epoch_s"].append(time.perf_counter() - t0)
        return out

    def train(self, train_loader: Iterable, val_loader: Iterable,
              num_epochs: int = 100) -> Dict[str, list]:
        """Epochs with validation, save-on-best, early stopping and the
        report at the end."""
        logger.info("training %s for %d epochs", self.experiment_name,
                    num_epochs)
        if self._pending_resume and self.state is None:
            # apply the resume now, so the epochs start where the
            # checkpoint left off
            self._ensure_state(len(train_loader)
                               if hasattr(train_loader, "__len__") else 1)
        no_val = (hasattr(val_loader, "__len__") and len(val_loader) == 0)
        if no_val:
            logger.warning(
                "validation split is EMPTY: val dice stays 0.0, so "
                "save-on-best and early stopping are off for this run "
                "(the final weights are saved at the end)")
        val_every = max(1, int(getattr(self.config, "val_interval", 1)))
        last_val = {"loss": 0.0, "dice": 0.0, "hausdorff": 0.0}
        for epoch in range(self.start_epoch, num_epochs):
            t0 = time.time()
            train_m = self.train_epoch(train_loader, epoch)
            # every val_interval-th epoch and the last; skipped epochs
            # repeat the last scores, one history entry per epoch
            if epoch % val_every == 0 or epoch == num_epochs - 1:
                val_m = self.validate_epoch(val_loader, epoch)
                last_val = val_m
            else:
                val_m = last_val
            lr = current_lr(self.state, self.config.optimizer,
                            self._steps_per_epoch, self.learning_rate)
            h = self.metrics_history
            h["train_loss"].append(train_m["loss"])
            h["train_dice"].append(train_m["dice"])
            h["val_loss"].append(val_m["loss"])
            h["val_dice"].append(val_m["dice"])
            h["val_hausdorff"].append(val_m["hausdorff"])
            h["learning_rates"].append(lr)
            for region in ("WT", "TC", "ET"):
                h.setdefault(f"val_dice_{region}", []).append(
                    val_m.get(f"dice_{region}", 0.0))
            self.log_metrics(train_m, val_m, epoch, lr)
            logger.info(
                "epoch %d/%d  train loss %.4f dice %.4f | "
                "val loss %.4f dice %.4f hd95 %.2f | lr %.2e | %.1fs",
                epoch + 1, num_epochs, train_m["loss"], train_m["dice"],
                val_m["loss"], val_m["dice"], val_m["hausdorff"], lr,
                time.time() - t0)

            if val_m["dice"] > self.best_dice:
                self.best_dice = val_m["dice"]
                self.patience_counter = 0
                self.save_model(epoch)
                self._saved_any = True
            elif not no_val:
                self.patience_counter += 1
                if self.patience_counter >= self.patience:
                    logger.info("early stopping at epoch %d", epoch + 1)
                    break
            if (self.save_latest_every
                    and (epoch + 1) % self.save_latest_every == 0):
                self.save_model(epoch + 1, path=self._latest_path())
        if self.state is not None and not self._saved_any:
            # e.g. an empty validation split: keep the final weights
            self.save_model(num_epochs - 1)
        self.generate_training_report()
        return self.metrics_history

    # ------------------------------------------------------------------
    # metric shims
    # ------------------------------------------------------------------

    def calculate_dice_score(self, outputs, targets) -> float:
        return float(mean_foreground_dice(torch.as_tensor(outputs),
                                          torch.as_tensor(targets)))

    def calculate_hausdorff_distance(self, outputs, targets) -> float:
        out = np.asarray(outputs)
        if out.ndim == np.asarray(targets).ndim + 1:
            out = np.argmax(out, axis=-1)
        return hausdorff_distance(out > 0, np.asarray(targets) > 0)

    # ------------------------------------------------------------------
    # persistence, logging, report
    # ------------------------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.config.models_dir,
                            f"best_{self.experiment_name}")

    def _latest_path(self) -> str:
        return os.path.join(self.config.models_dir,
                            f"latest_{self.experiment_name}")

    def save_model(self, epoch: int = 0, path: Optional[str] = None) -> str:
        path = path or self._ckpt_path()
        if not self.primary:
            return path
        # the first save of this run at a path archives what an earlier
        # run left there (a resume continuing that checkpoint excepted)
        key = os.path.abspath(path)
        if key not in self._guarded_paths:
            self._guarded_paths.add(key)
            if key != (self._resumed_from or ""):
                archived = checkpoints.archive_existing(path)
                if archived:
                    logger.info("experiment-name collision: previous "
                                "checkpoint archived to %s", archived)
        os.makedirs(path, exist_ok=True)
        return checkpoints.save_checkpoint(
            path, self.state, self.best_dice, epoch, self.metrics_history)

    def log_metrics(self, train_m: Dict[str, float],
                    val_m: Dict[str, float], epoch: int,
                    lr: float) -> None:
        if self.writer is not None:
            self.writer.add_scalar("Loss/Train", train_m["loss"], epoch)
            self.writer.add_scalar("Loss/Val", val_m["loss"], epoch)
            self.writer.add_scalar("Dice/Train", train_m["dice"], epoch)
            self.writer.add_scalar("Dice/Val", val_m["dice"], epoch)
            self.writer.add_scalar("LR", lr, epoch)
        if self.wandb is not None:
            self.wandb.log({
                "epoch": epoch, "train_loss": train_m["loss"],
                "val_loss": val_m["loss"], "train_dice": train_m["dice"],
                "val_dice": val_m["dice"], "learning_rate": lr,
            })

    def generate_training_report(self) -> Optional[str]:
        """The JSON summary and, where matplotlib is installed, the
        dashboards (PNG and HTML); without it the JSON alone."""
        if not self.metrics_history["train_loss"] or not self.primary:
            return None
        out_dir = os.path.join(self.config.results_dir, "reports")
        os.makedirs(out_dir, exist_ok=True)
        summary = {
            "experiment": self.experiment_name,
            "epochs_trained": len(self.metrics_history["train_loss"]),
            "best_val_dice": self.best_dice,
            "final_train_loss": self.metrics_history["train_loss"][-1],
            "metrics_history": self.metrics_history,
        }
        json_path = os.path.join(out_dir,
                                 f"{self.experiment_name}_report.json")
        with open(json_path, "w") as f:
            json.dump(summary, f, indent=2)
        try:
            from ..utils.visualization import (
                create_training_dashboard, create_training_dashboard_html)
            create_training_dashboard(
                self.metrics_history,
                os.path.join(out_dir,
                             f"{self.experiment_name}_dashboard.png"))
            create_training_dashboard_html(
                self.metrics_history,
                os.path.join(out_dir,
                             f"{self.experiment_name}_dashboard.html"))
        except Exception as e:
            logger.warning("dashboard generation failed: %s", e)
        return json_path


def batch_num_classes(model) -> int:
    """The model's segmentation classes (its ``out_channels``, 4 when it
    has none)."""
    return getattr(model, "out_channels", 4)
