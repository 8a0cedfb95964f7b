"""Configuration of the PyTorch port.

The JAX package's ``config.py`` with the same field names and defaults,
so the two packages are configured alike: the model, loss, optimizer,
augmentation, data, mesh and inference sections, the trainer's fields
and directories, ``to_dict`` / ``from_dict``, the presets and the BraTS
constants. ``MeshConfig`` is carried but not read yet (the port runs on
one device).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (JAX ``config.py`` ``ModelConfig``)."""

    in_channels: int = 4
    out_channels: int = 4
    features: Tuple[int, ...] = (32, 64, 128, 256, 512)
    dropout_rate: float = 0.2
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    # JAX's space-to-depth layout at level 0 (ops/s2d.py), which fills the
    # TPU's lanes and computes the same function: the port's model takes
    # both flags and runs the normal path for them
    s2d_eval: bool = False
    s2d_train: bool = False
    # level-0 region of the eval forward on the hand-written kernels
    # (ops/ps2d.py): enc0's conv2, the decoder-last stage's two convs,
    # its transposed conv and the relayouts between them
    ps2d_eval: bool = False
    # resolution levels in that region: 1 is level 0 only; 2 (or more)
    # adds the level-1 region (enc1, the level-1 skip, the dec1 stage)
    ps2d_levels: int = 1


@dataclass(frozen=True)
class LossConfig:
    """Loss weighting (JAX ``config.py`` ``LossConfig``)."""

    dice_weight: float = 0.5
    ce_weight: float = 0.3
    focal_weight: float = 0.2
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0
    # deep supervision weights, main output first
    deep_supervision_weights: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.4)
    use_deep_supervision: bool = True
    # False: deep losses at each head's native scale against
    # nearest-resized targets; True: heads resized to full resolution in
    # the model
    deep_supervision_full_res: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + cosine warm restarts (JAX ``config.py`` ``OptimizerConfig``)."""

    name: str = "adamw"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    scheduler: str = "cosine_warm_restarts"
    t_0: int = 10            # first restart period (epochs)
    t_mult: int = 2          # period multiplier
    eta_min: float = 1e-6
    grad_clip_norm: float = 0.0   # 0 = off


@dataclass(frozen=True)
class AugmentConfig:
    """Volumetric augmentation (JAX ``config.py`` ``AugmentConfig``)."""

    enabled: bool = True
    rot90_prob: float = 0.5
    flip_prob: float = 0.5
    noise_prob: float = 0.3
    noise_sigma_max: float = 0.1
    intensity_prob: float = 0.5
    intensity_range: Tuple[float, float] = (0.9, 1.1)
    # gamma curve x -> x^gamma on a per-volume min/max-normalised copy
    gamma_prob: float = 0.15
    gamma_range: Tuple[float, float] = (0.7, 1.5)


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline (JAX ``config.py`` ``DataConfig``)."""

    image_size: Tuple[int, int, int] = (128, 128, 128)
    num_workers: int = 4
    cache_rate: float = 0.5
    clip_percentiles: Tuple[float, float] = (1.0, 99.0)
    modalities: Tuple[str, ...] = ("t1c", "t1n", "t2f", "t2w")
    prefetch_depth: int = 2


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh (JAX ``config.py`` ``MeshConfig``); the port runs on
    one device and reads none of it yet."""

    # -1 = every available device on that axis
    data: int = -1
    space: int = 1
    axis_names: Tuple[str, str] = ("data", "space")


@dataclass(frozen=True)
class InferenceConfig:
    """Sliding-window inference (JAX ``config.py`` ``InferenceConfig``)."""

    roi_size: Tuple[int, int, int] = (128, 128, 128)
    overlap: float = 0.5
    sw_batch_size: int = 4
    blend_mode: str = "gaussian"     # "gaussian" | "constant"
    gaussian_sigma_scale: float = 0.125
    upload_mode: str = "cropped"
    tta: bool = False
    window_parallel: bool = False
    crop_bucket_ladder: Tuple[int, ...] = (96, 128, 160, 192, 224, 256)
    warmup: str = "full"
    # trained weights for serving: a trainer checkpoint directory or a
    # params-only export; "" = the newest compatible ``best_*`` under
    # ``models_dir``; "none" = the seeded weights
    checkpoint: str = ""


# BraTS modality order of a stacked volume (JAX ``BRATS_MODALITIES``)
BRATS_MODALITIES: Tuple[str, ...] = ("t1c", "t1n", "t2f", "t2w")

# raw BraTS labels on disk (enhancing tumour is 4) and the training
# remap 4 -> 3 (JAX ``BRATS_LABELS``, ``BRATS_LABEL_REMAP``)
BRATS_LABELS: Dict[int, str] = {
    0: "Background",
    1: "Necrotic Core",
    2: "Peritumoral Edema",
    4: "Enhancing Tumor",
}
BRATS_LABEL_REMAP: Dict[int, int] = {0: 0, 1: 1, 2: 2, 4: 3}

# classifier output names (JAX ``config.py`` ``CLASS_NAMES``)
CLASS_NAMES: Tuple[str, ...] = (
    "Background", "Necrotic Core", "Peritumoral Edema", "Enhancing Tumor",
)

# composite BraTS regions over the remapped labels (JAX ``BRATS_REGIONS``)
BRATS_REGIONS: Dict[str, Tuple[int, ...]] = {
    "WT": (1, 2, 3),   # whole tumour
    "TC": (1, 3),      # tumour core
    "ET": (3,),        # enhancing tumour
}

# display colours per class (JAX ``BRATS_COLORS``)
BRATS_COLORS: Dict[int, str] = {
    0: "#000000",
    1: "#e74c3c",
    2: "#f1c40f",
    3: "#3498db",
}


@dataclass(frozen=True)
class Config:
    """Top-level config (JAX ``Config``)."""

    name: str = "Config"
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    # training loop
    epochs: int = 100
    batch_size: int = 2
    # microbatches averaged per optimizer update (train/loop.py); 1 = off
    grad_accum: int = 1
    # parameter EMA (ema = d * ema + (1 - d) * params) after each
    # update; 0 = off
    ema_decay: float = 0.0
    early_stopping_patience: int = 20
    # validate every Nth epoch (the last epoch always validates)
    val_interval: int = 1
    seed: int = 42

    # directories (JAX ``Config``): the synthetic-data route writes
    # under ``data_dir``, the trainer's checkpoints go under
    # ``models_dir`` and its reports under ``results_dir``
    data_dir: str = "data"
    results_dir: str = "results"
    models_dir: str = "results/models"
    logs_dir: str = "logs"
    checkpoints_dir: str = "checkpoints"

    # experiment tracking, both optional
    use_wandb: bool = False
    use_tensorboard: bool = True
    experiment_name: str = "brain_tumor_segmentation"

    # metric names tracked per epoch
    tracked_metrics: Tuple[str, ...] = (
        "train_loss", "val_loss", "train_dice", "val_dice",
        "val_hausdorff", "learning_rate",
    )

    def create_directories(self) -> None:
        for d in (self.data_dir, self.results_dir, self.models_dir,
                  self.logs_dir, self.checkpoints_dir):
            os.makedirs(d, exist_ok=True)

    def print_config(self) -> str:
        text = json.dumps(self.to_dict(), indent=2, default=str)
        print(text)
        return text

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        """Inverse of ``to_dict`` (lists, as JSON gives them, become
        tuples)."""
        sub = {
            "model": ModelConfig, "loss": LossConfig,
            "optimizer": OptimizerConfig, "augment": AugmentConfig,
            "data": DataConfig, "mesh": MeshConfig,
            "inference": InferenceConfig,
        }
        kw: Dict[str, Any] = {}
        for k, v in d.items():
            if k in sub and isinstance(v, Mapping):
                kw[k] = sub[k](**{fk: tuple(fv) if isinstance(fv, list)
                                  else fv for fk, fv in v.items()})
            elif isinstance(v, list):
                kw[k] = tuple(v)
            else:
                kw[k] = v
        return cls(**kw)


# presets (JAX ``config.py`` ``FastTrainingConfig`` .. ``get_config``)

def FastTrainingConfig() -> Config:
    """64^3 volumes, 20 epochs, batch 4."""
    base = Config()
    return base.replace(
        name="FastTrainingConfig", epochs=20, batch_size=4,
        data=dataclasses.replace(base.data, image_size=(64, 64, 64)),
        inference=dataclasses.replace(base.inference, roi_size=(64, 64, 64)))


def HighQualityConfig() -> Config:
    """(192, 192, 128), features up to 1024, 200 epochs, batch 1."""
    base = Config()
    return base.replace(
        name="HighQualityConfig", epochs=200, batch_size=1,
        data=dataclasses.replace(base.data, image_size=(192, 192, 128)),
        model=dataclasses.replace(base.model,
                                  features=(64, 128, 256, 512, 1024)))


def LightweightConfig() -> Config:
    """96^3, features 16 .. 256."""
    base = Config()
    return base.replace(
        name="LightweightConfig",
        data=dataclasses.replace(base.data, image_size=(96, 96, 96)),
        model=dataclasses.replace(base.model,
                                  features=(16, 32, 64, 128, 256)),
        inference=dataclasses.replace(base.inference, roi_size=(96, 96, 96)))


def ProductionConfig() -> Config:
    """Re-weighted losses, early-stopping patience 30."""
    base = Config()
    return base.replace(
        name="ProductionConfig",
        loss=dataclasses.replace(base.loss, dice_weight=0.6, ce_weight=0.2,
                                 focal_weight=0.2),
        early_stopping_patience=30)


PRESETS = {
    "standard": Config,
    "fast": FastTrainingConfig,
    "high_quality": HighQualityConfig,
    "lightweight": LightweightConfig,
    "production": ProductionConfig,
}


def get_config(name: str = "standard") -> Config:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; choose from "
                       f"{sorted(PRESETS)}") from None
