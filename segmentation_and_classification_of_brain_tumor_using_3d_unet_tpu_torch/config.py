"""Configuration of the PyTorch port.

The model, data, inference, loss and optimizer settings of the JAX
package's ``config.py``, its data and model directories and its BraTS
constants, with the same field names and defaults, so the two packages
are configured alike. Only the sections the port runs are here; the
augmentation and mesh sections come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple


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
class DataConfig:
    """Data pipeline (JAX ``config.py`` ``DataConfig``)."""

    image_size: Tuple[int, int, int] = (128, 128, 128)
    num_workers: int = 4
    cache_rate: float = 0.5
    clip_percentiles: Tuple[float, float] = (1.0, 99.0)
    modalities: Tuple[str, ...] = ("t1c", "t1n", "t2f", "t2w")
    prefetch_depth: int = 2


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
    # trained weights for serving; the port has no checkpoint format
    # yet, so only "" and "none" (seeded weights) are served
    checkpoint: str = ""


# BraTS modality order of a stacked volume (JAX ``BRATS_MODALITIES``)
BRATS_MODALITIES: Tuple[str, ...] = ("t1c", "t1n", "t2f", "t2w")

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
    """Top-level config: the sections of the JAX ``Config`` the port runs."""

    name: str = "Config"
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    # training loop
    epochs: int = 100
    batch_size: int = 2
    # microbatches averaged per optimizer update (train/loop.py); 1 = off
    grad_accum: int = 1
    # parameter EMA (ema = d * ema + (1 - d) * params) after each
    # update; 0 = off
    ema_decay: float = 0.0
    seed: int = 42

    # directories (JAX ``Config``): the synthetic-data route writes
    # under ``data_dir``; trained checkpoints belong under ``models_dir``
    data_dir: str = "data"
    models_dir: str = "results/models"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
