"""Configuration of the PyTorch port.

The model, data and inference settings of the JAX package's
``config.py``, with the same field names and defaults, so the two
packages are configured alike. Only the sections the port runs are
here; the loss, optimizer, augmentation and mesh sections come with the
slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


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
    checkpoint: str = ""


# classifier output names (JAX ``config.py`` ``CLASS_NAMES``)
CLASS_NAMES: Tuple[str, ...] = (
    "Background", "Necrotic Core", "Peritumoral Edema", "Enhancing Tumor",
)


@dataclass(frozen=True)
class Config:
    """Top-level config: the sections of the JAX ``Config`` the port runs."""

    name: str = "Config"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    seed: int = 42
