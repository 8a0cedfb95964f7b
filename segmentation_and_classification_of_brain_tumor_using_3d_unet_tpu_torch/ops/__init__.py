"""The port's op library (counterpart of the JAX package's ``ops/``):
convolutions, pooling, the norms, resizes, the exact EDT and the
statistics; the kernels' wrappers live in ``ops/ps2d.py``,
``ops/groupnorm.py`` and ``ops/conv3d.py``."""

from .edt import edt_squared, hausdorff_distance_device
from .conv import (Conv1x1, FastConv3D, FastConvTranspose3D, conv1x1,
                   conv3d_3x3x3, conv3d_ksplit, conv3d_zsum, conv3d_zcat,
                   conv_transpose3d_k2s2)
from .norm import group_norm, batch_norm_infer
from .resize import resize_trilinear, resize_nearest, adaptive_avg_pool
from .pool import max_pool3d, global_avg_pool
from .stats import (percentile, percentile_bisect, percentile_clip,
                    zscore_normalize)

__all__ = [
    "Conv1x1", "FastConv3D", "FastConvTranspose3D", "conv1x1",
    "conv3d_3x3x3", "conv3d_ksplit", "conv3d_zsum", "conv3d_zcat",
    "conv_transpose3d_k2s2",
    "group_norm", "batch_norm_infer",
    "resize_trilinear", "resize_nearest", "adaptive_avg_pool",
    "max_pool3d", "global_avg_pool",
    "edt_squared", "hausdorff_distance_device",
    "percentile", "percentile_bisect", "percentile_clip",
    "zscore_normalize",
]
