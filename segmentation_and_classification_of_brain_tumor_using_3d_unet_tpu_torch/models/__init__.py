from .classifier import BrainTumorClassifier  # noqa: F401
from .joint import (UNet3DWithClassifier, grade_from_volume,  # noqa: F401
                    joint_loss)
from .unet3d import (AttentionGate3D, DoubleConv3D, GroupNorm,  # noqa: F401
                     UNet3D)
from .weights import load_flax_params, to_flax_variables  # noqa: F401
