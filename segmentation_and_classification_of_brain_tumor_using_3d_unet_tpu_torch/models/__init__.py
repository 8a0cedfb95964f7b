from .classifier import BrainTumorClassifier  # noqa: F401
from .joint import UNet3DWithClassifier  # noqa: F401
from .unet3d import AttentionGate3D, DoubleConv3D, UNet3D  # noqa: F401
from .weights import load_flax_params, to_flax_variables  # noqa: F401
