from .unet3d import AttentionGate3D, DoubleConv3D, UNet3D  # noqa: F401
from .weights import load_unet3d_params  # noqa: F401
