"""Weight bridge: the JAX package's flax variables -> the port's
``state_dict``.

The port's modules carry the flax names (``down0.conv1.kernel``,
``head_bn.mean``) and layouts (DHWIO kernels), so the bridge only
flattens the tree; ``load_state_dict`` then checks every key and shape.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def load_unet3d_params(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """``{"params": tree, "batch_stats": tree}`` (nested dicts of
    numpy arrays, as ``UNet3D.init`` returns them converted to numpy)
    -> a state dict for the port's ``UNet3D`` (f32 CPU tensors).
    ``batch_stats`` may be absent."""
    state: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            key = f"{prefix}.{name}" if prefix else str(name)
            if isinstance(value, Mapping):
                walk(value, key)
            else:
                state[key] = torch.from_numpy(
                    np.array(value, dtype=np.float32))

    walk(variables["params"], "")
    walk(variables.get("batch_stats", {}), "")
    return state
