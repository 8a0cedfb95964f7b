"""Weight bridge: the JAX package's flax variables -> the port's
``state_dict``.

The port's modules carry the flax names (``down0.conv1.kernel``,
``head_bn.mean``, ``unet.down0.conv1.kernel``) and the flax layouts of
conv kernels (DHWIO), so the bridge flattens the tree; the one change
of layout is a Dense kernel (in, out), which becomes the port's
``Dense.weight`` (out, in), transposed. ``load_state_dict`` then checks
every key and shape. ``to_flax_variables`` is the inverse: a port
model's weights as the JAX model's variable tree. JAX's ``quant``
collection of int8 serving (``quant/down0/conv1/act_scale``) is the
quantized convs' ``act_scale`` buffers (``down0.conv1.act_scale``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch


def load_flax_params(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """``{"params": tree, "batch_stats": tree}`` (nested dicts of
    numpy arrays, as a flax ``init`` returns them converted to numpy)
    -> a state dict (f32 CPU tensors) for the port's counterpart of
    the model: ``UNet3D``, ``BrainTumorClassifier`` or
    ``UNet3DWithClassifier``. ``batch_stats`` may be absent; a ``quant``
    collection (``calibrate_int8``'s) becomes the ``act_scale`` keys of a
    model with a ``quant_mode``."""
    state: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            key = f"{prefix}.{name}" if prefix else str(name)
            if isinstance(value, Mapping):
                walk(value, key)
                continue
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            if name == "kernel" and t.ndim == 2:      # a Dense layer
                key, t = f"{prefix}.weight", t.t().contiguous()
            state[key] = t

    walk(variables["params"], "")
    walk(variables.get("batch_stats") or {}, "")
    walk(variables.get("quant") or {}, "")
    return state


def to_flax_variables(state: Mapping[str, torch.Tensor]) -> Dict:
    """A port model's ``state_dict`` -> ``{"params": tree,
    "batch_stats": tree}`` of numpy arrays, the JAX model's variables
    (running BatchNorm statistics under ``batch_stats``, the int8 convs'
    ``act_scale`` under ``quant`` where there are any, Dense weights
    transposed back to flax's (in, out) kernels). The arrays are copies:
    a CPU tensor's ``numpy()`` shares its memory, and an optimizer step
    that updates the model in place would otherwise rewrite them, even
    while JAX still reads them (``jnp.asarray`` need not copy)."""
    tree: Dict = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        parts = key.split(".")
        top = ("batch_stats" if parts[-1] in ("mean", "var") else
               "quant" if parts[-1] == "act_scale" else "params")
        v = value.detach().float().cpu().numpy().copy()
        if parts[-1] == "weight":
            parts[-1], v = "kernel", v.T.copy()
        node = tree.setdefault(top, {})
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
