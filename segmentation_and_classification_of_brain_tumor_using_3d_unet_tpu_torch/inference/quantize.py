"""Post-training int8 quantization for serving, inference only (JAX
``inference/quantize.py``).

The DoubleConv 3x3x3 convs run ``ops/conv.py::conv3d_zcat_int8``: the
weights symmetric per output channel, quantized on the fly from the
unchanged f32 parameters; the activations symmetric per tensor with a
static per-conv scale calibrated here from sample volumes. The rest of
the model stays in its compute dtype.

Usage::

    qvars = calibrate_int8(model, variables, [vol1, vol2, ...])
    qmodel = model.with_quant_mode("int8")     # JAX model.clone(...)
    qmodel.load_state_dict(load_flax_params(qvars))
    logits = qmodel(x)

``variables`` may be ``None``: the model's own weights are calibrated.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..models.weights import load_flax_params, to_flax_variables

__all__ = ["calibrate_int8", "quant_scales_from_stats"]


def quant_scales_from_stats(stats: Mapping, margin: float = 1.0) -> Dict:
    """Per-conv ``absmax`` leaves -> ``act_scale`` leaves
    ``max(absmax * margin, 1e-6) / 127`` in f32 (numpy), the tree's
    ``absmax`` keys renamed ``act_scale``. ``margin`` > 1 widens the
    range past the observed maximum (coarser steps, no clipping); < 1
    narrows it (finer steps, the top of the range clipped)."""
    def walk(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {("act_scale" if k == "absmax" else k): walk(v)
                    for k, v in node.items()}
        a = torch.from_numpy(np.asarray(node, np.float32))
        return ((a * margin).clamp_min(1e-6) / 127.0).numpy()
    return walk(stats)


def calibrate_int8(model, variables: Optional[Mapping],
                   sample_volumes: Iterable, margin: float = 1.0) -> Dict:
    """Run the calibration forwards; return the variables of the int8
    model.

    model: a port ``UNet3D`` (its ``quant_mode`` is ignored: a "calib"
    view of it, ``with_quant_mode``, runs the forwards; its
    ``quant_blocks`` hold). variables: a flax-layout tree, loaded into the
    model through the weight bridge (as the data-parallel segmenters load
    theirs), or ``None`` for the model's own weights. sample_volumes: (D,
    H, W, C) or (B, D, H, W, C) arrays or tensors, preprocessed as
    inference preprocesses them.

    Returns the flax-layout tree (``variables``, or the model's weights)
    with the ``quant`` collection of per-conv ``act_scale`` leaves: the
    largest ``max|x|`` of each quantized conv's input over the volumes,
    through ``quant_scales_from_stats``. ``ValueError`` without a
    volume."""
    calib = model.with_quant_mode("calib")
    if variables is not None:
        state = {k: v for k, v in load_flax_params(variables).items()
                 if not k.endswith(".act_scale")}
        missing, unexpected = calib.load_state_dict(state, strict=False)
        left = [k for k in missing if not k.endswith(".act_scale")]
        if left or unexpected:
            raise ValueError(f"variables do not fit the model: missing "
                             f"{left}, unexpected {unexpected}")
    convs = [(name, c, getattr(block, c))
             for name, block in calib.double_convs()
             for c in ("conv1", "conv2")
             if getattr(block, c).quant_mode == "calib"]
    for _, _, conv in convs:
        conv.absmax.zero_()
    device = next(calib.parameters()).device
    seen = 0
    for vol in sample_volumes:
        x = torch.as_tensor(vol, device=device)
        calib(x[None] if x.ndim == 4 else x)
        seen += 1
    if not seen:
        raise ValueError("calibrate_int8 needs at least one sample volume")
    stats: Dict = {}
    for name, c, conv in convs:
        stats.setdefault(name, {})[c] = {
            "absmax": conv.absmax.float().cpu().numpy()}
    base = (dict(variables) if variables is not None
            else to_flax_variables(model.state_dict()))
    return {**base, "quant": quant_scales_from_stats(stats, margin)}
