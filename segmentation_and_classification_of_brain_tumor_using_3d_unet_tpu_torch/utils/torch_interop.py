"""Weight interop with the reference's PyTorch checkpoints (counterpart of
the JAX package's ``utils/torch_interop.py``).

Maps between the flax-layout parameter tree of ``UNet3D`` /
``BrainTumorClassifier`` (what the port's weight bridge,
``models/weights.py``, reads and writes) and the reference's
``state_dict`` layout (module structure per ``main.py:102-328``):

  downs.{i}.double_conv.{0,1,3,4} / residual.{0,1}   <-> down{i}.*
  bottleneck.*                                       <-> bottleneck.*
  ups.{3i}   (ConvTranspose3d)                       <-> up{i}.*
  ups.{3i+1} (AttentionGate3D: W_g/W_x/psi/SE)       <-> att{i}.*
  ups.{3i+2} (DoubleConv3D)                          <-> dec{i}.*
  final_conv.{0,1,3}                                 <-> head_conv/bn/out
  deep_supervision.{i}                               <-> deep{i}.*

Tensor layout transforms (numpy):
  Conv3d weight  (O, I, kd, kh, kw) <-> flax kernel (kd, kh, kw, I, O)
  ConvTranspose3d weight (I, O, kd, kh, kw) <-> flax kernel flipped
  spatially (flax conv_transpose applies the kernel mirrored).

A reference user's trained ``.pth`` thus loads into the port's
``UNet3D`` (``load_torch_checkpoint(..., model=unet)``), and the port's
weights export back (``save_torch_checkpoint`` of
``to_flax_variables(unet.state_dict())``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..models.weights import load_flax_params


def _conv_t2f(w: np.ndarray) -> np.ndarray:
    """torch Conv3d (O,I,kd,kh,kw) -> flax (kd,kh,kw,I,O)."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def _conv_f2t(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (4, 3, 0, 1, 2))


def _convT_t2f(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose3d (I,O,kd,kh,kw) -> flax (kd,kh,kw,I,O),
    spatially flipped (torch applies taps unflipped; flax mirrored)."""
    k = np.transpose(w, (2, 3, 4, 0, 1))
    return k[::-1, ::-1, ::-1].copy()


def _convT_f2t(k: np.ndarray) -> np.ndarray:
    return np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)).copy()


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _double_conv_from_torch(sd: Mapping, prefix: str, in_ch: int,
                            out_ch: int) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "conv1": {"kernel": _conv_t2f(_np(sd[f"{prefix}.double_conv.0.weight"]))},
        "gn1": {"scale": _np(sd[f"{prefix}.double_conv.1.weight"]),
                "bias": _np(sd[f"{prefix}.double_conv.1.bias"])},
        "conv2": {"kernel": _conv_t2f(_np(sd[f"{prefix}.double_conv.3.weight"]))},
        "gn2": {"scale": _np(sd[f"{prefix}.double_conv.4.weight"]),
                "bias": _np(sd[f"{prefix}.double_conv.4.bias"])},
    }
    if in_ch != out_ch:
        p["proj"] = {"kernel": _conv_t2f(_np(sd[f"{prefix}.residual.0.weight"]))}
        p["gn_proj"] = {"scale": _np(sd[f"{prefix}.residual.1.weight"]),
                        "bias": _np(sd[f"{prefix}.residual.1.bias"])}
    return p


def _double_conv_to_torch(p: Mapping, prefix: str, out: Dict) -> None:
    out[f"{prefix}.double_conv.0.weight"] = _conv_f2t(_np(p["conv1"]["kernel"]))
    out[f"{prefix}.double_conv.1.weight"] = _np(p["gn1"]["scale"])
    out[f"{prefix}.double_conv.1.bias"] = _np(p["gn1"]["bias"])
    out[f"{prefix}.double_conv.3.weight"] = _conv_f2t(_np(p["conv2"]["kernel"]))
    out[f"{prefix}.double_conv.4.weight"] = _np(p["gn2"]["scale"])
    out[f"{prefix}.double_conv.4.bias"] = _np(p["gn2"]["bias"])
    if "proj" in p:
        out[f"{prefix}.residual.0.weight"] = _conv_f2t(_np(p["proj"]["kernel"]))
        out[f"{prefix}.residual.1.weight"] = _np(p["gn_proj"]["scale"])
        out[f"{prefix}.residual.1.bias"] = _np(p["gn_proj"]["bias"])


def _att_from_torch(sd: Mapping, prefix: str) -> Dict[str, Any]:
    def conv(name):
        return {"kernel": _conv_t2f(_np(sd[f"{prefix}.{name}.weight"])),
                "bias": _np(sd[f"{prefix}.{name}.bias"])}

    def gn(name):
        return {"scale": _np(sd[f"{prefix}.{name}.weight"]),
                "bias": _np(sd[f"{prefix}.{name}.bias"])}

    return {
        "w_g": conv("W_g.0"), "gn_g": gn("W_g.1"),
        "w_x": conv("W_x.0"), "gn_x": gn("W_x.1"),
        "psi": conv("psi.0"), "gn_psi": gn("psi.1"),
        "se_down": conv("channel_attention.1"),
        "se_up": conv("channel_attention.3"),
    }


def _att_to_torch(p: Mapping, prefix: str, out: Dict) -> None:
    pairs = [("w_g", "W_g.0"), ("w_x", "W_x.0"), ("psi", "psi.0"),
             ("se_down", "channel_attention.1"),
             ("se_up", "channel_attention.3")]
    for fk, tk in pairs:
        out[f"{prefix}.{tk}.weight"] = _conv_f2t(_np(p[fk]["kernel"]))
        out[f"{prefix}.{tk}.bias"] = _np(p[fk]["bias"])
    for fk, tk in [("gn_g", "W_g.1"), ("gn_x", "W_x.1"),
                   ("gn_psi", "psi.1")]:
        out[f"{prefix}.{tk}.weight"] = _np(p[fk]["scale"])
        out[f"{prefix}.{tk}.bias"] = _np(p[fk]["bias"])


def import_unet3d_from_torch(state_dict: Mapping,
                             in_channels: int = 4,
                             features: Sequence[int] = (32, 64, 128,
                                                        256, 512)
                             ) -> Tuple[Dict, Dict]:
    """Reference ``UNet3D.state_dict()`` -> (params, batch_stats)."""
    sd = state_dict
    feats = tuple(features)
    params: Dict[str, Any] = {}
    cin = in_channels
    for i, f in enumerate(feats):
        params[f"down{i}"] = _double_conv_from_torch(
            sd, f"downs.{i}", cin, f)
        cin = f
    params["bottleneck"] = _double_conv_from_torch(
        sd, "bottleneck", feats[-1], feats[-1] * 2)
    for i, f in enumerate(reversed(feats)):
        params[f"up{i}"] = {
            "kernel": _convT_t2f(_np(sd[f"ups.{3 * i}.weight"])),
            "bias": _np(sd[f"ups.{3 * i}.bias"]),
        }
        params[f"att{i}"] = _att_from_torch(sd, f"ups.{3 * i + 1}")
        params[f"dec{i}"] = _double_conv_from_torch(
            sd, f"ups.{3 * i + 2}", 2 * f, f)
    params["head_conv"] = {
        "kernel": _conv_t2f(_np(sd["final_conv.0.weight"])),
        "bias": _np(sd["final_conv.0.bias"])}
    params["head_bn"] = {"scale": _np(sd["final_conv.1.weight"]),
                         "bias": _np(sd["final_conv.1.bias"])}
    params["head_out"] = {
        "kernel": _conv_t2f(_np(sd["final_conv.3.weight"])),
        "bias": _np(sd["final_conv.3.bias"])}
    for i in range(len(feats) - 1):
        params[f"deep{i}"] = {
            "kernel": _conv_t2f(_np(sd[f"deep_supervision.{i}.weight"])),
            "bias": _np(sd[f"deep_supervision.{i}.bias"])}
    batch_stats = {"head_bn": {
        "mean": _np(sd["final_conv.1.running_mean"]),
        "var": _np(sd["final_conv.1.running_var"])}}
    return params, batch_stats


def export_unet3d_to_torch(params: Mapping, batch_stats: Mapping,
                           features: Sequence[int] = (32, 64, 128,
                                                      256, 512)) -> Dict:
    """(params, batch_stats) -> reference-layout torch state_dict
    (numpy arrays; wrap with torch.tensor / torch.save as needed)."""
    feats = tuple(features)
    out: Dict[str, np.ndarray] = {}
    for i in range(len(feats)):
        _double_conv_to_torch(params[f"down{i}"], f"downs.{i}", out)
    _double_conv_to_torch(params["bottleneck"], "bottleneck", out)
    for i in range(len(feats)):
        out[f"ups.{3 * i}.weight"] = _convT_f2t(
            _np(params[f"up{i}"]["kernel"]))
        out[f"ups.{3 * i}.bias"] = _np(params[f"up{i}"]["bias"])
        _att_to_torch(params[f"att{i}"], f"ups.{3 * i + 1}", out)
        _double_conv_to_torch(params[f"dec{i}"], f"ups.{3 * i + 2}", out)
    out["final_conv.0.weight"] = _conv_f2t(
        _np(params["head_conv"]["kernel"]))
    out["final_conv.0.bias"] = _np(params["head_conv"]["bias"])
    out["final_conv.1.weight"] = _np(params["head_bn"]["scale"])
    out["final_conv.1.bias"] = _np(params["head_bn"]["bias"])
    out["final_conv.1.running_mean"] = _np(
        batch_stats["head_bn"]["mean"])
    out["final_conv.1.running_var"] = _np(batch_stats["head_bn"]["var"])
    out["final_conv.3.weight"] = _conv_f2t(
        _np(params["head_out"]["kernel"]))
    out["final_conv.3.bias"] = _np(params["head_out"]["bias"])
    for i in range(len(feats) - 1):
        out[f"deep_supervision.{i}.weight"] = _conv_f2t(
            _np(params[f"deep{i}"]["kernel"]))
        out[f"deep_supervision.{i}.bias"] = _np(
            params[f"deep{i}"]["bias"])
    return out


def save_torch_checkpoint(path: str, params: Mapping,
                          batch_stats: Mapping,
                          features: Sequence[int] = (32, 64, 128,
                                                     256, 512)) -> str:
    """Write a reference-loadable ``.pth`` (torch.save of the mapped
    state_dict) so reference-side tooling can consume the port's trained
    weights."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_unet3d_to_torch(params, batch_stats,
                                             features).items()}
    torch.save(sd, path)
    return path


def load_torch_checkpoint(path: str, in_channels: int = 4,
                          features: Sequence[int] = (32, 64, 128,
                                                     256, 512),
                          model=None) -> Tuple[Dict, Dict]:
    """Read a reference ``.pth`` (either a bare state_dict or the
    reference trainer's checkpoint dict with ``model_state_dict``,
    ``training.py:396-404``) into (params, batch_stats); with ``model``
    (the port's ``UNet3D``), also load them into it, every key and shape
    checked."""
    # weights_only=True: the expected payload is a state_dict of
    # tensors (+ scalar metadata); never unpickle arbitrary code from
    # externally supplied .pth files.
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    params, batch_stats = import_unet3d_from_torch(obj, in_channels,
                                                   features)
    if model is not None:
        model.load_state_dict(load_flax_params(
            {"params": params, "batch_stats": batch_stats}))
    return params, batch_stats


def import_classifier_from_torch(state_dict: Mapping
                                 ) -> Dict[str, Any]:
    """Reference ``BrainTumorClassifier.state_dict()`` -> flax params.

    torch Linear weight (out, in) -> flax Dense kernel (in, out); the
    flattened feature order differs (torch NCDHW flatten vs our NDHWC
    flatten), so fc1 input weights are permuted accordingly.
    """
    sd = state_dict
    p: Dict[str, Any] = {}
    for fk, tk in [("conv1", "features.0"), ("conv2", "features.3"),
                   ("conv3", "features.6")]:
        p[fk] = {"kernel": _conv_t2f(_np(sd[f"{tk}.weight"])),
                 "bias": _np(sd[f"{tk}.bias"])}
    w1 = _np(sd["classifier.0.weight"])          # (512, 128*4*4*4)
    # torch flatten order: (C=128, d=4, h=4, w=4); ours: (d,h,w,C)
    w1 = w1.reshape(512, 128, 4, 4, 4).transpose(0, 2, 3, 4, 1)
    p["fc1"] = {"kernel": w1.reshape(512, -1).T.copy(),
                "bias": _np(sd["classifier.0.bias"])}
    p["fc2"] = {"kernel": _np(sd["classifier.3.weight"]).T.copy(),
                "bias": _np(sd["classifier.3.bias"])}
    return p
