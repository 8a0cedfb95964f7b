"""Checkpoints in the port's own format (counterpart of the JAX package's
``train/checkpoints.py``, whose Orbax format needs JAX).

A trainer checkpoint is a directory::

    <path>/state/state.pt       torch.save of the flax-layout tree
    <path>/trainer_meta.json    best dice, epoch, metrics history

The tree holds nested dicts of tensors named as the JAX train state's:
``params`` and ``batch_stats`` (the weight bridge's variables,
``models/weights.py``), ``opt_state`` (``count`` and AdamW's first and
second moments ``mu`` / ``nu``, each in the params' layout), ``step``
and, with an EMA, ``ema_params``. It is read back with
``torch.load(weights_only=True)``. A params-only export is
``<path>/params.pt`` holding ``{"params": tree}``.

Saving writes ``state.tmp`` and renames it over ``state`` only once it
is complete, so a write that fails leaves the previous checkpoint whole.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.weights import load_flax_params, to_flax_variables
from .state import TrainState

_META = "trainer_meta.json"
_STATE = "state.pt"
_PARAMS = "params.pt"


def _ckpt_dir(path: str) -> str:
    return os.path.abspath(path)


def _tensors(tree):
    """numpy leaves -> CPU tensors (what ``weights_only`` loads)."""
    if isinstance(tree, Mapping):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, order="C"))


def _arrays(tree):
    """tensor (or array) leaves -> numpy arrays (what the weight bridge
    takes)."""
    if isinstance(tree, Mapping):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _flax_params(named: Mapping[str, torch.Tensor]) -> Dict:
    return to_flax_variables(named)["params"]


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The train state as the flax-layout tree a checkpoint stores
    (numpy leaves, copies)."""
    variables = to_flax_variables(state.model.state_dict())
    named = dict(state.model.named_parameters())
    adam = state.optimizer.adamw.state
    mu = {n: adam[p]["exp_avg"] if "exp_avg" in adam[p]
          else torch.zeros_like(p) for n, p in named.items()}
    nu = {n: adam[p]["exp_avg_sq"] if "exp_avg_sq" in adam[p]
          else torch.zeros_like(p) for n, p in named.items()}
    tree = {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": {"count": np.asarray(state.step, np.int64),
                      "mu": _flax_params(mu), "nu": _flax_params(nu)},
        "step": np.asarray(state.step, np.int64),
    }
    if state.ema_params is not None:
        tree["ema_params"] = _flax_params(state.ema_params)
    return tree


def save_checkpoint(path: str, state: TrainState,
                    best_dice: float = 0.0, epoch: int = 0,
                    metrics_history: Optional[Dict[str, Any]] = None
                    ) -> str:
    """Write the state tree and the metadata; ``path`` is a directory."""
    path = _ckpt_dir(path)
    state_dir = os.path.join(path, "state")
    tmp_dir = os.path.join(path, "state.tmp")
    # write-then-swap: the old state is removed only once the new one is
    # complete on disk
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    torch.save(_tensors(state_tree(state)), os.path.join(tmp_dir, _STATE))
    if os.path.exists(state_dir):
        shutil.rmtree(state_dir)
    os.rename(tmp_dir, state_dir)
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"best_dice": float(best_dice), "epoch": int(epoch),
                   "metrics_history": metrics_history or {}}, f, indent=2)
    return path


def archive_existing(path: str) -> Optional[str]:
    """Move an existing checkpoint directory to a timestamped archive
    sibling (``<parent>/archive/<name>_<ts>/``) and make it read-only, so
    that a new run under the same experiment name cannot overwrite an
    earlier run's best checkpoint. Returns the archive path, or None
    when ``path`` holds no checkpoint."""
    path = _ckpt_dir(path)
    if not os.path.isdir(os.path.join(path, "state")):
        return None
    parent = os.path.dirname(path)
    name = os.path.basename(path.rstrip(os.sep))
    archive_root = os.path.join(parent, "archive")
    os.makedirs(archive_root, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    dest = os.path.join(archive_root, f"{name}_{ts}")
    n = 0
    while os.path.exists(dest):          # same-second collisions
        n += 1
        dest = os.path.join(archive_root, f"{name}_{ts}_{n}")
    shutil.move(path, dest)
    for root, dirs, files in os.walk(dest, topdown=False):
        for f in files:
            os.chmod(os.path.join(root, f), 0o444)
        for d in dirs:
            os.chmod(os.path.join(root, d), 0o555)
    os.chmod(dest, 0o555)
    return dest


def _load(path: str) -> Dict:
    return _arrays(torch.load(path, map_location="cpu", weights_only=True))


def restore_checkpoint(path: str, state: TrainState
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a checkpoint into the live ``state`` (in place); returns
    (state, meta). A checkpoint without an EMA restored into an EMA
    state seeds the EMA from the restored params; an EMA checkpoint
    restored into a state without one drops the saved EMA."""
    path = _ckpt_dir(path)
    tree = _load(os.path.join(path, "state", _STATE))
    model = state.model
    missing, unexpected = model.load_state_dict(load_flax_params(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}),
        strict=False)
    if missing or unexpected:
        raise KeyError(f"checkpoint {path} does not match the model: "
                       f"missing {missing}, unexpected {unexpected}")
    named = dict(model.named_parameters())
    count = int(tree["opt_state"]["count"])
    moments = [load_flax_params({"params": tree["opt_state"][k]})
               for k in ("mu", "nu")]
    adamw = state.optimizer.adamw
    group = adamw.param_groups[0]
    on_device = bool(group.get("fused") or group.get("capturable"))
    for n, p in named.items():
        adamw.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": moments[0][n].to(p.device, p.dtype),
            "exp_avg_sq": moments[1][n].to(p.device, p.dtype)}
    state.step = int(tree["step"])
    if state.ema_params is not None:
        src = (load_flax_params({"params": tree["ema_params"]})
               if "ema_params" in tree else None)
        with torch.no_grad():
            for n, e in state.ema_params.items():
                # a checkpoint without an EMA: seeded from its params
                e.copy_(src[n] if src is not None else named[n])
    meta: Dict[str, Any] = {"best_dice": 0.0, "epoch": 0,
                            "metrics_history": {}}
    meta_path = os.path.join(path, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta.update(json.load(f))
    return state, meta


def save_params_only(path: str, params: Mapping) -> str:
    """Export inference weights (a params tree of numpy arrays or
    tensors) as ``<path>/params.pt``."""
    path = _ckpt_dir(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"params": _tensors(_arrays(params))},
               os.path.join(path, _PARAMS))
    return path


def restore_params_only(path: str, params_like: Optional[Mapping] = None):
    """The params tree of ``save_params_only`` (numpy leaves); checked
    against ``params_like``'s structure and shapes when given."""
    params = _load(os.path.join(_ckpt_dir(path), _PARAMS))["params"]
    if params_like is not None and not compatible_tree(params, params_like):
        raise ValueError(f"{path}: params do not match the given tree")
    return params


def load_inference_weights(path: str) -> Tuple[Any, Optional[Any]]:
    """(params, batch_stats or None), numpy trees, from a trainer
    checkpoint directory or a params-only export. An EMA-trained
    checkpoint gives its EMA weights: what validation scored and
    save-on-best chose."""
    path = _ckpt_dir(path)
    state_file = os.path.join(path, "state", _STATE)
    if os.path.isfile(state_file):
        tree = _load(state_file)
    else:
        tree = _load(os.path.join(path, _PARAMS))
    params = tree.get("ema_params")
    if params is None:
        params = tree["params"]
    return params, tree.get("batch_stats")


def adopt_trained_weights(predictor, checkpoint: str = "",
                          models_dir: str = "",
                          log=None) -> Optional[str]:
    """Adopt trained segmentation weights into a ``Predictor``: the
    explicit ``checkpoint`` path, or else the newest ``best_*``
    checkpoint under ``models_dir`` whose tree fits the predictor's
    model. A joint (``UNet3DWithClassifier``) checkpoint gives its
    ``unet`` trunk and turns on the grade head. Returns the adopted
    path, or None: an absent or unfitting checkpoint leaves the
    predictor as it was."""
    log = log or logging.getLogger(__name__)
    if checkpoint == "none":
        return None
    candidates = ([checkpoint] if checkpoint else sorted(
        glob.glob(os.path.join(models_dir, "best_*")),
        key=os.path.getmtime, reverse=True))
    live = to_flax_variables(predictor.seg_model.state_dict())["params"]
    for path in candidates:
        try:
            params, bstats = load_inference_weights(path)
        except Exception as e:
            log.warning("checkpoint %s unreadable: %s", path, e)
            continue
        # a joint checkpoint nests the trunk under "unet"
        trees = [(params, bstats)]
        if isinstance(params, dict) and "unet" in params:
            trees.append((params["unet"], bstats.get("unet")
                          if isinstance(bstats, dict) else None))
        for p, b in trees:
            if not compatible_tree(p, live):
                continue
            predictor.load_seg_params(p, b)
            if p is not params and b is not None:
                try:
                    predictor.load_joint_grade(params, bstats)
                except Exception as e:
                    log.warning("grade head not enabled: %s", e)
            log.info("loaded trained weights from %s", path)
            return path
        log.info("checkpoint %s: different model config, skipping", path)
    return None


def compatible_tree(a, b) -> bool:
    """True iff two trees have the same nested keys and the same leaf
    shapes (the dtype may differ)."""
    if isinstance(a, Mapping) or isinstance(b, Mapping):
        if not (isinstance(a, Mapping) and isinstance(b, Mapping)
                and set(a) == set(b)):
            return False
        return all(compatible_tree(a[k], b[k]) for k in a)
    return tuple(getattr(a, "shape", ())) == tuple(getattr(b, "shape", ()))
