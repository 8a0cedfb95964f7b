#!/usr/bin/env python3
"""Convert a JAX package checkpoint (Orbax) into the PyTorch port's format.

    python convert_orbax_checkpoint.py <orbax_checkpoint> <output_dir>

Runs where JAX and Orbax are installed (it reads Orbax), never needs a
card, and is imported by no module of either package.

* A trainer checkpoint (``<ckpt>/state`` + ``trainer_meta.json``, the
  JAX ``train/checkpoints.py::save_checkpoint`` layout) becomes the
  port's ``<out>/state/state.pt`` + ``trainer_meta.json``, written by the
  port's ``train/checkpoints.py::save_tree``: ``params``,
  ``batch_stats``, ``step``, ``ema_params`` when present, and optax's
  optimizer state, a tuple of per-transformation states (the chain
  ``clip_by_global_norm`` -> ``adamw``, or ``adamw`` alone), reduced to
  the port's ``{count, mu, nu}``: Adam's state, whose ``mu`` / ``nu``
  trees have the params' layout.
* A params-only export (JAX ``save_params_only``) becomes
  ``<out>/params.pt`` through the port's ``save_params_only``.

Every leaf is restored as a host ``np.ndarray`` (``RestoreArgs(
restore_type=np.ndarray)``, as JAX's ``load_inference_weights`` does), so
a checkpoint written on an accelerator converts on a CPU-only host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np

PORT = "segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch"


def restore_numpy(path: str) -> Dict[str, Any]:
    """An Orbax pytree checkpoint at ``path``, every leaf a numpy array."""
    import jax
    import orbax.checkpoint as ocp
    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path).item_metadata
    tree = meta.tree if hasattr(meta, "tree") else meta
    restore_args = jax.tree_util.tree_map(
        lambda _: ocp.RestoreArgs(restore_type=np.ndarray), tree)
    return ckptr.restore(path, restore_args=restore_args)


def adam_state(opt_state) -> Optional[Mapping[str, Any]]:
    """The Adam state (``count``, ``mu``, ``nu``) inside optax's nested
    tuple of states (restored as lists and dicts), or None."""
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        children = list(opt_state.values())
    elif isinstance(opt_state, (list, tuple)):
        children = list(opt_state)
    else:
        return None
    for child in children:
        found = adam_state(child)
        if found is not None:
            return found
    return None


def convert(src: str, dst: str) -> str:
    """Convert the checkpoint at ``src`` into ``dst``; returns ``dst``'s
    absolute path."""
    from importlib import import_module
    ck = import_module(PORT + ".train.checkpoints")
    src = os.path.abspath(src)
    state_dir = os.path.join(src, "state")
    if not os.path.isdir(state_dir):
        return ck.save_params_only(dst, restore_numpy(src)["params"])
    tree = restore_numpy(state_dir)
    adam = adam_state(tree["opt_state"])
    if adam is None:
        raise ValueError(f"{src}: no Adam state (count, mu, nu) in the "
                         "optimizer state")
    out = {"params": tree["params"],
           "batch_stats": tree.get("batch_stats") or {},
           "opt_state": {"count": np.asarray(adam["count"], np.int64),
                         "mu": adam["mu"], "nu": adam["nu"]},
           "step": np.asarray(tree["step"], np.int64)}
    if tree.get("ema_params") is not None:
        out["ema_params"] = tree["ema_params"]
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(src, "trainer_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return ck.save_tree(dst, out, best_dice=meta.get("best_dice", 0.0),
                        epoch=meta.get("epoch", 0),
                        metrics_history=meta.get("metrics_history"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="Orbax checkpoint directory (a trainer "
                                "checkpoint or a params-only export)")
    ap.add_argument("dst", help="output directory in the port's format")
    args = ap.parse_args(argv)
    print(convert(args.src, args.dst))
    return 0


if __name__ == "__main__":
    sys.exit(main())
