"""Data-parallel cohort inference and window-parallel sliding-window
inference over a mesh (counterpart of the JAX package's
``parallel/infer.py``).

One process drives one device. Each rank forwards its share with the
model it holds, its kernels included (JAX's shard_map route), and the
results meet in one collective over the mesh's ``data`` group:

  * ``make_dp_segmenter`` / ``segment_cohort``: a batch of volumes split
    over ``data``, each rank's int8 labels gathered, so that every rank
    returns the whole batch;
  * ``make_dp_whole_predictor`` / ``segment_cohort_whole``: the same at
    native resolution (resize to the model size, forward, logits resized
    back, softmax), labels and confidence;
  * ``sliding_window_inference_mp``: one volume's window grid split over
    ``data``; each rank accumulates its windows into a full-volume f32
    accumulator and weight sum, and one all-reduce of each merges them.

On one process every collective is the identity, and
``segment_cohort_whole`` is JAX's ``--data_parallel`` on one device:
``batch_per_chip`` same-shape volumes through one batched forward.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .mesh import Mesh, all_gather, all_reduce_, replicate_module

__all__ = ["make_dp_segmenter", "segment_cohort",
           "make_dp_whole_predictor", "segment_cohort_whole",
           "sliding_window_inference_mp"]


def _bind(model: torch.nn.Module, variables: Optional[Mapping],
          mesh: Mesh) -> torch.device:
    """Load ``variables`` (a flax-layout tree, through the weight bridge)
    into ``model`` when given, then replicate its weights from the
    mesh's first rank; returns the model's device."""
    if variables is not None:
        from ..models.weights import load_flax_params
        model.load_state_dict(load_flax_params(variables))
    replicate_module(model, mesh)
    return next(model.parameters()).device


def _local(vols, mesh: Mesh, device) -> torch.Tensor:
    """This rank's rows of a global batch (an (N, ...) array or tensor,
    or a sequence of N volumes), stacked on ``device``: each row is
    copied there on its own, so no host copy of the batch is made."""
    n = len(vols)
    k = mesh.shape.get("data", 1)
    if n % k:
        raise ValueError(f"batch {n} not divisible by the mesh's data "
                         f"axis ({k})")
    i = mesh.index("data")
    return torch.stack([torch.as_tensor(v).to(device, torch.float32)
                        for v in vols[i * n // k:(i + 1) * n // k]])


def _gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return torch.cat(all_gather(t, mesh.group("data")))


def make_dp_segmenter(model: torch.nn.Module, variables: Optional[Mapping],
                      mesh: Mesh, via_shard_map: Optional[bool] = None
                      ) -> Callable:
    """``segment(vols) -> labels``: (N, D, H, W, C) float volumes (an
    array or tensor, or a sequence of N volumes; the same global batch on
    every rank) to (N, D, H, W) int8
    labels on the model's device, N split over the mesh's ``data`` axis
    (N must divide; ``segment_cohort`` pads). ``variables`` (optional) is
    loaded first; the weights are broadcast from the first rank once.
    ``via_shard_map`` is accepted for JAX's signature: the port has the
    per-rank route only."""
    del via_shard_map
    device = _bind(model, variables, mesh)

    def segment(vols) -> torch.Tensor:
        x = _local(vols, mesh, device)
        out = model(x)
        logits = out["logits"] if isinstance(out, dict) else out
        labels = logits.argmax(-1).to(torch.int8)
        return _gather(labels, mesh)

    return segment


def _waves(volumes, mesh: Mesh, batch_per_chip: int):
    """The cohort (an (N, ...) array or a sequence of volumes) padded to
    a multiple of ``data * batch_per_chip`` with its first volume, in
    waves of that size (lists of rows, nothing copied); and N."""
    vols = list(volumes)
    n = len(vols)
    wave = mesh.shape.get("data", mesh.devices.size) * batch_per_chip
    vols += vols[:1] * ((-n) % wave)
    return [vols[i:i + wave] for i in range(0, len(vols), wave)], n


def _run_waves(seg: Callable, waves, n: int):
    """Each wave's outputs (one tensor or a tuple) copied from the device
    into host tensors of all waves' rows; the first ``n`` rows of each,
    as numpy arrays."""
    out = None
    for j, w in enumerate(waves):
        res = seg(w)
        res = res if isinstance(res, tuple) else (res,)
        if out is None:
            out = [torch.empty((len(waves) * len(w), *r.shape[1:]),
                               dtype=r.dtype) for r in res]
        for o, r in zip(out, res):
            o[j * len(w):(j + 1) * len(w)].copy_(r)
    return tuple(o[:n].numpy() for o in out)


def segment_cohort(model: torch.nn.Module, variables: Optional[Mapping],
                   mesh: Mesh, volumes, batch_per_chip: int = 1
                   ) -> np.ndarray:
    """Segment a cohort of same-shape volumes of any length: padded to a
    multiple of ``data * batch_per_chip``, run in waves of that size,
    the padding stripped. Returns (N, D, H, W) int8 on every rank."""
    waves, n = _waves(volumes, mesh, batch_per_chip)
    return _run_waves(make_dp_segmenter(model, variables, mesh), waves,
                      n)[0]


def make_dp_whole_predictor(model: torch.nn.Module,
                            variables: Optional[Mapping], mesh: Mesh,
                            model_size) -> Callable:
    """``segment(vols) -> (labels, confidence)`` for (N, D, H, W, C)
    native-resolution volumes: resize to ``model_size``, forward, resize
    the logits back, softmax; the argmax as int8 and the max probability
    as f32, (N, D, H, W) each on the model's device, N split over the
    ``data`` axis (the batched ``Predictor._whole_volume_logits``)."""
    from ..inference.predictor import whole_volume_logits
    device = _bind(model, variables, mesh)
    size = tuple(model_size)

    def segment(vols):
        x = _local(vols, mesh, device)
        probs = torch.softmax(whole_volume_logits(model, x, size), dim=-1)
        conf, labels = probs.max(-1)
        return (_gather(labels.to(torch.int8), mesh),
                _gather(conf.float(), mesh))

    return segment


def segment_cohort_whole(model: torch.nn.Module,
                         variables: Optional[Mapping], mesh: Mesh, volumes,
                         model_size, batch_per_chip: int = 1):
    """A same-shape cohort (an (N, ...) array or a sequence of volumes) of
    any length through ``make_dp_whole_predictor`` in waves, padding
    stripped. Returns (labels (N, D, H, W) int8, confidence (N, D, H, W)
    float32) on the host, on every rank."""
    waves, n = _waves(volumes, mesh, batch_per_chip)
    return _run_waves(make_dp_whole_predictor(model, variables, mesh,
                                              model_size), waves, n)


def sliding_window_inference_mp(volume: torch.Tensor,
                                apply_fn: Callable[[torch.Tensor],
                                                   torch.Tensor],
                                mesh: Mesh, axis: str = "data",
                                roi_size=(128, 128, 128),
                                overlap: float = 0.5,
                                sw_batch_size: int = 1,
                                blend_mode: str = "gaussian",
                                sigma_scale: float = 0.125,
                                out_channels: int = 4) -> torch.Tensor:
    """Window-parallel sliding-window inference of one volume.

    ``volume``: (D, H, W, C) on this rank's device, the same volume on
    every rank; ``apply_fn``: a module or callable mapping (B, *roi, C)
    patches to (B, *roi, out_channels) logits. The window grid (the
    single-device engine's padding and starts) is padded with copies of
    window 0 of weight 0 to a multiple of ``n * sw_batch_size`` and split
    rank-major over the mesh's ``axis`` (size n): rank i forwards groups
    [i * g, (i + 1) * g) of ``sw_batch_size`` windows and accumulates
    them into a full-volume f32 accumulator and weight sum; one
    all-reduce of each over the axis's group, the division by max(wsum,
    1e-8) and the centre crop back to the input's shape follow. Returns
    (D, H, W, out_channels) f32 on every rank."""
    from ..inference.sliding_window import (_pad_to_roi,
                                            compute_patch_starts,
                                            gaussian_importance_map)
    roi_size = tuple(roi_size)
    orig = tuple(volume.shape[:3])
    volume, _ = _pad_to_roi(volume, roi_size)
    dims = tuple(volume.shape[:3])
    starts = [compute_patch_starts(d, r, overlap)
              for d, r in zip(dims, roi_size)]
    grid = np.stack(np.meshgrid(*[np.asarray(s) for s in starts],
                                indexing="ij"), axis=-1).reshape(-1, 3)
    num = grid.shape[0]
    n = mesh.shape[axis]
    pad = (-num) % (n * sw_batch_size)
    valid = np.ones(num + pad, bool)
    if pad:
        grid = np.concatenate([grid, np.repeat(grid[:1], pad, 0)], 0)
        valid[num:] = False
    per = grid.shape[0] // n
    lo = mesh.index(axis) * per

    dev = volume.device
    if blend_mode == "gaussian":
        imp = torch.from_numpy(gaussian_importance_map(
            roi_size, sigma_scale)).to(dev)
    else:
        imp = torch.ones((*roi_size, 1), device=dev)
    acc = torch.zeros((*dims, out_channels), dtype=torch.float32,
                      device=dev)
    wsum = torch.zeros((*dims, 1), dtype=torch.float32, device=dev)
    for g0 in range(lo, lo + per, sw_batch_size):
        wins = [tuple(slice(int(s), int(s) + r)
                      for s, r in zip(grid[i], roi_size))
                for i in range(g0, g0 + sw_batch_size)]
        logits = apply_fn(torch.stack([volume[w] for w in wins])).float()
        for i, w, lg in zip(range(g0, g0 + sw_batch_size), wins, logits):
            if valid[i]:
                acc[w] += lg * imp
                wsum[w] += imp
    group = mesh.group(axis)
    all_reduce_(acc, group)
    all_reduce_(wsum, group)
    off = [(p - o) // 2 for p, o in zip(dims, orig)]
    crop = tuple(slice(o, o + s) for o, s in zip(off, orig))
    return (acc / wsum.clamp_min(1e-8))[crop]
