"""Batch prediction CLI: NIfTI / npy volumes in, label maps and clinical
reports out (counterpart of the JAX package's ``inference/cli.py``).

The headless path through the stack the server uses: ``Predictor``
modes (cropped / sliding_window / whole_volume), trained-checkpoint
adoption (``train.checkpoints.adopt_trained_weights``) and the
deterministic clinical report (``serve/reports.py``), over a file, a case
directory, or a cohort of case directories.

Usage::

    python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.cli \\
        --input data/cohort --output results/predictions --report [--device cpu]

``--device`` (default ``cuda``) is where the normalisation and the
models run; without a card the default raises. Cases with a ground-truth
``*seg*`` file get real quality metrics (Dice / IoU / HD95 against it) in
their report; without one the report carries ``quality_estimated``, as
serving does. ``--data_parallel`` and ``--window_parallel`` pass JAX's
checks, then raise: multi-device is not ported. Each case logs its host
ms by stage as ``case <id> <stage>: <ms> ms`` at INFO.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ._files import is_volume, volume_stem

logger = logging.getLogger(__name__)


def _case_from_dir(pdir: Path, modalities: Sequence[str]) -> Optional[Dict]:
    """One case from a directory of per-modality files (BraTS layout, the
    seg optional and a partial set of modalities allowed)."""
    files = [f for f in sorted(pdir.iterdir()) if is_volume(f)]
    if not files:
        return None
    images: List[str] = []
    for m in modalities:
        match = [f for f in files if m in f.name and "seg" not in f.name]
        if match:
            images.append(str(match[0]))
    if not images:  # no modality tokens: every non-seg file is a channel
        images = [str(f) for f in files if "seg" not in f.name]
    if not images:
        return None
    seg = [f for f in files if "seg" in f.name]
    return {"case_id": pdir.name, "images": images,
            "seg": str(seg[0]) if seg else None}


def discover_cases(input_path: str,
                   modalities: Sequence[str]) -> List[Dict]:
    """A file -> one single-channel case. A directory of volumes -> one
    case per file, one stacked case if the names carry modality tokens,
    or one case per prefix before ``_<modality>``. A directory of
    directories -> one case per subdirectory."""
    root = Path(input_path)
    if root.is_file():
        if not is_volume(root):
            raise SystemExit(f"unsupported input: {root}")
        return [{"case_id": volume_stem(root),
                 "images": [str(root)], "seg": None}]
    if not root.is_dir():
        raise SystemExit(f"input not found: {input_path}")

    subdirs = [d for d in sorted(root.iterdir()) if d.is_dir()]
    cases = [c for c in (_case_from_dir(d, modalities) for d in subdirs)
             if c]
    if cases:
        return cases
    # a flat directory of modality-token files: grouped by the prefix
    # before "_<modality>", so several cases can share one directory
    files = [f for f in sorted(root.iterdir()) if is_volume(f)]
    groups: Dict[str, List[tuple]] = {}
    for f in files:
        if "seg" in f.name:
            continue
        for mi, m in enumerate(modalities):
            idx = f.name.find(f"_{m}")
            if idx > 0:
                groups.setdefault(f.name[:idx], []).append((mi, f))
                break
    if len(groups) > 1:
        out = []
        for cid in sorted(groups):
            # cid + "_", so that case_1 never claims case_10's seg file
            seg = [f for f in files
                   if "seg" in f.name and f.name.startswith(cid + "_")]
            # channels in the order of ``modalities``, as _case_from_dir
            imgs = [str(f) for _, f in sorted(groups[cid])]
            out.append({"case_id": cid, "images": imgs,
                        "seg": str(seg[0]) if seg else None})
        return out
    own = _case_from_dir(root, modalities)
    if own and any(m in Path(f).name for f in own["images"]
                   for m in modalities):
        return [own]        # the directory is one multi-modal case
    return [{"case_id": volume_stem(f), "images": [f], "seg": None}
            for f in (own or {"images": []})["images"]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Segment brain MRI volumes (PyTorch/CUDA, headless)")
    p.add_argument("--input", required=True,
                   help="volume file, case directory, or cohort root")
    p.add_argument("--output", default="results/predictions")
    p.add_argument("--mode", default="cropped",
                   choices=["cropped", "sliding_window", "whole_volume"],
                   help="cropped = foreground crop + Gaussian sliding "
                        "window (serving default); whole_volume = the "
                        "reference's destructive-resize semantics")
    p.add_argument("--checkpoint", default="",
                   help="trained checkpoint to adopt ('none' disables "
                        "auto-discovery)")
    p.add_argument("--models_dir", default="results/models",
                   help="auto-adopt the newest compatible best_* here "
                        "when --checkpoint is not given")
    p.add_argument("--report", action="store_true",
                   help="write <case>_report.json (volume/shape metrics,"
                        " classification, clinical findings; real "
                        "quality metrics when a *seg* GT file exists)")
    p.add_argument("--save_confidence", action="store_true",
                   help="also write <case>_conf.* per-voxel max-softmax "
                        "confidence maps (float32)")
    p.add_argument("--tta", action="store_true",
                   help="mirror test-time augmentation: average "
                        "probabilities over the 8 D/H/W flips (~8x "
                        "cost, better Dice)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard cases over all devices (not ported: "
                        "raises)")
    p.add_argument("--batch_per_chip", type=int, default=1,
                   help="volumes per device per wave in --data_parallel")
    p.add_argument("--window_parallel", action="store_true",
                   help="split each volume's sliding-window grid over "
                        "all devices (not ported: raises)")
    p.add_argument("--brats_labels", action="store_true",
                   help="write masks in the raw BraTS convention "
                        "(enhancing tumor = label 4, as on disk in "
                        "BraTS datasets) instead of the model's "
                        "contiguous 0..3 labels")
    p.add_argument("--format", default="nii.gz",
                   choices=["nii.gz", "nii", "npy"])
    p.add_argument("--preset", default="standard",
                   choices=["standard", "fast", "high_quality",
                            "lightweight", "production"])
    p.add_argument("--image_size", type=int, nargs=3, default=None)
    p.add_argument("--features", type=int, nargs="+", default=None)
    p.add_argument("--roi_size", type=int, nargs=3, default=None,
                   help="sliding-window tile size")
    p.add_argument("--device", default="cuda",
                   help="torch device to predict on (default cuda)")
    return p


def predict_main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parse ``argv``, build the preset's config, predict; returns the
    per-case summaries."""
    from ..config import get_config

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = get_config(args.preset)
    if args.features:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, features=tuple(args.features)))
    if args.image_size:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, image_size=tuple(args.image_size)))
    if args.roi_size:
        cfg = cfg.replace(inference=dataclasses.replace(
            cfg.inference, roi_size=tuple(args.roi_size)))
    return _predict(args, cfg)


def _predict(args: argparse.Namespace, cfg) -> List[Dict]:
    """Predict every case of ``args.input`` with a ``Predictor(cfg)``."""
    import torch

    from ..config import BRATS_MODALITIES
    from ..data import nifti
    from ..data.dataset import _decode_pool, load_any_volume
    from ..data.preprocess import preprocess_multimodal
    from ..device import resolve_device
    from ..serve.reports import (calculate_medical_metrics,
                                 generate_clinical_report)
    from ..train.checkpoints import adopt_trained_weights
    from .predictor import Predictor

    device = resolve_device(args.device)
    cases = discover_cases(args.input, BRATS_MODALITIES)
    if not cases:
        raise SystemExit(f"no volumes found under {args.input}")
    logger.info("%d case(s) from %s", len(cases), args.input)

    predictor = Predictor(cfg, device=device)
    adopted = adopt_trained_weights(predictor, args.checkpoint,
                                    args.models_dir, logger)
    os.makedirs(args.output, exist_ok=True)

    if args.window_parallel:
        if args.mode == "whole_volume":
            raise SystemExit("--window_parallel distributes sliding "
                             "windows; whole_volume has none (use "
                             "--data_parallel there)")
        if args.data_parallel:
            raise SystemExit("--window_parallel and --data_parallel "
                             "are different axes; pick one")
    if args.data_parallel:
        if args.mode != "whole_volume":
            raise SystemExit("--data_parallel batches the single-"
                             "forward whole_volume mode; cropped/"
                             "sliding_window are per-volume "
                             "(drop --data_parallel)")
        if args.tta:
            raise SystemExit("--tta is per-volume; drop "
                             "--data_parallel to combine")
    if args.window_parallel or args.data_parallel:
        raise NotImplementedError(
            "multi-device prediction (--data_parallel, --window_parallel) "
            "is not ported yet: it comes with the multi-device slice")

    summaries: List[Dict] = []
    for case in cases:
        cid = case["case_id"]
        stages: Dict[str, float] = {}
        t0 = clock = time.perf_counter()

        def lap(stage: str) -> None:
            nonlocal clock
            now = time.perf_counter()
            stages[stage] = 1e3 * (now - clock)
            clock = now

        # the modalities decode concurrently (zlib releases the GIL)
        raw = np.stack(list(_decode_pool().map(load_any_volume,
                                               case["images"])), axis=-1)
        lap("decode")
        # normalised at the native resolution (whole_volume resizes
        # inside the predictor)
        norm = preprocess_multimodal(torch.from_numpy(raw).to(device),
                                     out_size=None).cpu().numpy()
        lap("preprocess")
        labels, conf = predictor.segment_with_confidence(
            norm, mode=args.mode, tta=args.tta)
        lap("segment")
        base = os.path.join(args.output, cid)
        mask_path = f"{base}_seg.{args.format}"
        # --brats_labels: enhancing tumour back to its on-disk label 4 in
        # the written mask only; reports and metrics keep labels 0..3
        out_labels = (np.where(labels == 3, 4, labels)
                      if args.brats_labels else labels)
        # the scan's voxel->world affine carried into the outputs (a
        # header-only read; .npy inputs have none -> identity)
        try:
            affine = nifti.load_affine(case["images"][0])
        except (OSError, EOFError, ValueError):
            affine = None
        if args.format == "npy":
            np.save(mask_path, out_labels)
        else:
            nifti.save(mask_path, out_labels.astype(np.uint8),
                       affine=affine)
        summary = {"case_id": cid, "mask": mask_path,
                   "tumor_voxels": int((labels > 0).sum()),
                   "shape": list(labels.shape),
                   "seconds": round(time.perf_counter() - t0, 3)}
        if args.save_confidence:
            conf_path = f"{base}_conf.{args.format}"
            if args.format == "npy":
                np.save(conf_path, conf)
            else:
                nifti.save(conf_path, conf.astype(np.float32),
                           affine=affine)
            summary["confidence"] = conf_path
        lap("write")

        if args.report:
            gt = None
            if case["seg"]:
                gt = load_any_volume(case["seg"]).astype(np.int32)
            # the voxel geometry of the affine (column norms for areas,
            # |det| for volumes); identity or none means 1 mm isotropic
            metrics = calculate_medical_metrics(
                raw[..., 0], labels, ground_truth=gt,
                confidence_map=conf,
                spacing_mm=nifti.affine_spacing(affine),
                voxel_volume_mm3=nifti.affine_voxel_volume(affine))
            tumor_type, cls_conf = predictor.classify_tumor(
                norm, segmentation=labels)
            grade = predictor.classify_grade(norm)
            report = generate_clinical_report(
                metrics, filename=cid, classifier_confidence=cls_conf,
                model_grade=grade[0] if grade else None,
                grade_confidence=grade[1] if grade else None)
            report["tumor_type"] = tumor_type
            report["weights"] = adopted or "random_init"
            report_path = f"{base}_report.json"
            with open(report_path, "w") as f:
                json.dump(report, f, indent=1, default=float)
            summary["report"] = report_path
            summary["diagnosis"] = (
                report["classification"]["primary_diagnosis"])
            lap("report")
        summaries.append(summary)
        for stage, ms in stages.items():
            logger.info("case %s %s: %.2f ms", cid, stage, ms)
        logger.info("%s: %d tumor voxels in %.2fs", cid,
                    summary["tumor_voxels"], summary["seconds"])

    index = {"weights": adopted or "random_init", "mode": args.mode,
             "cases": summaries}
    with open(os.path.join(args.output, "predictions.json"), "w") as f:
        json.dump(index, f, indent=1, default=float)
    return summaries


def main() -> None:
    predict_main()


if __name__ == "__main__":
    main()
