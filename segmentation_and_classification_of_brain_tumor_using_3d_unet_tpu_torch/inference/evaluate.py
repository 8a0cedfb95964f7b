"""Cohort evaluation CLI: predicted label maps against ground truth
(counterpart of the JAX package's ``inference/evaluate.py``).

Grades any predictions directory (the predict CLI's output, or masks
from another tool) against a BraTS-style ground-truth tree: per-case and
aggregate per-class Dice, WT/TC/ET region Dice and HD95, and whole-tumour
IoU / sensitivity / specificity. The voxel counts run on ``--device``
(default ``cuda``, raising without a card); HD95 is the port's
``metrics.hausdorff_distance_95`` (the exact EDT on the host, in the GT
header's mm).

Usage::

    python -m segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.inference.evaluate \\
        --pred results/predictions --gt data/cohort [--device cpu]

Conventions: a class absent from both prediction and GT scores NaN and is
left out of the aggregates (an absent class is not a failure); an
empty-surface HD95 is ``inf`` and likewise left out, with the count of
exclusions reported.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import BRATS_REGIONS
from ..device import resolve_device
from ..metrics import hausdorff_distance_95
from ._files import VOLUME_EXTS, volume_stem

logger = logging.getLogger(__name__)


def _tensor(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _count(mask: torch.Tensor) -> float:
    return float(mask.sum().item())


def _binary_dice(p: torch.Tensor, t: torch.Tensor) -> float:
    """Hard Dice; NaN when the structure is absent in both masks."""
    ps, ts = _count(p), _count(t)
    if ps == 0.0 and ts == 0.0:
        return float("nan")
    return 2.0 * _count(p & t) / (ps + ts)


def evaluate_case(pred, gt, num_classes: int = 4,
                  spacing: Sequence[float] = (1.0, 1.0, 1.0),
                  regions=None, device="cuda") -> Dict[str, float]:
    """Per-case metrics of two integer label volumes of equal shape
    (arrays or tensors), counted on ``device``.

    With the BraTS convention (``num_classes == 4``) both inputs are
    remapped to contiguous labels (raw enhancing tumour 4 -> 3, the
    training remap) before scoring, so BraTS seg files and
    ``--brats_labels`` predictions score against either convention; with
    more classes, 4 is a class of its own and stays."""
    dev = resolve_device(device)
    pred, gt = _tensor(pred, dev), _tensor(gt, dev)
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch: pred {tuple(pred.shape)} vs "
                         f"gt {tuple(gt.shape)}")
    if num_classes == 4:
        pred = torch.where(pred == 4, 3, pred)
        gt = torch.where(gt == 4, 3, gt)
    regions = dict(regions or BRATS_REGIONS)
    out: Dict[str, float] = {}
    for c in range(1, num_classes):
        out[f"dice_c{c}"] = _binary_dice(pred == c, gt == c)
    for name, ids in regions.items():
        ids = torch.as_tensor(ids, dtype=pred.dtype, device=dev)
        p, t = torch.isin(pred, ids), torch.isin(gt, ids)
        out[f"dice_{name}"] = _binary_dice(p, t)
        out[f"hd95_{name}"] = hausdorff_distance_95(p, t, spacing)
    # whole-tumour binary confusion metrics
    p, t = pred > 0, gt > 0
    inter, union = _count(p & t), _count(p | t)
    out["iou"] = inter / union if union else float("nan")
    n_t = _count(t)
    out["sensitivity"] = inter / n_t if n_t else float("nan")
    tn, fp = _count(~p & ~t), _count(p & ~t)
    out["specificity"] = tn / (tn + fp) if (tn + fp) else float("nan")
    return out


def aggregate(case_metrics: Dict[str, Dict[str, float]]
              ) -> Dict[str, Dict[str, float]]:
    """Mean / std over the finite per-case values; ``n_excluded`` counts
    the NaN (absent in both) and inf (empty-surface HD) values left out."""
    keys = sorted({k for m in case_metrics.values() for k in m})
    agg = {}
    for k in keys:
        vals = [m[k] for m in case_metrics.values() if k in m]
        finite = [v for v in vals if math.isfinite(v)]
        agg[k] = {
            "mean": float(np.mean(finite)) if finite else float("nan"),
            "std": float(np.std(finite)) if finite else float("nan"),
            "n": len(finite),
            "n_excluded": len(vals) - len(finite),
        }
    return agg


def _find_gt(gt_root: Path, case_id: str) -> Optional[Path]:
    """GT of a case: ``<root>/<case>/*seg*``, ``<root>/<case>*seg*``, or
    ``<root>/<case>.<ext>``."""
    sub = gt_root / case_id
    if sub.is_dir():
        segs = [f for f in sorted(sub.iterdir())
                if "seg" in f.name and f.name.endswith(VOLUME_EXTS)]
        if segs:
            return segs[0]
    for f in sorted(gt_root.iterdir()) if gt_root.is_dir() else []:
        if not f.name.endswith(VOLUME_EXTS):
            continue
        if volume_stem(f) == case_id or (f.name.startswith(case_id)
                                         and "seg" in f.name):
            return f
    return None


def discover_pairs(pred_dir: str, gt_root: str) -> List[Dict[str, str]]:
    """Match ``<case>_seg.*`` (the predict CLI's names) or any volume in
    ``pred_dir`` against the GT tree."""
    pdir, groot = Path(pred_dir), Path(gt_root)
    if not pdir.is_dir():
        raise SystemExit(f"predictions dir not found: {pred_dir}")
    pairs = []
    for f in sorted(pdir.iterdir()):
        if not f.name.endswith(VOLUME_EXTS):
            continue
        case_id = volume_stem(f)
        if case_id.endswith("_seg"):
            case_id = case_id[:-len("_seg")]
        gt = _find_gt(groot, case_id)
        if gt is None:
            logger.warning("no ground truth for %s — skipping", case_id)
            continue
        pairs.append({"case_id": case_id, "pred": str(f), "gt": str(gt)})
    return pairs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Score predicted label maps against ground truth")
    p.add_argument("--pred", required=True,
                   help="directory of predicted masks (<case>_seg.*)")
    p.add_argument("--gt", required=True,
                   help="ground-truth cohort root (case dirs with "
                        "*seg* files) or flat directory")
    p.add_argument("--output", default="",
                   help="evaluation JSON path "
                        "(default <pred>/evaluation.json)")
    p.add_argument("--csv", default="",
                   help="also write a per-case CSV table (one row per "
                        "case, one column per metric)")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--spacing", type=float, nargs=3, default=None,
                   help="voxel spacing (mm) for HD95; default: read "
                        "from each ground-truth NIfTI header (1 mm "
                        "isotropic for .npy)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the voxel counts (default cuda)")
    return p


def evaluate_main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv``, score every pair, write the JSON (and CSV), print
    the table; returns the result dict."""
    from ..data import nifti
    from ..data.dataset import load_any_volume

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = resolve_device(args.device)
    pairs = discover_pairs(args.pred, args.gt)
    if not pairs:
        raise SystemExit(f"no (prediction, ground-truth) pairs between "
                         f"{args.pred} and {args.gt}")

    cases: Dict[str, Dict[str, float]] = {}
    for pair in pairs:
        pred = load_any_volume(pair["pred"]).astype(np.int32)
        gt = load_any_volume(pair["gt"]).astype(np.int32)
        spacing = tuple(args.spacing) if args.spacing else None
        if spacing is None:
            # per-case spacing from the GT header: HD95 in mm
            try:
                spacing = nifti.affine_spacing(nifti.load_affine(pair["gt"]))
            except (OSError, EOFError, ValueError):
                spacing = None
        cases[pair["case_id"]] = evaluate_case(
            pred, gt, num_classes=args.num_classes,
            spacing=spacing or (1.0, 1.0, 1.0), device=device)
    agg = aggregate(cases)

    result = {"n_cases": len(cases), "pairs": pairs,
              "cases": cases, "aggregate": agg}
    out = args.output or os.path.join(args.pred, "evaluation.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1, default=float)
    logger.info("wrote %s", out)

    if args.csv:
        cols = sorted({k for m in cases.values() for k in m})
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["case_id"] + cols)
            for cid, m in cases.items():
                w.writerow([cid] + [m.get(k, "") for k in cols])
        logger.info("wrote %s", args.csv)

    print(f"{'metric':<16}{'mean':>9}{'std':>9}{'n':>5}{'excl':>6}")
    for k, a in agg.items():
        print(f"{k:<16}{a['mean']:>9.4f}{a['std']:>9.4f}"
              f"{a['n']:>5}{a['n_excluded']:>6}")
    return result


def main() -> None:
    evaluate_main()


if __name__ == "__main__":
    main()
