"""Inference: the predictor, the sliding window, the foreground crop, the
headless predict and evaluate CLIs and the int8 calibration (counterpart
of the JAX package's ``inference/``)."""

from .cli import discover_cases, predict_main
from .cropping import (bucket_shape, crop_offsets, extract_crop,
                       nonzero_bbox, paste_full, plan_crop)
from .evaluate import discover_pairs, evaluate_case, evaluate_main
from .predictor import Predictor, preprocess_image
from .quantize import calibrate_int8, quant_scales_from_stats
from .sliding_window import (compute_patch_starts, gaussian_importance_map,
                             make_sw_predictor, sliding_window_inference)

__all__ = ["Predictor", "preprocess_image",
           "calibrate_int8", "quant_scales_from_stats",
           "discover_cases", "predict_main",
           "discover_pairs", "evaluate_case", "evaluate_main",
           "compute_patch_starts", "gaussian_importance_map",
           "make_sw_predictor", "sliding_window_inference",
           "nonzero_bbox", "bucket_shape", "crop_offsets", "extract_crop",
           "paste_full", "plan_crop"]
