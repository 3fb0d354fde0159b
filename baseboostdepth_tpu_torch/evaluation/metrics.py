"""Depth error metrics (host-side numpy), the part of
`baseboostdepth_tpu/evaluation/metrics.py` that online validation needs; the
full evaluation protocol waits for the eval slice.

Math parity: reference compute_errors (evaluate_depth.py:57-102 /
layers.py:252-286), Garg crop ratios (evaluate_depth.py:271-275), median
scaling (trainer.py:595-617).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

KITTI_MIN_DEPTH = 1e-3
KITTI_MAX_DEPTH = 80.0

METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, ...]:
    """The 7 standard KITTI depth metrics over masked 1-D arrays."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())

    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def garg_crop_mask(height: int, width: int) -> np.ndarray:
    """The eigen-split evaluation crop, as hard-coded ratios
    (evaluate_depth.py:271-275)."""
    crop = np.array(
        [0.40810811 * height, 0.99189189 * height, 0.03594771 * width, 0.96405229 * width]
    ).astype(np.int32)
    m = np.zeros((height, width), dtype=bool)
    m[crop[0] : crop[1], crop[2] : crop[3]] = True
    return m


def single_image_errors(
    depth_pred_full: np.ndarray,
    gt_depth: np.ndarray,
    min_depth: float = KITTI_MIN_DEPTH,
    max_depth: float = KITTI_MAX_DEPTH,
) -> Tuple[float, ...]:
    """Online-validation metrics (reference compute_depth_losses,
    trainer.py:595-617): prediction already resized to GT resolution,
    median-scaled under the Garg crop."""
    gh, gw = gt_depth.shape[:2]
    pred = np.clip(depth_pred_full, min_depth, max_depth)
    mask = np.logical_and(gt_depth > min_depth, gt_depth < max_depth)
    mask = np.logical_and(mask, garg_crop_mask(gh, gw))
    pred_m = pred[mask]
    gt_m = gt_depth[mask]
    pred_m = pred_m * (np.median(gt_m) / np.median(pred_m))
    pred_m = np.clip(pred_m, min_depth, max_depth)
    return compute_errors(gt_m, pred_m)
