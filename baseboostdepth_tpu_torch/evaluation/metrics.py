"""Depth error metrics and evaluation protocol pieces (host-side numpy), a
copy of `baseboostdepth_tpu/evaluation/metrics.py`.

Math parity: reference compute_errors (evaluate_depth.py:57-102 /
layers.py:252-286), Garg crop ratios (evaluate_depth.py:271-275), median
scaling (evaluate_depth.py:281-284), stereo-eval scale factor 5.4
(evaluate_depth.py:44).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

STEREO_SCALE_FACTOR = 5.4
KITTI_MIN_DEPTH = 1e-3
KITTI_MAX_DEPTH = 80.0
SYNS_MAX_DEPTH = 125.0

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


@dataclass
class EvalProtocol:
    median_scaling: bool = True
    pred_scale_factor: float = 1.0
    garg_crop: bool = True  # eigen splits; SYNS skips it
    min_depth: float = KITTI_MIN_DEPTH
    max_depth: float = KITTI_MAX_DEPTH
    disp_input: bool = True  # predictions are disparities (1/depth); SQL=False

    @classmethod
    def mono(cls) -> "EvalProtocol":
        return cls()

    @classmethod
    def stereo(cls) -> "EvalProtocol":
        return cls(median_scaling=False, pred_scale_factor=STEREO_SCALE_FACTOR)


def evaluate_disparities(
    pred_disps: np.ndarray,
    gt_depths: List[np.ndarray],
    protocol: Optional[EvalProtocol] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full eigen evaluation loop over per-image predictions.

    Args:
      pred_disps: [N, h, w] network disparities at inference resolution
        (scaled_disp for non-SQL zoos; metric depth when
        protocol.disp_input=False).
      gt_depths: list of [H_i, W_i] sparse GT depth maps.
    Returns:
      (mean_errors [7], ratios [N]) -- per-image median scaling ratios are
      empty when median scaling is off.
    """
    import cv2

    p = protocol or EvalProtocol.mono()
    errors = []
    ratios = []
    for i in range(pred_disps.shape[0]):
        gt = np.asarray(gt_depths[i], dtype=np.float32)
        gh, gw = gt.shape[:2]
        pd = cv2.resize(pred_disps[i], (gw, gh))
        pred_depth = (1.0 / pd) if p.disp_input else pd

        mask = np.logical_and(gt > p.min_depth, gt < p.max_depth)
        if p.garg_crop:
            mask = np.logical_and(mask, garg_crop_mask(gh, gw))

        pred_m = pred_depth[mask] * p.pred_scale_factor
        gt_m = gt[mask]

        if p.median_scaling:
            ratio = np.median(gt_m) / np.median(pred_m)
            ratios.append(ratio)
            pred_m = pred_m * ratio

        pred_m = np.clip(pred_m, p.min_depth, p.max_depth)
        errors.append(compute_errors(gt_m, pred_m))

    return np.array(errors).mean(0), np.array(ratios)


def single_image_errors(
    depth_pred_full: np.ndarray,
    gt_depth: np.ndarray,
    min_depth: float = KITTI_MIN_DEPTH,
    max_depth: float = KITTI_MAX_DEPTH,
) -> Tuple[float, ...]:
    """Online-validation variant (reference compute_depth_losses,
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
