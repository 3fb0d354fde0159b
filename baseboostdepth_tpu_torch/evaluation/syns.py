"""SYNS evaluation: depth metrics + edge accuracy/completeness + point-cloud
F-score/IoU; the counterpart of `baseboostdepth_tpu/evaluation/syns.py`.

Parity with the reference's SYNS branch (evaluate_depth.py:107-112 depth
range 1e-3..125, :257-265 log-depth Sobel edge extraction, :89-95 EDT edge
metrics, :74-87 chamfer point-cloud metrics -- here via ops.chamfer instead
of the CUDA extension). SYNS intrinsics derive from the KITTI FOV
(datasets/syns_dataset.py:20-36).
"""

from __future__ import annotations

import os

import numpy as np
from torch import nn

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.evaluation import metrics as M
from baseboostdepth_tpu_torch.evaluation.depth import eval_static, load_gt, predict_disparities
from baseboostdepth_tpu_torch.ops.chamfer import chamfer_nn_distances, pointcloud_f_iou
from baseboostdepth_tpu_torch.utils import readlines, resolve_splits_dir

SYNS_METRIC_NAMES = (
    "abs_rel", "err", "sq_rel", "rmse", "rmse_log", "edge_acc", "edge_comp",
)
EDGE_TH = 10


def syns_intrinsics() -> np.ndarray:
    """3x3 K from the KITTI FOV (25.46 deg, 84.10 deg) at 376x1242."""
    Fy, Fx = 25.46, 84.10
    h, w = 376, 1242
    cx, cy = w // 2, h // 2
    fx = cx / np.tan(np.deg2rad(Fx) / 2)
    fy = cy / np.tan(np.deg2rad(Fy) / 2)
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)


def to_log_depth(depth: np.ndarray) -> np.ndarray:
    return (depth > 0) * np.log(depth.clip(min=1.1920928955078125e-07))


def predicted_edges(depth: np.ndarray) -> np.ndarray:
    """Log-depth -> Gaussian blur -> Sobel magnitude -> above-mean mask
    (evaluate_depth.py:260-265)."""
    import cv2

    d = to_log_depth(depth)
    d = cv2.GaussianBlur(d, (3, 3), sigmaX=1, sigmaY=1)
    dx = cv2.Sobel(src=d, ddepth=cv2.CV_64F, dx=1, dy=0, ksize=5)
    dy = cv2.Sobel(src=d, ddepth=cv2.CV_64F, dx=0, dy=1, ksize=5)
    mag = np.sqrt(dx**2 + dy**2)
    return mag > mag.mean()


def edge_metrics(gt_edge: np.ndarray, pred_edge: np.ndarray, mask: np.ndarray):
    """EDT-based edge accuracy / completeness (evaluate_depth.py:89-95)."""
    from scipy import ndimage

    m = np.logical_and(mask, gt_edge)
    D_target = ndimage.distance_transform_edt(1 - m)
    D_pred = ndimage.distance_transform_edt(1 - pred_edge)
    pred_sel = pred_edge & (D_target < EDGE_TH)
    edge_acc = D_target[pred_sel].mean() if pred_sel.sum() else EDGE_TH
    edge_comp = D_pred[m].mean() if pred_sel.sum() else EDGE_TH
    return float(edge_acc), float(edge_comp)


def backproject_points(depth: np.ndarray, inv_K3: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Masked [N, 3] camera-space point cloud from a dense depth map."""
    h, w = depth.shape
    # the reference's eval backprojection builds its grid with
    # meshgrid(arange(w), arange(h)) stacked as (x, y) (evaluate_depth.py:31-33)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1).astype(np.float32)
    rays = inv_K3 @ pix
    pts = rays * depth.reshape(1, -1)
    return pts.T[mask.reshape(-1)]


def evaluate_syns(
    cfg: Config,
    depth_net: nn.Module,
    chamfer: bool = False,
    split: str = "SYNS",
    file_name: str = "test_files.txt",
    device="cuda",
) -> dict:
    """Full SYNS evaluation of a depth network. Pass
    file_name='val_files.txt' for the online-validation variant (reference
    trainer.py:646-663 runs the SYNS val split during training)."""
    import cv2

    st = eval_static(cfg)
    split_dir = os.path.join(resolve_splits_dir(cfg.data.splits_dir), split)
    files = readlines(os.path.join(split_dir, file_name))
    paths = []
    for ln in files:
        folder, frame = ln.split()
        paths.append(os.path.join(cfg.data.syns_path, "images", folder, f"{frame}.png"))

    disps = predict_disparities(st, depth_net, paths, device=device)
    # val-split GT lives in *_val.npz sidecars (export_gt writes both)
    suffix = "_val" if file_name.startswith("val") else ""
    gt_depths = load_gt(os.path.join(split_dir, f"gt_depths{suffix}.npz"))
    gt_edges = load_gt(os.path.join(split_dir, f"gt_edges{suffix}.npz"))

    inv_K3 = np.linalg.pinv(syns_intrinsics())
    rows = []
    for i in range(disps.shape[0]):
        gt = np.asarray(gt_depths[i], dtype=np.float32)
        gh, gw = gt.shape[:2]
        pd = cv2.resize(disps[i], (gw, gh))
        pred_depth = pd if st.metric_depth else 1.0 / pd

        mask = np.logical_and(gt > M.KITTI_MIN_DEPTH, gt < M.SYNS_MAX_DEPTH)
        pred_m = pred_depth[mask]
        gt_m = gt[mask]
        ratio = np.median(gt_m) / np.median(pred_m)
        pred_m = np.clip(pred_m * ratio, M.KITTI_MIN_DEPTH, M.SYNS_MAX_DEPTH)
        pred_full = np.clip(pred_depth * ratio, M.KITTI_MIN_DEPTH, M.SYNS_MAX_DEPTH)

        abs_rel, sq_rel, rmse, rmse_log, *_ = M.compute_errors(gt_m, pred_m)
        err = float(np.abs(pred_m - gt_m).mean())

        ge = gt_edges[i]
        ge2 = ge[:, :, 0] if ge.ndim == 3 else ge
        pred_edge = predicted_edges(pred_full)
        edge_acc, edge_comp = edge_metrics(ge2.astype(bool), pred_edge, mask)

        row = [abs_rel, err, sq_rel, rmse, rmse_log, edge_acc, edge_comp]
        if chamfer:
            pred_pts = backproject_points(pred_full, inv_K3, mask)
            gt_pts = backproject_points(gt, inv_K3, mask)
            pnn, tnn = chamfer_nn_distances(pred_pts, gt_pts, device=device)
            f1, iou = pointcloud_f_iou(pnn, tnn, th=0.1)
            row += [f1, iou]
        rows.append(row)

    mean = np.array(rows).mean(0)
    names = list(SYNS_METRIC_NAMES) + (["f1", "iou"] if chamfer else [])
    return dict(zip(names, mean.tolist()))
