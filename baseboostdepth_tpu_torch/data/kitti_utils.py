"""KITTI calibration parsing and velodyne -> sparse depth projection, a copy
of `baseboostdepth_tpu/data/kitti_utils.py` (host-side numpy; the GT depth
export of the eval slice reads it).

Behavior parity with the reference kitti_utils.py:17-98 (same KITTI
matlab-compatible rounding and duplicate resolution), with vectorized
duplicate handling (np.minimum.at) instead of a python loop over Counter
buckets.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI calib txt into a dict of float arrays (strings kept
    verbatim when non-numeric)."""
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                out[key] = np.array([float(v) for v in value.split()])
            except ValueError:
                out[key] = value  # type: ignore[assignment]
    return out


def load_velodyne_points(filename: str) -> np.ndarray:
    pts = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def generate_depth_map(
    calib_dir: str, velo_filename: str, cam: int = 2, vel_depth: bool = False
) -> np.ndarray:
    """Project velodyne points into camera `cam`, returning a sparse depth
    image with nearest-point wins on collisions."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.hstack((velo2cam_raw["R"].reshape(3, 3), velo2cam_raw["T"][..., None]))
    velo2cam = np.vstack((velo2cam, np.array([0, 0, 0, 1.0])))

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)  # (H, W)

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ velo2cam

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0]

    pts = (P_velo2im @ velo.T).T
    pts[:, :2] = pts[:, :2] / pts[:, 2:3]
    if vel_depth:
        pts[:, 2] = velo[:, 0]

    # KITTI matlab-compatible rounding (-1 offset)
    xs = np.round(pts[:, 0]) - 1
    ys = np.round(pts[:, 1]) - 1
    valid = (xs >= 0) & (ys >= 0) & (xs < im_shape[1]) & (ys < im_shape[0])
    xs, ys, zs = xs[valid].astype(np.int64), ys[valid].astype(np.int64), pts[valid, 2]

    depth = np.full(tuple(im_shape), np.inf, dtype=np.float64)
    np.minimum.at(depth, (ys, xs), zs)  # nearest point wins on collisions
    depth[np.isinf(depth)] = 0
    depth[depth < 0] = 0
    return depth
