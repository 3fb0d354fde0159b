"""KITTI odometry pose evaluation (ATE on sequences 09/10), the counterpart
of `baseboostdepth_tpu/evaluation/pose.py`.

Parity with the reference evaluate_pose.py:44-166: for every window, a
direct 2-frame pose across skip_frame=2 AND a chained (step-composed) pose,
both scored with the SfMLearner-style local ATE against GT poses. The
per-window pose-net calls are batched on the device; the pose network runs
in float32, as the JAX evaluator builds it.
"""

from __future__ import annotations

import functools
import os
from typing import List

import numpy as np
import torch
from torch import nn

from baseboostdepth_tpu_torch import geometry
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.data.loader import load_resized
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.utils import resolve_splits_dir


def dump_xyz(source_to_target_transformations) -> np.ndarray:
    """Integrate relative poses into xyz positions (SfMLearner protocol)."""
    xyzs = [np.eye(4)[:3, 3]]
    cam_to_world = np.eye(4)
    for T in source_to_target_transformations:
        cam_to_world = cam_to_world @ T
        xyzs.append(cam_to_world[:3, 3])
    return np.array(xyzs)


def compute_ate(gtruth_xyz: np.ndarray, pred_xyz_o: np.ndarray) -> float:
    """Scale-aligned absolute trajectory error (SfMLearner protocol)."""
    offset = gtruth_xyz[0] - pred_xyz_o[0]
    pred_xyz = pred_xyz_o + offset[None, :]
    scale = np.sum(gtruth_xyz * pred_xyz) / np.sum(pred_xyz**2)
    alignment_error = pred_xyz * scale - gtruth_xyz
    return float(np.sqrt(np.sum(alignment_error**2)) / gtruth_xyz.shape[0])


def local_gt_poses(gt_global: np.ndarray, skip_frame: int) -> List[np.ndarray]:
    out = []
    for i in range(skip_frame, len(gt_global)):
        out.append(np.linalg.inv(np.linalg.inv(gt_global[i - skip_frame]) @ gt_global[i]))
    return out


def make_pose_forward(device="cuda"):
    """Build pose_fwd(pose_net, pairs float [N, H, W, 6]) -> [N, 4, 4]
    numpy float32 poses (invert=False), the network in eval mode without
    gradients."""
    device = require_device(device)

    @torch.no_grad()
    def pose_fwd(pose_net: nn.Module, pairs: np.ndarray) -> np.ndarray:
        pose_net.eval()
        aa, t = pose_net(torch.as_tensor(pairs).to(device, torch.float32))
        return geometry.transformation_from_parameters(aa, t, invert=False).cpu().numpy()

    return pose_fwd


def evaluate_odometry(
    cfg: Config,
    pose_net: nn.Module,
    sequence_id: int,
    gt_poses_path: str,
    skip_frame: int = 2,
    batch_size: int = 16,
    device="cuda",
) -> dict:
    """Returns {'ate_direct', 'ate_direct_std', 'ate_chained',
    'ate_chained_std'} for odometry sequence 09 or 10."""
    H, W = cfg.data.height, cfg.data.width
    split = os.path.join(resolve_splits_dir(cfg.data.splits_dir), "odom",
                         f"test_files_{sequence_id:02d}.txt")
    index = kitti.KittiOdomIndex(cfg.data.kt_path, split)
    pose_fwd = functools.partial(make_pose_forward(device), pose_net)  # [N,H,W,6] -> [N,4,4]

    # frame list for the sequence: consecutive windows over the index
    frames = sorted({s.frame_index for s in index.samples})
    seq = str(index.samples[0].folder)

    def img(fi):
        return load_resized(index.image_path(seq, fi), W, H).astype(np.float32) / 255.0

    direct, chained = [], []
    cache = {}

    def get(fi):
        if fi not in cache:
            cache[fi] = img(fi)
        if len(cache) > 64:
            cache.pop(next(iter(cache)))
        return cache[fi]

    pend_direct, pend_steps = [], []
    for fi in frames:
        try:
            i0, i1, i2 = get(fi), get(fi + 1), get(fi + skip_frame)
        except FileNotFoundError:
            continue
        pend_direct.append(np.concatenate([i0, i2], axis=-1))
        pend_steps.append(np.concatenate([i0, i1], axis=-1))
        pend_steps.append(np.concatenate([i1, i2], axis=-1))

        if len(pend_direct) == batch_size:
            _flush(pose_fwd, pend_direct, pend_steps, direct, chained, skip_frame)
            pend_direct, pend_steps = [], []
    if pend_direct:
        _flush(pose_fwd, pend_direct, pend_steps, direct, chained, skip_frame)

    pred_direct = np.stack(direct)
    pred_chained = np.stack(chained)

    gt_global = np.loadtxt(gt_poses_path).reshape(-1, 3, 4)
    gt_global = np.concatenate([gt_global, np.zeros((len(gt_global), 1, 4))], axis=1)
    gt_global[:, 3, 3] = 1
    gt_local = local_gt_poses(gt_global, skip_frame)

    ates_d, ates_c = [], []
    n = min(len(pred_direct), len(gt_local))
    for i in range(n - skip_frame):
        gt_xyz = dump_xyz(gt_local[i : i + 1])
        ates_d.append(compute_ate(gt_xyz, dump_xyz(pred_direct[i : i + 1])))
        ates_c.append(compute_ate(gt_xyz, dump_xyz(pred_chained[i : i + 1])))

    return {
        "ate_direct": float(np.mean(ates_d)),
        "ate_direct_std": float(np.std(ates_d)),
        "ate_chained": float(np.mean(ates_c)),
        "ate_chained_std": float(np.std(ates_c)),
    }


def _flush(pose_fwd, pend_direct, pend_steps, direct, chained, skip_frame):
    Td = pose_fwd(np.stack(pend_direct))
    Ts = pose_fwd(np.stack(pend_steps))
    Ts = Ts.reshape(-1, skip_frame, 4, 4)
    for k in range(len(Td)):
        direct.append(Td[k])
        # chained: T = step_last @ ... @ step_first (reference
        # evaluate_pose.py:112-116 multiplies reversed steps)
        acc = np.eye(4)
        for s in range(skip_frame - 1, -1, -1):
            acc = acc @ Ts[k, s]
        chained.append(acc)
