"""Chamfer nearest-neighbour distances in plain PyTorch, the counterpart of
`baseboostdepth_tpu/ops/chamfer.py` (which replaced the reference's external
CUDA `chamfer_distance` extension, evaluate_depth.py:18-20,81-87).

The same blocked brute-force search and the same expansion:

    |p - q|^2 = |p|^2 + |q|^2 - 2 p.q

over [TILE_N, TILE_M] tiles with a running minimum over target tiles, so
peak memory stays at one tile; point clouds are padded to tile multiples and
padded targets masked with _BIG. The JAX package computes this outside any
Pallas kernel (an XLA matrix product), so it is plain torch here.

Precision: the expansion cancels catastrophically. At SYNS depths (up to
125 m, |p|^2 near 1.6e4) a TF32 product would err by tens of m^2 against a
0.1 m F-score threshold, so p.q (K = 3) is a float32 multiply and two
fused multiply-adds on broadcast tiles, never a matrix product that a TF32
setting could reach; the norms take the same form.
"""

from __future__ import annotations

import numpy as np
import torch

from baseboostdepth_tpu_torch.device import require_device

_TILE_N = 2048
_TILE_M = 8192
_BIG = 1e30


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    return torch.cat([x, x.new_zeros((pad, x.shape[1]))]) if pad else x


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] * b[..., k] over K = 3 as a multiply and two fused
    multiply-adds, in k order: the order (and the FMAs) of the JAX package's
    contractions on the CPU. Broadcasts a against b."""
    d = a[..., 0] * b[..., 0]
    d.addcmul_(a[..., 1], b[..., 1])
    d.addcmul_(a[..., 2], b[..., 2])
    return d


def _nn_dist2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p [N, 3], q [M, 3] float32 -> [N] squared distance of each p to its
    nearest q, in tiles of [_TILE_N, _TILE_M]."""
    n, m = p.shape[0], q.shape[0]
    p = _pad_rows(p, _TILE_N)
    q = _pad_rows(q, _TILE_M)
    q2 = _dot3(q, q)
    q2[m:] = _BIG  # mask padded targets
    best = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    for i in range(0, p.shape[0], _TILE_N):
        pb = p[i : i + _TILE_N]
        pb2 = _dot3(pb, pb)[:, None]
        run = torch.full((_TILE_N,), _BIG, dtype=torch.float32, device=p.device)
        for j in range(0, q.shape[0], _TILE_M):
            dots = _dot3(pb[:, None, :], q[None, j : j + _TILE_M, :])
            d2 = (pb2 + q2[None, j : j + _TILE_M]).add_(dots, alpha=-2.0)
            run = torch.minimum(run, d2.amin(dim=1))
        best[i : i + _TILE_N] = run
    return best[:n]


def chamfer_nn_distances(pred_pts: np.ndarray, target_pts: np.ndarray, device="cuda"):
    """Bidirectional nearest-neighbour distances (NOT squared), like the
    reference's `cham(pred, target)` + sqrt (evaluate_depth.py:83-84).

    Args:
      pred_pts, target_pts: [N, 3] / [M, 3] float arrays.
      device: where the search runs (the GPU unless the caller asks for the
        CPU).
    Returns:
      (pred_nn [N], target_nn [M]) numpy arrays.
    """
    device = require_device(device)
    p = torch.as_tensor(np.asarray(pred_pts, np.float32), device=device)
    q = torch.as_tensor(np.asarray(target_pts, np.float32), device=device)
    pred_nn2 = _nn_dist2(p, q).cpu().numpy()
    tgt_nn2 = _nn_dist2(q, p).cpu().numpy()
    return np.sqrt(np.maximum(pred_nn2, 0)), np.sqrt(np.maximum(tgt_nn2, 0))


def pointcloud_f_iou(pred_nn: np.ndarray, target_nn: np.ndarray, th: float = 0.1):
    """F-score / IoU at threshold th (reference _metrics_pointcloud,
    evaluate_depth.py:49-55)."""
    P = float((pred_nn < th).mean())
    R = float((target_nn < th).mean())
    if P < 1e-3 and R < 1e-3:
        return P, P
    f = 2 * P * R / (P + R)
    iou = P * R / (P + R - P * R)
    return f, iou
