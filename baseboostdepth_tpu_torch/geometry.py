"""Differentiable camera geometry in PyTorch, the counterpart of
`baseboostdepth_tpu/geometry.py` (reference layers.py:13-195).

Conventions follow the JAX package: images NHWC, pixel x = column, y = row,
poses are 4x4 matrices T mapping target-camera points into source-camera
points, and `warp_grid` returns torch.grid_sample normalized coordinates
([-1, 1], align_corners=True).

Precision: the JAX package forces Precision.HIGHEST on every 4x4
contraction, because a reduced-precision SE(3) chain drifts at the 1e-3
level. Here every small contraction is written as broadcast multiplies and
sums in float32, so no TF32 or reduced-precision matmul setting can reach
it.
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small matrix product [..., m, k] @ [..., k, n] in full fp32."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth); reference layers.py:13-22."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation: axis-angle [..., 3] -> rotation [..., 3, 3],
    with the reference's +1e-7 axis guard (layers.py:61-100)."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)

    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca

    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC

    return torch.stack(
        [
            torch.stack([x * xC + ca, xyC - zs, zxC + ys], dim=-1),
            torch.stack([xyC + zs, y * yC + ca, yzC - xs], dim=-1),
            torch.stack([zxC - ys, yzC + xs, z * zC + ca], dim=-1),
        ],
        dim=-2,
    )


def transformation_from_parameters(
    axisangle: torch.Tensor, translation: torch.Tensor, invert: bool = False
) -> torch.Tensor:
    """(axis-angle [..., 3], translation [..., 3]) -> SE(3) [..., 4, 4].

    invert=True builds R^T and -t and composes R_inv @ T_inv, as the
    reference does for negative frame offsets (layers.py:25-58).
    """
    R3 = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R3 = R3.transpose(-1, -2)
        t = -t
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])], -1).unsqueeze(-2)
    R = torch.cat([torch.cat([R3, torch.zeros_like(t).unsqueeze(-1)], -1), bottom], -2)
    eye3 = torch.eye(3, dtype=t.dtype, device=t.device).expand(*t.shape[:-1], 3, 3)
    T = torch.cat([torch.cat([eye3, t.unsqueeze(-1)], -1), bottom], -2)
    if invert:
        return _mm(R, T)
    return _mm(T, R)


def compose_poses(steps: torch.Tensor) -> torch.Tensor:
    """Chain step poses [..., N, 4, 4] (steps[g] = T(g -> g+1)) into
    cumulative poses out[g] = step_g @ ... @ step_0 = T(0 -> g+1)
    (reference trainer.py:362-373)."""
    out = []
    carry = None
    for g in range(steps.shape[-3]):
        step = steps[..., g, :, :]
        carry = step if carry is None else _mm(step, carry)
        out.append(carry)
    return torch.stack(out, dim=-3)


def pixel_rays(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid [H, W, 3] with entries (x, y, 1)."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def warp_grid(
    depth: torch.Tensor,
    K: torch.Tensor,
    inv_K: torch.Tensor,
    T: torch.Tensor,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Fused backproject -> transform -> project (reference BackprojectDepth
    layers.py:136-167 and Project3D layers.py:170-195).

    depth [B, H, W], K / inv_K / T [B, 4, 4] -> grid [B, H, W, 2] in
    grid_sample normalized coordinates. Per pixel: cam = d * (A @ v) + b with
    A = (K T)[:3, :3] @ inv_K[:3, :3], b = (K T)[:3, 3], v = (x, y, 1).
    """
    B, H, W = depth.shape
    P = _mm(K, T)[:, :3, :]  # [B, 3, 4]
    A = _mm(P[:, :, :3], inv_K[:, :3, :3])  # [B, 3, 3]
    b = P[:, :, 3]  # [B, 3]

    rays = pixel_rays(H, W, dtype=depth.dtype, device=depth.device)
    rx, ry = rays[..., 0], rays[..., 1]  # [H, W]
    A_ = A[:, None, None]  # [B, 1, 1, 3, 3]
    Av = A_[..., 0] * rx[..., None] + A_[..., 1] * ry[..., None] + A_[..., 2]  # [B, H, W, 3]
    cam = depth[..., None] * Av + b[:, None, None, :]

    pix_x = cam[..., 0] / (cam[..., 2] + eps)
    pix_y = cam[..., 1] / (cam[..., 2] + eps)

    gx = 2.0 * pix_x / (W - 1) - 1.0
    gy = 2.0 * pix_y / (H - 1) - 1.0
    return torch.stack([gx, gy], dim=-1)
