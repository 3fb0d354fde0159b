"""SSIM photometric dissimilarity, the counterpart of
`baseboostdepth_tpu/ops/ssim.py` (reference layers.py:219-249).

Reflect-pad(1), 3x3 stride-1 means of x, y, x^2, y^2 and xy, C1 = 0.01^2,
C2 = 0.03^2, output clip((1 - SSIM)/2, 0, 1). Images stay NHWC at the public
functions; the pools run on a channels-last NCHW view. Differentiable in
both arguments, as the JAX package's XLA path is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from baseboostdepth_tpu_torch.ops import absolute, clip

_C1 = 0.01**2
_C2 = 0.03**2


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y [B, H, W, C] -> per-pixel, per-channel [B, H, W, C] in [0, 1]."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")

    def pool(t):
        return F.avg_pool2d(t, 3, 1)

    mu_x = pool(xp)
    mu_y = pool(yp)
    sigma_x = pool(xp * xp) - mu_x * mu_x
    sigma_y = pool(yp * yp) - mu_y * mu_y
    sigma_xy = pool(xp * yp) - mu_x * mu_y

    ssim_n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    out = clip((1.0 - ssim_n / ssim_d) * 0.5, 0.0, 1.0)
    return out.permute(0, 2, 3, 1)


def reprojection_loss(
    pred: torch.Tensor, target: torch.Tensor, use_ssim: bool = True
) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1, channel-averaged -> [B, H, W, 1]
    (reference trainer.py:477-486)."""
    l1 = torch.mean(absolute(target - pred), dim=-1, keepdim=True)
    if not use_ssim:
        return l1
    s = torch.mean(ssim(pred, target), dim=-1, keepdim=True)
    return 0.85 * s + 0.15 * l1
