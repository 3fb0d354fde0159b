"""Bilinear grid sampling (the warp), the counterpart of
`baseboostdepth_tpu/ops/sampling.py`.

Semantics of the reference's F.grid_sample(align_corners=True,
padding_mode="border") (trainer.py:439,442): x_px = (gx + 1)/2 * (W - 1),
coordinates clamped into the image before interpolation (so grid gradients
vanish outside it), gradients into both the image and the grid.
"""

from __future__ import annotations

import torch

from baseboostdepth_tpu_torch.ops import clip
from baseboostdepth_tpu_torch.ops.warp_cuda import bilinear_sample_corner_u8


def bilinear_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `img` [..., H, W, C] at `grid` [..., Ho, Wo, 2] (normalized,
    align_corners=True), bilinear, border-clamped -> [..., Ho, Wo, C].

    The plain formulation of the JAX package (sampling.py:29-80): four
    flattened gathers and the weight FMAs; differentiable in both inputs.
    """
    H, W, C = img.shape[-3:]
    lead = img.shape[:-3]
    Ho, Wo = grid.shape[-3:-1]

    imgf = img.reshape(-1, H * W, C)
    gridf = grid.reshape(-1, Ho * Wo, 2)

    x = clip((gridf[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = clip((gridf[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)

    def gather(yi, xi):
        idx = (yi * W + xi)[..., None].expand(-1, -1, C)
        return torch.gather(imgf, 1, idx)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x1i)
    v10 = gather(y1i, x0i)
    v11 = gather(y1i, x1i)

    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    out = top + (bot - top) * wy
    return out.reshape(*lead, Ho, Wo, C)


def resolve_warp(sources: torch.Tensor):
    """The training step's warp for `sources` [..., H, W, 3].

    uint8 frames: the corner-plane warp (ops/warp_cuda.py), which launches
    the CUDA kernel for CUDA tensors and runs its plain version for CPU
    tensors. Float sources need the float-planes kernel pair, not ported
    yet. The plain `bilinear_sample` above is the kernels' yardstick in the
    tests and never the step's warp.
    """
    if sources.dtype != torch.uint8:
        raise NotImplementedError(
            "the kernel warp of float sources (float-planes warp pair) is not "
            "ported yet: ROADMAP.md queue B, item B4"
        )
    return bilinear_sample_corner_u8
