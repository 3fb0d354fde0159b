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
from baseboostdepth_tpu_torch.ops.warp_cuda import (
    bilinear_sample_corner_u8,
    bilinear_sample_packed_u8,
)
from baseboostdepth_tpu_torch.ops.warp_planes import bilinear_sample_planes


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


def resolve_warp(sources: torch.Tensor, impl: str = "auto"):
    """The training step's warp for `sources` [..., H, W, 3], from
    StepStatic.warp_impl.

    uint8 frames: "auto" or "corner" -> the corner-plane warp
    (`bilinear_sample_corner_u8`), "pallas" -> the packed warp
    (`bilinear_sample_packed_u8`); both in ops/warp_cuda.py. Float sources:
    "auto", "corner" and "pallas" alike -> the float-planes warp
    (`ops/warp_planes.py::bilinear_sample_planes`), as in the JAX package,
    where "corner" only changes the uint8 path and "auto" on the accelerator
    is the kernel. Each launches its CUDA kernels for CUDA tensors and runs
    their plain versions for CPU tensors. "xla" raises: it would run the
    plain `bilinear_sample` above on the card, and that is the kernels'
    yardstick in the tests, never the step's warp.
    """
    if impl not in ("auto", "corner", "pallas"):
        raise ValueError(
            f"warp_impl {impl!r}: the step's warps are 'auto' / 'corner' (the "
            f"corner-plane kernel) and 'pallas' (the packed kernel pair); the plain "
            f"float gather ('xla') is not a warp of the step"
        )
    if sources.dtype != torch.uint8:
        if not sources.is_floating_point():
            raise TypeError(f"warp sources must be uint8 or float, got {sources.dtype}")
        return bilinear_sample_planes
    return bilinear_sample_packed_u8 if impl == "pallas" else bilinear_sample_corner_u8
