"""Image resizing, the counterpart of `baseboostdepth_tpu/ops/resize.py`:
bilinear (F.interpolate parity, half-pixel and align_corners=True), nearest
2x upsample, and the Lanczos
pyramid that replaces the reference's host-side PIL cascade
(mono_dataset.py:187-204).

PyTorch has no Lanczos mode, so `resize_lanczos` rebuilds the separable
weight matrices of `jax.image.resize(..., "lanczos3", antialias=True)`
(jax/_src/image/scale.py: `_fill_lanczos_kernel`, `compute_weight_mat`):
half-pixel sample positions, the kernel widened by the downscale factor,
columns normalised to sum 1 and zeroed where the sample falls outside the
input. It is applied as two matrix products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NHWC tensor (reference
    layers.py:197-200)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear NHWC resize, align_corners=False (half-pixel), as the
    reference's F.interpolate (trainer.py:456)."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear", align_corners=False
    )
    return y.permute(0, 2, 3, 1)


def resize_bilinear_align_corners(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear NCHW resize with align_corners=True (endpoints map to
    endpoints), as the SQLdepth BN decoder's F.interpolate
    (networksSQL/resnet_encoder.py:108). The size it already has is
    returned as it is, as the JAX function does."""
    if tuple(x.shape[-2:]) == (height, width):
        return x
    return F.interpolate(x, size=(height, width), mode="bilinear", align_corners=True)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = 3.0
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1), 1.0)
    return np.where(x > radius, 0.0, out)


@functools.lru_cache(maxsize=64)
def _lanczos_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 resampling matrix (antialiased)."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = _lanczos3(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T, dtype=np.float32)


def resize_lanczos(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Lanczos-3 antialiased NHWC resize (PIL Image.LANCZOS equivalent)."""
    _, H, W, _ = x.shape
    if H != height:
        wh = torch.from_numpy(_lanczos_weights(H, height)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", wh, x)
    if W != width:
        ww = torch.from_numpy(_lanczos_weights(W, width)).to(x.device, x.dtype)
        x = torch.einsum("ow,bhwc->bhoc", ww, x)
    return x


def lanczos_pyramid(x: torch.Tensor, num_scales: int = 4):
    """Cascaded /2 Lanczos pyramid of an NHWC image: [x, x/2, x/4, ...];
    each level resizes the previous one (mono_dataset.py:190-192)."""
    out = [x]
    for _ in range(1, num_scales):
        prev = out[-1]
        out.append(resize_lanczos(prev, prev.shape[1] // 2, prev.shape[2] // 2))
    return out
