"""Bilinear warp of float images, the counterpart of the float-planes half of
`baseboostdepth_tpu/ops/warp_pallas.py` (`bilinear_sample_pallas`).

The training step warps float sources through it: a batch whose frames are
float rather than uint8 (StepStatic.warp_impl "auto", "corner" or "pallas"
alike, as in the JAX package, where "corner" only changes the uint8 path).
A forward kernel (`ops/csrc/warp_planes.cu`, replacing `_fwd_kernel`) gathers
the four corner texels of every output pixel from the float32 NHWC images and
blends each channel, and a backward kernel (replacing `_bwd_kernel`) re-gathers
them and writes the coordinate gradients summed over the channels, as a
`torch.autograd.Function`.

Each kernel wrapper (`warp_planes_fwd`, `warp_planes_bwd`) launches its kernel
for CUDA tensors, counting the launch in its `launches` attribute, and runs
its plain version (`*_reference`) for CPU tensors. Nothing swaps a plain
version in on a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from baseboostdepth_tpu_torch.ops.cuda_build import launch, load_library
from baseboostdepth_tpu_torch.ops.warp_cuda import pixel_coords

LIB_NAME = "warp_planes"
SOURCES = ("warp_planes.cu",)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn, n_ptr in ((lib.bbd_warp_planes_fwd, 4), (lib.bbd_warp_planes_bwd, 6)):
        fn.argtypes = [ptr] * n_ptr + [i64] + [i32] * 5 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def _corners(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """The four corner texels [N, Ho, Wo, C] of src [N, H, W, C] at clamped
    pixel coordinates px / py [N, Ho, Wo], and the weights wx, wy."""
    N, H, W, C = src.shape
    _, Ho, Wo = px.shape
    flat = src.reshape(N, H * W, C)
    x0 = torch.floor(px).long().clamp(0, W - 1)
    y0 = torch.floor(py).long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)

    def gather(yi, xi):
        idx = (yi * W + xi).reshape(N, Ho * Wo, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(N, Ho, Wo, C)

    return (gather(y0, x0), gather(y0, x1), gather(y1, x0), gather(y1, x1),
            px - torch.floor(px), py - torch.floor(py))


def warp_planes_fwd_reference(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Plain version of the forward kernel: src float32 [N, H, W, C], clamped
    pixel coordinates px / py float32 [N, Ho, Wo] -> float32 [N, Ho, Wo, C],
    blended in the TPU kernel's order."""
    v00, v01, v10, v11, wx, wy = _corners(src, px, py)
    wx, wy = wx[..., None], wy[..., None]
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    return top + (bot - top) * wy


def warp_planes_bwd_reference(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                              g: torch.Tensor):
    """Plain version of the backward kernel: the cotangent g float32
    [N, Ho, Wo, C] -> (gpx, gpy) float32 [N, Ho, Wo], summed over the
    channels in channel order:
    gpx = sum_c g_c ((1-wy)(v01-v00) + wy(v11-v10)),
    gpy = sum_c g_c ((1-wx)(v10-v00) + wx(v11-v01))."""
    v00, v01, v10, v11, wx, wy = _corners(src, px, py)
    gpx = torch.zeros_like(px)
    gpy = torch.zeros_like(py)
    for c in range(src.shape[-1]):
        a00, a01, a10, a11 = v00[..., c], v01[..., c], v10[..., c], v11[..., c]
        gc = g[..., c]
        gpx = gpx + gc * ((1.0 - wy) * (a01 - a00) + wy * (a11 - a10))
        gpy = gpy + gc * ((1.0 - wx) * (a10 - a00) + wx * (a11 - a01))
    return gpx, gpy


def _check_kernel_args(what, src, px, py, g=None):
    """Device, type, shape and contiguity checks of the two kernel wrappers
    (g: the backward's cotangent [N, Ho, Wo, C])."""
    tensors = {"src": src, "px": px, "py": py}
    if g is not None:
        tensors["g"] = g
    dev = src.device
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors.values()]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if src.dtype != torch.float32 or src.ndim != 4 or src.shape[-1] < 1:
        raise TypeError(f"{what}: src must be float32 [N, H, W, C], got "
                        f"{src.dtype} {tuple(src.shape)}")
    N, C = src.shape[0], src.shape[-1]
    for name, c in (("px", px), ("py", py)):
        if c.dtype != torch.float32 or c.ndim != 3 or c.shape[0] != N:
            raise TypeError(f"{what}: {name} must be float32 [N={N}, Ho, Wo], "
                            f"got {c.dtype} {tuple(c.shape)}")
    if px.shape != py.shape:
        raise ValueError(f"{what}: px {tuple(px.shape)} != py {tuple(py.shape)}")
    if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != (*px.shape, C)):
        raise TypeError(f"{what}: g must be float32 {(*px.shape, C)}, got "
                        f"{g.dtype} {tuple(g.shape)}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def warp_planes_fwd(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The float warp's forward: src float32 [N, H, W, C], clamped pixel
    coordinates px / py float32 [N, Ho, Wo] -> float32 [N, Ho, Wo, C].

    CUDA tensors launch the kernel (counted in `warp_planes_fwd.launches`);
    CPU tensors run the plain version.
    """
    _check_kernel_args("warp_planes_fwd", src, px, py)
    if src.device.type == "cpu":
        return warp_planes_fwd_reference(src, px, py)
    out = torch.empty((*px.shape, src.shape[-1]), dtype=torch.float32, device=src.device)
    launch(_lib(), "bbd_warp_planes_fwd", (src, px, py, out), (*src.shape, *px.shape[1:]))
    warp_planes_fwd.launches += 1
    return out


warp_planes_fwd.launches = 0


def warp_planes_bwd(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor, g: torch.Tensor):
    """The float warp's backward: the cotangent g float32 [N, Ho, Wo, C]
    -> (gpx, gpy) float32 [N, Ho, Wo].

    CUDA tensors launch the kernel (counted in `warp_planes_bwd.launches`);
    CPU tensors run the plain version.
    """
    _check_kernel_args("warp_planes_bwd", src, px, py, g)
    if src.device.type == "cpu":
        return warp_planes_bwd_reference(src, px, py, g)
    gpx = torch.empty(px.shape, dtype=torch.float32, device=src.device)
    gpy = torch.empty_like(gpx)
    launch(_lib(), "bbd_warp_planes_bwd", (src, px, py, g, gpx, gpy),
           (*src.shape, *px.shape[1:]))
    warp_planes_bwd.launches += 1
    return gpx, gpy


warp_planes_bwd.launches = 0


class _PlanesWarp(torch.autograd.Function):
    """The warp of float32 images at clamped pixel coordinates,
    differentiable in the coordinates only."""

    @staticmethod
    def forward(ctx, src, px, py):
        ctx.save_for_backward(src, px, py)
        return warp_planes_fwd(src, px, py)

    @staticmethod
    def backward(ctx, g):
        src, px, py = ctx.saved_tensors
        gpx, gpy = warp_planes_bwd(src, px, py, g.contiguous())
        return None, gpx, gpy


def bilinear_sample_planes(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear, border-clamped warp of float images through the forward
    and backward kernels; the counterpart of the JAX package's
    `bilinear_sample_pallas`.

    img [..., H, W, C] float, grid [..., Ho, Wo, 2] normalized
    (align_corners=True) -> [..., Ho, Wo, C] in img's dtype (computed in
    float32, as the TPU kernels compute). Differentiable in `grid` only: the
    image receives no gradient, as from the TPU kernel's VJP, which returns
    None for it. Pixel coordinates are clamped into the image by `ops.clip`
    (gradient 0.5 at exactly a border, as jnp.clip).
    """
    if not img.is_floating_point():
        raise TypeError(f"bilinear_sample_planes: img must be float, got {img.dtype}")
    H, W, C = img.shape[-3:]
    lead = img.shape[:-3]
    Ho, Wo = grid.shape[-3:-1]
    if grid.shape[-1] != 2 or grid.shape[:-3] != lead:
        raise ValueError(f"bilinear_sample_planes: grid {tuple(grid.shape)} does not match "
                         f"img {tuple(img.shape)}")
    N = math.prod(lead)
    x, y = pixel_coords(grid, N, H, W)
    src = img.detach().reshape(N, H, W, C).to(torch.float32).contiguous()
    out = _PlanesWarp.apply(src, x, y)
    return out.reshape(*lead, Ho, Wo, C).to(img.dtype)
