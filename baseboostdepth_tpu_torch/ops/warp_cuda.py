"""Bilinear warp of uint8 RGB frames, the counterpart of the packed-uint8
half of `baseboostdepth_tpu/ops/warp_pallas.py`. Two routes, one library
(`ops/csrc/corner_sweep.cu` + `ops/csrc/warp_packed.cu`):

- The corner-plane warp (`bilinear_sample_corner_u8`, the step's default).
  Its kernel (`corner_sweep.cu`, replacing `_corner_kernel`) gathers the four
  bilinear corner texels of every output pixel as packed RGB int32 words.
  Its outputs are integers and its coordinates are detached, so no gradient
  crosses it and it needs no backward kernel: the unpack, the blend and the
  grid gradient are plain PyTorch autodiff over the corner planes
  (d out / d px = (1-wy)(v01-v00) + wy(v11-v10), floor contributing zero),
  the same on both devices.
- The packed warp (`bilinear_sample_packed_u8`, the step's
  `warp_impl="pallas"`). A forward kernel (`warp_packed.cu`, replacing
  `_fwd_kernel_packed`) gathers and blends in one pass, and a backward
  kernel (replacing `_bwd_kernel_packed`) re-gathers the corners and writes
  the coordinate gradients, as a `torch.autograd.Function`.

Each kernel wrapper (`corner_sweep`, `warp_packed_fwd`, `warp_packed_bwd`)
launches its kernel for CUDA tensors, counting the launch in its
`launches` attribute, and runs its plain version (`*_reference`) for CPU
tensors. Nothing swaps a plain version in on a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from baseboostdepth_tpu_torch.ops import clip
from baseboostdepth_tpu_torch.ops.cuda_build import launch, load_library

LIB_NAME = "warp"
SOURCES = ("corner_sweep.cu", "warp_packed.cu")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn, n_ptr in ((lib.bbd_corner_sweep_u8, 4), (lib.bbd_warp_packed_fwd, 4),
                      (lib.bbd_warp_packed_bwd, 6)):
        fn.argtypes = [ptr] * n_ptr + [i64] + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
    return lib


def pack_rgb(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> packed int32 [..., H, W] (R | G<<8 | B<<16)."""
    f = frames_u8.to(torch.int32)
    return f[..., 0] | (f[..., 1] << 8) | (f[..., 2] << 16)


def corner_sweep_reference(
    frames_u8: torch.Tensor, px: torch.Tensor, py: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel: frames uint8 [N, H, W, 3], clamped pixel
    coordinates px / py float32 [N, Ho, Wo] -> int32 [N, 4, Ho, Wo] holding
    the packed texels at (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    N, H, W, _ = frames_u8.shape
    _, Ho, Wo = px.shape
    packed = pack_rgb(frames_u8).reshape(N, H * W)
    x0 = torch.floor(px).long().clamp(0, W - 1)
    y0 = torch.floor(py).long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], dim=1)
    return torch.gather(packed, 1, idx.reshape(N, -1)).reshape(N, 4, Ho, Wo)


def _check_kernel_args(what, frames_u8, px, py, g=None):
    """Device, type, shape and contiguity checks shared by the three kernel
    wrappers (g: the packed backward's cotangent [N, Ho, Wo, 3])."""
    tensors = {"frames": frames_u8, "px": px, "py": py}
    if g is not None:
        tensors["g"] = g
    dev = frames_u8.device
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors.values()]}")
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise TypeError(f"{what}: frames must be uint8 [N, H, W, 3], got "
                        f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    N = frames_u8.shape[0]
    for name, c in (("px", px), ("py", py)):
        if c.dtype != torch.float32 or c.ndim != 3 or c.shape[0] != N:
            raise TypeError(f"{what}: {name} must be float32 [N={N}, Ho, Wo], "
                            f"got {c.dtype} {tuple(c.shape)}")
    if px.shape != py.shape:
        raise ValueError(f"{what}: px {tuple(px.shape)} != py {tuple(py.shape)}")
    if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != (*px.shape, 3)):
        raise TypeError(f"{what}: g must be float32 {(*px.shape, 3)}, got "
                        f"{g.dtype} {tuple(g.shape)}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def corner_sweep(frames_u8: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Corner planes int32 [N, 4, Ho, Wo] of frames uint8 [N, H, W, 3] at
    clamped pixel coordinates px / py float32 [N, Ho, Wo].

    CUDA tensors launch the kernel (and count the launch in
    `corner_sweep.launches`); CPU tensors run the plain version.
    """
    _check_kernel_args("corner_sweep", frames_u8, px, py)
    if frames_u8.device.type == "cpu":
        return corner_sweep_reference(frames_u8, px, py)
    N, H, W, _ = frames_u8.shape
    _, Ho, Wo = px.shape
    out = torch.empty((N, 4, Ho, Wo), dtype=torch.int32, device=frames_u8.device)
    launch(_lib(), "bbd_corner_sweep_u8", (frames_u8, px, py, out), (N, H, W, Ho, Wo))
    corner_sweep.launches += 1
    return out


corner_sweep.launches = 0


def _unpack_ch(v: torch.Tensor, c: int) -> torch.Tensor:
    return ((v >> (8 * c)) & 0xFF).to(torch.float32) * (1.0 / 255.0)


def _blend(corners: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """Corner planes int32 [N, 4, Ho, Wo] and weights [N, Ho, Wo] -> the
    bilinear blend float32 [N, Ho, Wo, 3], in the TPU kernels' order."""
    c00, c01, c10, c11 = corners.unbind(1)
    outs = []
    for c in range(3):
        v00 = _unpack_ch(c00, c)
        v01 = _unpack_ch(c01, c)
        v10 = _unpack_ch(c10, c)
        v11 = _unpack_ch(c11, c)
        top = v00 + (v01 - v00) * wx
        bot = v10 + (v11 - v10) * wx
        outs.append(top + (bot - top) * wy)
    return torch.stack(outs, dim=-1)


def pixel_coords(grid: torch.Tensor, N: int, H: int, W: int):
    """grid [..., Ho, Wo, 2] normalized (align_corners=True) over N images of
    H x W -> x, y float32 [N, Ho, Wo]: pixel coordinates clamped into the
    image by `ops.clip`, so the grid gradient saturates outside it (0.5 at
    exactly a border, as jnp.clip)."""
    Ho, Wo = grid.shape[-3:-1]
    x = clip((grid[..., 0].reshape(N, Ho, Wo) + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = clip((grid[..., 1].reshape(N, Ho, Wo) + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    return x.float().contiguous(), y.float().contiguous()


def _pixel_coords(frames_u8: torch.Tensor, grid: torch.Tensor):
    """frames_u8 [..., H, W, 3] uint8, grid [..., Ho, Wo, 2] -> (frames
    [N, H, W, 3], x, y [N, Ho, Wo]) as `pixel_coords` gives them."""
    H, W, C = frames_u8.shape[-3:]
    if C != 3 or frames_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 [..., H, W, 3], got {frames_u8.dtype} "
                        f"{tuple(frames_u8.shape)}")
    N = math.prod(frames_u8.shape[:-3])
    return (frames_u8.reshape(N, H, W, 3).contiguous(), *pixel_coords(grid, N, H, W))


def bilinear_sample_corner_u8(frames_u8: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear, border-clamped warp of uint8 RGB sources through the corner
    planes -> float32 in [0, 1].

    frames_u8 [..., H, W, 3] uint8, grid [..., Ho, Wo, 2] normalized
    (align_corners=True) -> [..., Ho, Wo, 3]. Differentiable in `grid`.
    """
    frames, x, y = _pixel_coords(frames_u8, grid)
    corners = corner_sweep(frames, x.detach(), y.detach())
    # d wx / d x = 1 (floor's gradient is zero)
    out = _blend(corners, x - torch.floor(x), y - torch.floor(y))
    return out.reshape(*frames_u8.shape[:-3], *out.shape[1:])


# --------------------------------------------------------------------------
# The packed warp: forward and backward kernels
# --------------------------------------------------------------------------
def warp_packed_fwd_reference(
    frames_u8: torch.Tensor, px: torch.Tensor, py: torch.Tensor
) -> torch.Tensor:
    """Plain version of the forward kernel: frames uint8 [N, H, W, 3],
    clamped pixel coordinates px / py float32 [N, Ho, Wo] -> the blended warp
    float32 [N, Ho, Wo, 3] in [0, 1]."""
    corners = corner_sweep_reference(frames_u8, px, py)
    return _blend(corners, px - torch.floor(px), py - torch.floor(py))


def warp_packed_bwd_reference(
    frames_u8: torch.Tensor, px: torch.Tensor, py: torch.Tensor, g: torch.Tensor
):
    """Plain version of the backward kernel: the cotangent g float32
    [N, Ho, Wo, 3] of the warp -> (gpx, gpy) float32 [N, Ho, Wo], the
    coordinate gradients summed over the channels:
    gpx = sum_c g_c ((1-wy)(v01-v00) + wy(v11-v10)),
    gpy = sum_c g_c ((1-wx)(v10-v00) + wx(v11-v01))."""
    c00, c01, c10, c11 = corner_sweep_reference(frames_u8, px, py).unbind(1)
    wx = px - torch.floor(px)
    wy = py - torch.floor(py)
    gpx = torch.zeros_like(px)
    gpy = torch.zeros_like(py)
    for c in range(3):
        v00 = _unpack_ch(c00, c)
        v01 = _unpack_ch(c01, c)
        v10 = _unpack_ch(c10, c)
        v11 = _unpack_ch(c11, c)
        gc = g[..., c]
        gpx = gpx + gc * ((1.0 - wy) * (v01 - v00) + wy * (v11 - v10))
        gpy = gpy + gc * ((1.0 - wx) * (v10 - v00) + wx * (v11 - v01))
    return gpx, gpy


def warp_packed_fwd(frames_u8: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The packed warp's forward: frames uint8 [N, H, W, 3], clamped pixel
    coordinates px / py float32 [N, Ho, Wo] -> float32 [N, Ho, Wo, 3].

    CUDA tensors launch the kernel (counted in `warp_packed_fwd.launches`);
    CPU tensors run the plain version.
    """
    _check_kernel_args("warp_packed_fwd", frames_u8, px, py)
    if frames_u8.device.type == "cpu":
        return warp_packed_fwd_reference(frames_u8, px, py)
    N, H, W, _ = frames_u8.shape
    _, Ho, Wo = px.shape
    out = torch.empty((N, Ho, Wo, 3), dtype=torch.float32, device=frames_u8.device)
    launch(_lib(), "bbd_warp_packed_fwd", (frames_u8, px, py, out), (N, H, W, Ho, Wo))
    warp_packed_fwd.launches += 1
    return out


warp_packed_fwd.launches = 0


def warp_packed_bwd(frames_u8: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                    g: torch.Tensor):
    """The packed warp's backward: the cotangent g float32 [N, Ho, Wo, 3]
    -> (gpx, gpy) float32 [N, Ho, Wo].

    CUDA tensors launch the kernel (counted in `warp_packed_bwd.launches`);
    CPU tensors run the plain version.
    """
    _check_kernel_args("warp_packed_bwd", frames_u8, px, py, g)
    if frames_u8.device.type == "cpu":
        return warp_packed_bwd_reference(frames_u8, px, py, g)
    N, H, W, _ = frames_u8.shape
    _, Ho, Wo = px.shape
    gpx = torch.empty((N, Ho, Wo), dtype=torch.float32, device=frames_u8.device)
    gpy = torch.empty_like(gpx)
    launch(_lib(), "bbd_warp_packed_bwd", (frames_u8, px, py, g, gpx, gpy), (N, H, W, Ho, Wo))
    warp_packed_bwd.launches += 1
    return gpx, gpy


warp_packed_bwd.launches = 0


class _PackedWarp(torch.autograd.Function):
    """The warp of uint8 frames at clamped pixel coordinates, differentiable
    in the coordinates only (the frames are training data)."""

    @staticmethod
    def forward(ctx, frames_u8, px, py):
        ctx.save_for_backward(frames_u8, px, py)
        return warp_packed_fwd(frames_u8, px, py)

    @staticmethod
    def backward(ctx, g):
        frames_u8, px, py = ctx.saved_tensors
        gpx, gpy = warp_packed_bwd(frames_u8, px, py, g.contiguous())
        return None, gpx, gpy


def bilinear_sample_packed_u8(frames_u8: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear, border-clamped warp of uint8 RGB sources through the packed
    forward and backward kernels -> float32 in [0, 1]; the counterpart of
    the JAX package's `bilinear_sample_pallas_u8`.

    frames_u8 [..., H, W, 3] uint8, grid [..., Ho, Wo, 2] normalized
    (align_corners=True) -> [..., Ho, Wo, 3]. Differentiable in `grid`; the
    same values as `bilinear_sample_corner_u8` (same gather, same blend),
    with the grid gradient from the backward kernel instead of autodiff.
    """
    frames, x, y = _pixel_coords(frames_u8, grid)
    out = _PackedWarp.apply(frames, x, y)
    return out.reshape(*frames_u8.shape[:-3], *out.shape[1:])
