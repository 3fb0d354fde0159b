"""Corner-plane bilinear warp of uint8 RGB frames, the counterpart of the
corner-plane path of `baseboostdepth_tpu/ops/warp_pallas.py`.

The kernel (`ops/csrc/corner_sweep.cu`, replacing `_corner_kernel`) gathers
the four bilinear corner texels of every output pixel as packed RGB int32
words. Its outputs are integers and its coordinates are detached, so no
gradient crosses it and it needs no backward kernel: the unpack, the blend
and the grid gradient are plain PyTorch autodiff over the corner planes
(d out / d px = (1-wy)(v01-v00) + wy(v11-v10), floor contributing zero),
the same on both devices.

`corner_sweep` launches the kernel for CUDA tensors and runs
`corner_sweep_reference`, its plain version, for CPU tensors. Nothing swaps
the plain version in on a GPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from baseboostdepth_tpu_torch.ops import clip
from baseboostdepth_tpu_torch.ops.cuda_build import load_library

_SOURCES = ("corner_sweep.cu",)


def _lib() -> ctypes.CDLL:
    lib = load_library("corner_sweep", _SOURCES)
    fn = lib.bbd_corner_sweep_u8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bbd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bbd_cuda_error_string.restype = ctypes.c_char_p
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


def _check_kernel_args(frames_u8, px, py):
    dev = frames_u8.device
    if px.device != dev or py.device != dev:
        raise ValueError(f"corner_sweep: tensors on {dev}, {px.device}, {py.device}")
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise TypeError(f"corner_sweep: frames must be uint8 [N, H, W, 3], got "
                        f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    N = frames_u8.shape[0]
    for name, c in (("px", px), ("py", py)):
        if c.dtype != torch.float32 or c.ndim != 3 or c.shape[0] != N:
            raise TypeError(f"corner_sweep: {name} must be float32 [N={N}, Ho, Wo], "
                            f"got {c.dtype} {tuple(c.shape)}")
    if px.shape != py.shape:
        raise ValueError(f"corner_sweep: px {tuple(px.shape)} != py {tuple(py.shape)}")
    for name, t in (("frames", frames_u8), ("px", px), ("py", py)):
        if not t.is_contiguous():
            raise ValueError(f"corner_sweep: {name} must be contiguous")


def corner_sweep(frames_u8: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Corner planes int32 [N, 4, Ho, Wo] of frames uint8 [N, H, W, 3] at
    clamped pixel coordinates px / py float32 [N, Ho, Wo].

    CUDA tensors launch the kernel (and count the launch in
    `corner_sweep.launches`); CPU tensors run the plain version.
    """
    _check_kernel_args(frames_u8, px, py)
    dev = frames_u8.device
    if dev.type == "cpu":
        return corner_sweep_reference(frames_u8, px, py)
    if dev.type != "cuda":
        raise ValueError(f"corner_sweep: unsupported device {dev}")
    N, H, W, _ = frames_u8.shape
    _, Ho, Wo = px.shape
    out = torch.empty((N, 4, Ho, Wo), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bbd_corner_sweep_u8(
            frames_u8.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            N, H, W, Ho, Wo, stream,
        )
    if err != 0:
        msg = lib.bbd_cuda_error_string(err).decode()
        raise RuntimeError(f"corner_sweep kernel launch failed: {msg} ({err})")
    corner_sweep.launches += 1
    return out


corner_sweep.launches = 0


def bilinear_sample_corner_u8(frames_u8: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear, border-clamped warp of uint8 RGB sources through the corner
    planes -> float32 in [0, 1].

    frames_u8 [..., H, W, 3] uint8, grid [..., Ho, Wo, 2] normalized
    (align_corners=True) -> [..., Ho, Wo, 3]. Differentiable in `grid`.
    """
    H, W, C = frames_u8.shape[-3:]
    if C != 3 or frames_u8.dtype != torch.uint8:
        raise TypeError(f"expected uint8 [..., H, W, 3], got {frames_u8.dtype} "
                        f"{tuple(frames_u8.shape)}")
    lead = frames_u8.shape[:-3]
    Ho, Wo = grid.shape[-3:-1]
    N = math.prod(lead)

    x = clip((grid[..., 0].reshape(N, Ho, Wo) + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = clip((grid[..., 1].reshape(N, Ho, Wo) + 1.0) * 0.5 * (H - 1), 0.0, H - 1)

    corners = corner_sweep(
        frames_u8.reshape(N, H, W, 3).contiguous(),
        x.detach().contiguous(),
        y.detach().contiguous(),
    )

    # d wx / d x = 1 (floor's gradient is zero); the clip above saturates
    # the gradient outside the image, as torch border mode does
    wx = x - torch.floor(x)
    wy = y - torch.floor(y)
    c00, c01, c10, c11 = corners.unbind(1)

    def unpack_ch(v, c):
        return ((v >> (8 * c)) & 0xFF).to(torch.float32) * (1.0 / 255.0)

    outs = []
    for c in range(3):
        v00 = unpack_ch(c00, c)
        v01 = unpack_ch(c01, c)
        v10 = unpack_ch(c10, c)
        v11 = unpack_ch(c11, c)
        top = v00 + (v01 - v00) * wx
        bot = v10 + (v11 - v10) * wx
        outs.append(top + (bot - top) * wy)
    return torch.stack(outs, dim=-1).reshape(*lead, Ho, Wo, 3)
