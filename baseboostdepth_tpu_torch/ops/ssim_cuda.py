"""Fused SSIM + L1 reprojection loss with a hand-derived backward, the
counterpart of `baseboostdepth_tpu/ops/ssim_pallas.py`.

Two kernels (`ops/csrc/ssim_fused.cu`): the forward, replacing
`_fwd_kernel`, computes the channel-averaged
0.85 * clip((1 - SSIM) / 2, 0, 1) + 0.15 * |pred - target| map in one pass
over the NHWC images; the backward, replacing `_bwd_kernel`, computes the
gradient into `pred` from the same window moments, through the box filter's
adjoint with the reflect fold. `reprojection_loss_fused` joins them as a
`torch.autograd.Function`.

Its gradient deliberately follows the Pallas kernel, not autodiff of
`ops/ssim.py`: the clip passes 0 at a bound (autodiff of `jnp.clip`: 0.5)
and the L1 term 0 where pred == target (`jnp.abs`: +1).

Each kernel wrapper (`ssim_fused_fwd`, `ssim_fused_bwd`) launches its
kernel for CUDA tensors, counting the launch in its `launches` attribute,
and runs its plain version (`*_reference`) for CPU tensors. Nothing swaps a
plain version in on a GPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from baseboostdepth_tpu_torch.ops.cuda_build import launch, load_library
from baseboostdepth_tpu_torch.ops.pad import pad1_adjoint

LIB_NAME = "ssim"
SOURCES = ("ssim_fused.cu",)

_C1 = 0.01**2
_C2 = 0.03**2
_W_SSIM = 0.85
_W_L1 = 0.15


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn, n_ptr in ((lib.bbd_ssim_fused_fwd, 3), (lib.bbd_ssim_fused_bwd, 4)):
        fn.argtypes = [ptr] * n_ptr + [i64, i32, i32, ptr]
        fn.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------------
# Plain versions: the Pallas kernels' arithmetic on reflect-padded planes
# --------------------------------------------------------------------------
def _pad_planar(img: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] -> reflect-padded planar [N, 3, H+2, W+2]."""
    return F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")


def _box3(v: torch.Tensor) -> torch.Tensor:
    """3x3 sum of padded [..., H+2, W+2] planes -> [..., H, W]: three-tap
    row sums, then the three rows (the Pallas kernel's order)."""
    r = v[..., :, :-2] + v[..., :, 1:-1] + v[..., :, 2:]
    return r[..., :-2, :] + r[..., 1:-1, :] + r[..., 2:, :]


def _moments(xp: torch.Tensor, yp: torch.Tensor):
    mu_x = _box3(xp) * (1.0 / 9.0)
    mu_y = _box3(yp) * (1.0 / 9.0)
    exx = _box3(xp * xp) * (1.0 / 9.0)
    eyy = _box3(yp * yp) * (1.0 / 9.0)
    exy = _box3(xp * yp) * (1.0 / 9.0)
    return mu_x, mu_y, exx - mu_x * mu_x, eyy - mu_y * mu_y, exy - mu_x * mu_y


def _box_adjoint(v: torch.Tensor) -> torch.Tensor:
    """Adjoint of (reflect-pad 1 + 3x3 mean): [..., H, W] -> [..., H, W].

    Spread each window value over its 9 padded-domain taps (zero-padded box
    sum / 9 -> [..., H+2, W+2]), then fold the reflected border back
    (padded index -1 reflects to 1, H to H-2)."""
    vp = F.pad(v, (2, 2, 2, 2))
    r = vp[..., :, :-2] + vp[..., :, 1:-1] + vp[..., :, 2:]
    t = (r[..., :-2, :] + r[..., 1:-1, :] + r[..., 2:, :]) * (1.0 / 9.0)
    return pad1_adjoint(t)


def ssim_fused_fwd_reference(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: pred, target float32
    [N, H, W, 3] -> the channel-averaged loss map float32 [N, H, W, 1]."""
    xp = _pad_planar(pred)
    yp = _pad_planar(target)
    mu_x, mu_y, sxx, syy, sxy = _moments(xp, yp)
    n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sxy + _C2)
    d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sxx + syy + _C2)
    s = torch.clamp((1.0 - n / d) * 0.5, 0.0, 1.0)
    l1 = torch.abs(xp[..., 1:-1, 1:-1] - yp[..., 1:-1, 1:-1])
    term = (_W_SSIM * s + _W_L1 * l1) * (1.0 / 3.0)
    return (term[:, 0] + term[:, 1] + term[:, 2])[..., None]


def ssim_fused_bwd_reference(
    pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Plain version of the backward kernel: the hand-derived gradient into
    pred float32 [N, H, W, 3] of the loss map under its cotangent g float32
    [N, H, W, 1] (not autodiff: see the module docstring for the
    subgradients)."""
    xp = _pad_planar(pred)
    yp = _pad_planar(target)
    g = g[..., 0][:, None]  # [N, 1, H, W], shared by the three channels
    mu_x, mu_y, sxx, syy, sxy = _moments(xp, yp)
    n1 = 2.0 * mu_x * mu_y + _C1
    n2 = 2.0 * sxy + _C2
    d1 = mu_x * mu_x + mu_y * mu_y + _C1
    d2 = sxx + syy + _C2
    n = n1 * n2
    d = d1 * d2
    q = (1.0 - n / d) * 0.5
    active = ((q > 0.0) & (q < 1.0)).to(torch.float32)
    # upstream through the clip and the -1/2: u * d(n/d)
    u = g * active * (-0.5 * _W_SSIM / 3.0)
    A = u / d
    Bc = -(u * n) / (d * d)
    S1 = 2.0 * A * n1  # on the box of x*y
    S2 = Bc * d1  # on the box of x^2
    M = 2.0 * mu_y * A * (n2 - n1) + 2.0 * mu_x * Bc * (d2 - d1)
    xc = xp[..., 1:-1, 1:-1]
    yc = yp[..., 1:-1, 1:-1]
    gx = (
        _box_adjoint(M)
        + yc * _box_adjoint(S1)
        + 2.0 * xc * _box_adjoint(S2)
        + (_W_L1 / 3.0) * g * torch.sign(xc - yc)
    )
    return gx.permute(0, 2, 3, 1).contiguous()


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _check_kernel_args(what, pred, target, g=None):
    tensors = {"pred": pred, "target": target}
    if g is not None:
        tensors["g"] = g
    dev = pred.device
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors.values()]}")
    if pred.dtype != torch.float32 or pred.ndim != 4 or pred.shape[-1] != 3:
        raise TypeError(f"{what}: pred must be float32 [N, H, W, 3], got "
                        f"{pred.dtype} {tuple(pred.shape)}")
    if target.dtype != torch.float32 or target.shape != pred.shape:
        raise TypeError(f"{what}: target must be float32 {tuple(pred.shape)}, got "
                        f"{target.dtype} {tuple(target.shape)}")
    if g is not None and (g.dtype != torch.float32 or tuple(g.shape) != (*pred.shape[:3], 1)):
        raise TypeError(f"{what}: g must be float32 {(*pred.shape[:3], 1)}, got "
                        f"{g.dtype} {tuple(g.shape)}")
    N, H, W, _ = pred.shape
    if H < 2 or W < 2:
        raise ValueError(f"{what}: reflect padding needs H, W >= 2, got {H}x{W}")
    if N < 1:
        raise ValueError(f"{what}: N must be at least 1, got {N}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def ssim_fused_fwd(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred, target float32 [N, H, W, 3] -> the loss map float32
    [N, H, W, 1].

    CUDA tensors launch the kernel (counted in `ssim_fused_fwd.launches`);
    CPU tensors run the plain version.
    """
    _check_kernel_args("ssim_fused_fwd", pred, target)
    if pred.device.type == "cpu":
        return ssim_fused_fwd_reference(pred, target)
    out = torch.empty((*pred.shape[:3], 1), dtype=torch.float32, device=pred.device)
    launch(_lib(), "bbd_ssim_fused_fwd", (pred, target, out), pred.shape[:3])
    ssim_fused_fwd.launches += 1
    return out


ssim_fused_fwd.launches = 0


def ssim_fused_bwd(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient into pred float32 [N, H, W, 3] of the loss map under
    its cotangent g float32 [N, H, W, 1].

    CUDA tensors launch the kernel (counted in `ssim_fused_bwd.launches`);
    CPU tensors run the plain version.
    """
    _check_kernel_args("ssim_fused_bwd", pred, target, g)
    if pred.device.type == "cpu":
        return ssim_fused_bwd_reference(pred, target, g)
    gx = torch.empty_like(pred)
    launch(_lib(), "bbd_ssim_fused_bwd", (pred, target, g, gx), pred.shape[:3])
    ssim_fused_bwd.launches += 1
    return gx


ssim_fused_bwd.launches = 0


class _FusedReprojectionLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target):
        pred = pred.contiguous()
        target = target.contiguous()
        ctx.save_for_backward(pred, target)
        return ssim_fused_fwd(pred, target)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        return ssim_fused_bwd(pred, target, g.contiguous()), None


def reprojection_loss_fused(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1, channel-averaged: pred, target [N, H, W, 3]
    -> float32 [N, H, W, 1], through the fused kernels.

    The same values as `ops.ssim.reprojection_loss(use_ssim=True)`, but the
    gradient flows into `pred` ONLY: `target`'s gradient is None, whether or
    not it requires one. In training every photometric target is raw camera
    data, so nothing is lost there; where a differentiable target matters,
    use `ops.ssim.reprojection_loss`.
    """
    return _FusedReprojectionLoss.apply(pred.float(), target.float())
