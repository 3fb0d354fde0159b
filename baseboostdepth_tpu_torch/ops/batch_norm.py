"""Train-mode BatchNorm with the JAX package's statistics, and its kernel.

Every BatchNorm of the JAX package is flax's `nn.BatchNorm` (momentum 0.9,
epsilon 1e-5, `use_fast_variance=True`). In train mode it takes, per
channel, in float32 (float64 for a float64 input), over (N, H, W) and under
a data mesh over the global batch:

    mean = E[x],  var = max(E[x^2] - mean^2, 0),
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias,

cast back to x's dtype (a bf16 x gives a bf16 y), and it moves the running
statistics towards the same mean and (biased) var. `batch_norm_train`
computes exactly that at any world size W:

- on the CPU, composed torch ops (`batch_norm_train_reference`), autograd
  through the sums as flax differentiates through them; with W > 1 the two
  sums (in float64) and the count go through one autograd-aware
  `all_reduce_sum`. The apply is one fused multiply-add (`addcmul`), as
  XLA's CPU compiler contracts flax's multiply and add (ops/chamfer.py
  repeats JAX's FMA chains the same way);
- on the card, one autograd Function shaped as torch's SyncBatchNorm. The
  forward takes sum(x) and sum(x^2) from the hand-written kernel `bn_sums`
  (ops/csrc/bn_sums.cu: one read of x), all-reduces them in float64 with
  the count when W > 1 (one call), and applies the statistics with
  `torch.batch_norm_elemt` (weight None and rsqrt(var + eps) * weight as
  its invstd: flax's order). The backward takes
  `torch.batch_norm_backward_reduce`, all-reduces (sum dy, sum dy (x -
  mean)) when W > 1 (one call), and `torch.batch_norm_backward_elemt`:
  the analytic gradient through (x - mean), which equals flax's autodiff of
  E[x^2] - E[x]^2 in exact arithmetic (ROADMAP.md, C). The statistics are
  never taken from `torch.batch_norm_stats` (Welford's update: the two-pass
  variance, another function of x).

At every W the two sums are summed in float64 and rounded once to the
accumulation dtype, the ranks' float64 sums being all-reduced before that
rounding, and divided by the count as a tensor, so a W-rank step takes the
statistics one process takes on the global batch, bit for bit but for
float64's rounding: a step as sensitive as CADepth's turns any rounding of
them into another gradient (ROADMAP.md, C).

`bn_sums` launches its kernel for CUDA tensors, counting the launch in its
`launches` attribute, and runs its plain version (`bn_sums_reference`) for
CPU tensors. Nothing swaps a plain version in on a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.distributed as dist

from baseboostdepth_tpu_torch.ops.cuda_build import launch, load_library
from baseboostdepth_tpu_torch.parallel.sharding import all_reduce_sum, world_size

LIB_NAME = "bn"
SOURCES = ("bn_sums.cu",)

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# blocks a bn_sums launch aims for: 8 resident blocks of 256 threads on each
# of the H100's 132 SMs
_TARGET_BLOCKS = 1056


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bbd_bn_sums.argtypes = [ptr, ptr, ptr, i64, i32, i64, i32, i32, i32, ptr]
    lib.bbd_bn_sums.restype = ctypes.c_int
    return lib


def _accumulation_dtype(x: torch.Tensor) -> torch.dtype:
    """float64 for a float64 x, else float32 (flax's promotion)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _reduced_dims(x: torch.Tensor) -> tuple:
    return (0, *range(2, x.ndim))


def bn_sums_reference(x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the kernel: [sum(x) per channel, sum(x^2) per
    channel] (2C values) of x [N, C, ...], each x and x^2 taken in x's
    accumulation dtype, as flax takes them, summed in float64, as the
    kernel sums, and rounded once to `dtype` (float64, or by default the
    accumulation dtype); differentiable. The fast variance E[x^2] - E[x]^2
    magnifies the sums' rounding by E[x^2] / var, which reaches the
    thousands deep in the encoders at small batches, so the sums are kept
    exact to that one rounding."""
    dims = _reduced_dims(x)
    xf = x.to(_accumulation_dtype(x))
    sums = torch.cat([xf.to(torch.float64).sum(dims), (xf * xf).to(torch.float64).sum(dims)])
    return sums.to(dtype or xf.dtype)


def _layout(x: torch.Tensor):
    """(outer, C, inner) of the kernel's [outer, C, inner] view of x: NCHW
    (contiguous) or channels-last (NHWC in memory); raises otherwise."""
    C = x.shape[1]
    if x.is_contiguous():
        return x.shape[0], C, x.numel() // (x.shape[0] * C)
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x.numel() // C, C, 1
    raise ValueError("bn_sums: x must be contiguous or channels-last contiguous, got strides "
                     f"{x.stride()} for shape {tuple(x.shape)}")


def _blocks_along_a_channel(outer: int, C: int, inner: int) -> int:
    """G, the kernel's blocks along each channel: enough to fill the card,
    each with at least 256 rows (channels-last) or 1,024 elements of a plane
    (NCHW) of every image."""
    if inner == 1:
        g = min(math.ceil(outer / 256), max(1, _TARGET_BLOCKS // math.ceil(C / 32)))
    else:
        g = min(math.ceil(inner / 1024), max(1, _TARGET_BLOCKS // C))
    return max(1, min(g, 65535))


def bn_sums(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """[sum(x), sum(x^2)] per channel (2C values) of a bf16, float32 or
    float64 x [N, C, ...], NCHW or channels-last, in x's accumulation dtype
    (float32; float64 for a float64 x); written into `out` when given, which
    may also be float64: the sums before their one rounding.

    CUDA tensors launch the kernel (counted in `bn_sums.launches`); CPU
    tensors run the plain version.
    """
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bn_sums: x must be bfloat16, float32 or float64, got {x.dtype}")
    if x.ndim < 2 or x.numel() == 0:
        raise ValueError(f"bn_sums: x must be a non-empty [N, C, ...], got {tuple(x.shape)}")
    C = x.shape[1]
    acc = _accumulation_dtype(x)
    if out is not None and (out.dtype not in (acc, torch.float64) or out.shape != (2 * C,)
                            or not out.is_contiguous() or out.device != x.device):
        raise ValueError(f"bn_sums: out must be a contiguous {acc} or float64 [{2 * C}] on "
                         f"{x.device}")
    if x.device.type == "cpu":
        sums = bn_sums_reference(x, None if out is None else out.dtype)
        return sums if out is None else out.copy_(sums)
    if x.device.type != "cuda":
        raise ValueError(f"bn_sums: unsupported device {x.device}")
    outer, C, inner = _layout(x)
    if out is None:
        out = torch.empty(2 * C, dtype=acc, device=x.device)
    G = _blocks_along_a_channel(outer, C, inner)
    partial = torch.empty(2 * C * G if G > 1 else 1, dtype=torch.float64, device=x.device)
    launch(_lib(), "bbd_bn_sums", (x, out, partial),
           (outer, C, inner, _DTYPE_CODES[x.dtype], int(out.dtype == torch.float64), G))
    bn_sums.launches += 1
    return out


bn_sums.launches = 0


def _statistics(sums: torch.Tensor, count: torch.Tensor, C: int):
    """mean and var = max(E[x^2] - mean^2, 0) from the 2C sums and the count,
    a tensor of one element of the sums' dtype at every W: on the card a
    division by a Python number is a multiplication by its reciprocal,
    which would put one process's mean an ulp from the W ranks'."""
    moments = sums.view(2, C) / count
    mean, mean_sq = moments[0], moments[1]
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


@torch.no_grad()
def _update_running_(running_mean, running_var, mean, var, momentum: float) -> None:
    running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
    running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)


def batch_norm_train_reference(x, weight, bias, running_mean, running_var, momentum: float,
                               eps: float) -> torch.Tensor:
    """The composed form of `batch_norm_train` (the CPU's path)."""
    acc = _accumulation_dtype(x)
    C = x.shape[1]
    if world_size() > 1:
        sums = bn_sums_reference(x, torch.float64)
        reduced = all_reduce_sum(torch.cat([sums, sums.new_full((1,), x.numel() // C)])).to(acc)
        sums, count = reduced[:2 * C], reduced[2 * C:]
    else:
        sums = bn_sums_reference(x)
        count = sums.new_full((1,), x.numel() // C)
    mean, var = _statistics(sums, count, C)
    _update_running_(running_mean, running_var, mean.detach(), var.detach(), momentum)
    shape = (1, C) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(var + eps) * weight.to(acc)
    y = torch.addcmul(bias.to(acc).view(shape), x.to(acc) - mean.view(shape), mul.view(shape))
    return y.to(x.dtype)


@functools.cache
def _count_tensor(count: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The element count per channel as a tensor of one element: the
    statistics' divisor, and the int32 tensor that batch_norm_backward_elemt
    takes (made once per count, device and dtype)."""
    return torch.tensor([count], dtype=dtype, device=device)


def _channels_last_or_contiguous(t: torch.Tensor) -> torch.Tensor:
    if t.is_contiguous() or (t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last)):
        return t
    return t.contiguous()


def _like(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """g in x's layout. torch's BN backward kernels take their channels-last
    path only when both are channels-last; the other path sums each channel
    with one block, float32 partial sums of thousands of terms a thread
    (measured 4e-3 off in the weight gradient at the pose network's 6.6 M
    values a channel, on the card)."""
    if x.is_contiguous():
        return g.contiguous()
    return g.contiguous(memory_format=torch.channels_last)


class _BatchNormTrain(torch.autograd.Function):
    """`batch_norm_train` on the card (see the module's docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        x = _channels_last_or_contiguous(x)
        acc = _accumulation_dtype(x)
        C = x.shape[1]
        count = x.numel() // C
        if world_size() > 1:
            buf = torch.empty(2 * C + 1, dtype=torch.float64, device=x.device)
            bn_sums(x, out=buf[:2 * C])
            buf[2 * C:].fill_(count)
            buf = all_reduce_sum(buf)  # no autograd inside forward: one all_reduce
            count_int = buf[2 * C:].to(torch.int32)
            buf = buf.to(acc)  # the global sums' one rounding
            sums, count = buf[:2 * C], buf[2 * C:]
        else:
            sums = bn_sums(x)
            count_int = _count_tensor(count, x.device, torch.int32)
            count = _count_tensor(count, x.device, acc)
        mean, var = _statistics(sums, count, C)
        _update_running_(running_mean, running_var, mean, var, momentum)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, count_int)
        return torch.batch_norm_elemt(x, None, bias, mean, invstd * weight.to(acc), eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd, count_int = ctx.saved_tensors
        g = _like(g, x)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
            g, x, mean, invstd, weight, need_x, need_w, need_b)
        grad_x = None
        if need_x:
            if world_size() > 1:
                C = sum_dy.shape[0]
                both = torch.cat([sum_dy, sum_dy_xmu])
                dist.all_reduce(both)
                sum_dy, sum_dy_xmu = both[:C], both[C:]
            grad_x = torch.batch_norm_backward_elemt(
                g, x, mean, invstd, weight.to(mean.dtype), sum_dy, sum_dy_xmu, count_int)
        return (grad_x, grad_w if need_w else None, grad_b if need_b else None,
                None, None, None, None)


def batch_norm_train(x, weight, bias, running_mean, running_var, momentum: float,
                     eps: float) -> torch.Tensor:
    """Train-mode BatchNorm of x [N, C, ...] with flax's statistics over the
    global batch, updating running_mean / running_var in place (momentum in
    torch's convention: flax's 0.9 is 0.1 here). CUDA tensors take the
    kernel's autograd Function, CPU tensors the composed form."""
    if x.device.type == "cuda":
        return _BatchNormTrain.apply(x, weight, bias, running_mean, running_var, momentum, eps)
    return batch_norm_train_reference(x, weight, bias, running_mean, running_var, momentum, eps)
