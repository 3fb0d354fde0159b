"""Reflect padding by one pixel, `jnp.pad(mode="reflect")`'s, with a
deterministic backward.

torch's reflection- and replication-pad backward kernels on the GPU add
into the input gradient with atomics, so their sums come in another order
on every run, and torch's deterministic mode refuses them. Here the
backward is the explicit fold that XLA computes for jnp.pad's transpose:
the interior of the padded gradient, plus each pad row and column added
once onto the row or column it copies (`pad1_adjoint`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad1_adjoint(g: torch.Tensor) -> torch.Tensor:
    """Adjoint of reflect-pad(1) of the last two axes: [..., H+2, W+2] ->
    [..., H, W]. Padded row 0 copies row 1 and row H+1 row H-2, or both
    copy row 0 where H == 1 (jnp.pad repeats a length-1 axis); columns
    likewise. One new buffer, the interior, with eight strided adds."""
    H, W = g.shape[-2] - 2, g.shape[-1] - 2
    top, bottom = (1, H - 2) if H > 1 else (0, 0)
    left, right = (1, W - 2) if W > 1 else (0, 0)
    out = g[..., 1:-1, 1:-1].clone()
    out[..., top, :] += g[..., 0, 1:-1]
    out[..., bottom, :] += g[..., H + 1, 1:-1]
    out[..., :, left] += g[..., 1:-1, 0]
    out[..., :, right] += g[..., 1:-1, W + 1]
    out[..., top, left] += g[..., 0, 0]
    out[..., top, right] += g[..., 0, W + 1]
    out[..., bottom, left] += g[..., H + 1, 0]
    out[..., bottom, right] += g[..., H + 1, W + 1]
    return out


class _ReflectPad1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.shape[-1] > 1 and x.shape[-2] > 1:
            return F.pad(x, (1, 1, 1, 1), mode="reflect")
        # torch's reflect padding refuses an axis of length 1
        x = F.pad(x, (1, 1, 0, 0), mode="reflect" if x.shape[-1] > 1 else "replicate")
        return F.pad(x, (0, 0, 1, 1), mode="reflect" if x.shape[-2] > 1 else "replicate")

    @staticmethod
    def backward(ctx, g):
        return pad1_adjoint(g)


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Pad the last two axes (H, W of NCHW) by one as jnp.pad(mode="reflect")
    does, repeating the element of a length-1 axis (a 32-pixel-high input
    reaches the coarsest decoder stage at height 1)."""
    return _ReflectPad1.apply(x)
