"""Monodepth2 U-Net depth decoder in PyTorch, the counterpart of
`baseboostdepth_tpu/models/depth_decoder.py` (reference
networks/depth_decoder.py:11-58): five up-stages of (reflect-pad 3x3 conv +
ELU, nearest 2x upsample, skip concat, reflect-pad 3x3 conv + ELU) with
sigmoid disparity heads at scales 0-3, computed in float32.

The convs sit in `self.decoder`, a ModuleList in the reference's order
(0..9 = upconv (4,0), (4,1), ..., (0,1); 10..13 = dispconv 0..3), so a
published `depth.pth` loads with `load_state_dict`. NCHW in and out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DEC_CHANNELS = (16, 32, 64, 128, 256)


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Pad H and W by one as jnp.pad(mode="reflect") does. torch's reflect
    padding refuses an axis of length 1, where jnp.pad repeats the element
    (a 32-pixel-high input reaches the coarsest decoder stage at height 1)."""
    if x.shape[-1] > 1 and x.shape[-2] > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = F.pad(x, (1, 1, 0, 0), mode="reflect" if x.shape[-1] > 1 else "replicate")
    return F.pad(x, (0, 0, 1, 1), mode="reflect" if x.shape[-2] > 1 else "replicate")


class ReflectConv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv; reference layers.py:118-133."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x):
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    """ReflectConv3x3 + ELU; reference layers.py:103-115."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = ReflectConv3x3(in_channels, out_channels)

    def forward(self, x):
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    """features (5 NCHW maps) -> tuple of sigmoid disparities (disp_0 ..
    disp_3) [B, 1, H/2^s, W/2^s] in float32, finest first."""

    def __init__(self, num_ch_enc):
        super().__init__()
        convs = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else DEC_CHANNELS[i + 1]
            convs.append(ConvBlock(cin, DEC_CHANNELS[i]))
            cin = DEC_CHANNELS[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            convs.append(ConvBlock(cin, DEC_CHANNELS[i]))
        for s in range(4):
            convs.append(ReflectConv3x3(DEC_CHANNELS[s], 1))
        self.decoder = nn.ModuleList(convs)

    def forward(self, features):
        x = features[-1]
        disps = [None] * 4
        for k, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * k](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self.decoder[2 * k + 1](x)
            if i < 4:
                disps[i] = torch.sigmoid(self.decoder[10 + i](x).float())
        return tuple(disps)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal (+-2 std), variance 1/fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_decoder_(module: nn.Module, generator: torch.Generator) -> None:
    """Decoder and pose-head convs: lecun_normal weights, zero bias (flax's
    nn.Conv defaults, depth_decoder.py:114)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
