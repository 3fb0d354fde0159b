"""CADepth in PyTorch, the counterpart of `baseboostdepth_tpu/models/cadepth.py`:
a ResNet-50 encoder and the Monodepth2 decoder with channel-attention
modules (reference networksCA/, trainer.py:68-75).

- SPM, Structure Perception Module (networksCA/spm.py:4-30): channel-wise
  self-attention on the bottleneck, a C x C energy from a batched product,
  max-subtracted softmax (float32), residual. It has no parameters.
- DEM, Detail Emphasis Module (networksCA/dem.py:4-31): reflect-padded 3x3
  conv + BN + ReLU, then a global-mean 2-layer 1x1 gate; out + out * gate.
- Decoder wiring (networksCA/depth_decoder.py:12-66): the MD2 U-Net with SPM
  at the bottleneck and a DEM after every skip concat.

The decoder's modules sit in `self.decoder`, a ModuleList in the
reference's order (per stage i = 4..0: upconv (i, 0), upconv (i, 1),
DEM i; then dispconv 0..3 at 15..18), and a DEM holds the reference's
`conv1` (pad, conv, BN, ReLU) and `global_path` (mean, conv, ReLU, conv,
sigmoid) Sequentials, so a published CADepth `depth.pth` loads with
`load_state_dict`. NCHW in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from baseboostdepth_tpu_torch.models.depth_decoder import (
    DEC_CHANNELS,
    ConvBlock,
    ReflectConv3x3,
    reflect_pad1,
)
from baseboostdepth_tpu_torch.models.resnet import BatchNorm2d, ResnetEncoder


def spm(x: torch.Tensor) -> torch.Tensor:
    """Channel self-attention with max-subtracted softmax + residual.
    x [B, C, H, W]; the C x C energy sums over H*W. The products run in the
    input's dtype (bf16 under autocast), the softmax in float32."""
    B, C, H, W = x.shape
    flat = x.reshape(B, C, H * W)
    energy = torch.bmm(flat, flat.transpose(1, 2))  # [B, C, C]
    energy_new = energy.amax(dim=-1, keepdim=True) - energy
    attn = torch.softmax(energy_new.float(), dim=-1).to(flat.dtype)
    return torch.bmm(attn, flat).reshape(B, C, H, W) + x


class _ReflectPad1(nn.Module):
    """The reference's nn.ReflectionPad2d(1), with jnp.pad's repeat of a
    length-1 axis (models/depth_decoder.py::reflect_pad1)."""

    def forward(self, x):
        return reflect_pad1(x)


class _GlobalMean(nn.Module):
    """The reference's nn.AdaptiveAvgPool2d(1)."""

    def forward(self, x):
        return x.mean(dim=(2, 3), keepdim=True)


class DEM(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            _ReflectPad1(), nn.Conv2d(channels, channels, 3), BatchNorm2d(channels), nn.ReLU()
        )
        self.global_path = nn.Sequential(
            _GlobalMean(), nn.Conv2d(channels, channels, 1), nn.ReLU(),
            nn.Conv2d(channels, channels, 1), nn.Sigmoid(),
        )

    def forward(self, x):
        y = self.conv1(x)
        return y + y * self.global_path(y)


class CADecoder(nn.Module):
    """features (5 NCHW maps) -> sigmoid disparities (disp_0 .. disp_3)
    [B, 1, H/2^s, W/2^s] in float32, finest first."""

    def __init__(self, num_ch_enc):
        super().__init__()
        mods = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else DEC_CHANNELS[i + 1]
            mods.append(ConvBlock(cin, DEC_CHANNELS[i]))
            cin = DEC_CHANNELS[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            mods.append(ConvBlock(cin, DEC_CHANNELS[i]))
            mods.append(DEM(cin))
        for s in range(4):
            mods.append(ReflectConv3x3(DEC_CHANNELS[s], 1))
        self.decoder = nn.ModuleList(mods)

    def forward(self, features):
        x = spm(features[-1])
        disps = [None] * 4
        for k, i in enumerate(range(4, -1, -1)):
            x = self.decoder[3 * k](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = self.decoder[3 * k + 2](x)
            x = self.decoder[3 * k + 1](x)
            if i < 4:
                disps[i] = torch.sigmoid(self.decoder[15 + i](x).float())
        return tuple(disps)


class CADepthNet(nn.Module):
    """ResNet-50 encoder + CA decoder (trainer.py:70-71). NHWC images in,
    NHWC disparities out; NCHW (channels-last) inside."""

    def __init__(self, num_layers: int = 50):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = CADecoder(self.encoder.num_ch_enc)

    def forward(self, x: torch.Tensor, generator=None):
        feats = self.encoder(x.permute(0, 3, 1, 2))
        return tuple(d.permute(0, 2, 3, 1) for d in self.decoder(feats))

    def dispconvs(self):
        return [head.conv for head in self.decoder.decoder[15:]]
