"""DIFFNet in PyTorch, the counterpart of `baseboostdepth_tpu/models/diffnet.py`:
an HRNet-18 encoder and the attention-fusion depth decoder (reference
networksDIFF/, trainer.py:76-83).

- HRNet-18 (networksDIFF/test_hr_encoder.py:295-497, stage spec
  networksDIFF/hrnet_config.py HRNET_18): two stride-2 3x3 stems, stage 1 =
  4 Bottlenecks (64 -> 256), then stages 2-4 grow branches of widths
  (18, 36, 72, 144) of BasicBlocks, with SUM fusion: a 1x1 conv + BN, then
  bilinear align_corners=True upsampling, from coarse to fine; stride-2
  3x3 conv + BN chains (ReLU between links) from fine to coarse; ReLU after
  the sum. Inputs are normalised as (x - 0.45) / 0.225.
- The encoder returns stage-accumulated feature lists
  (test_hr_encoder.py:440-496): (f_half [64 at H/2], list18 [the H/4 stem
  output + each stage's 18-wide branch], list36 [3 at H/8], list72 [2 at
  H/16], f144 [H/32]).
- The decoder (networksDIFF/HR_Depth_Decoder.py:10-62): four attention
  fusions (upsample the coarser map, concat the list, channel attention,
  3x3 conv + ReLU) down to H/2, two ConvBlocks with a nearest 2x upsample
  between them, sigmoid disparity heads in float32 at strides 1, 2, 4, 8.

Module names are the reference's: the encoder's `conv1`, `bn1`, `conv2`,
`bn2`, `layer1.{b}`, `transition{n}.{i}[.0].{0,1}`,
`stage{s}.{m}.branches.{i}.{b}` and `stage{s}.{m}.fuse_layers.{i}.{j}[.{k}]
.{0,1}` (tests/torch_zoo_refs.py::make_hrnet18), the decoder's `convs.*`
ModuleDict (`72`, `36`, `18`, `9`, `up_x9_0`, `up_x9_1`,
`dispConvScale{s}`), so the reference's `encoder.pth` / `depth.pth` and an
ImageNet HRNet-18 file load with a key map and `load_state_dict`
(models/torch_import.py). NCHW inside; the depth network takes NHWC images
and returns NHWC disparities.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from baseboostdepth_tpu_torch.models.depth_decoder import ConvBlock, ReflectConv3x3
from baseboostdepth_tpu_torch.models.monovit import AttentionModule
from baseboostdepth_tpu_torch.models.resnet import BasicBlock, BatchNorm2d, Bottleneck
from baseboostdepth_tpu_torch.ops.resize import resize_bilinear_align_corners

HRNET18_STAGES = dict(
    stage2=dict(modules=1, branches=2, blocks=4, channels=(18, 36)),
    stage3=dict(modules=4, branches=3, blocks=4, channels=(18, 36, 72)),
    stage4=dict(modules=3, branches=4, blocks=4, channels=(18, 36, 72, 144)),
)


def _conv_bn(cin: int, cout: int, stride: int, relu: bool = True) -> nn.Sequential:
    """3x3 conv (no bias) + BN (+ ReLU)."""
    layers = [nn.Conv2d(cin, cout, 3, stride, 1, bias=False), BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch BasicBlock stacks + SUM fusion."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c) for _ in range(num_blocks)]) for c in channels)
        rows = []
        for i, ci in enumerate(channels):
            row = []
            for j, cj in enumerate(channels):
                if j > i:
                    row.append(nn.Sequential(nn.Conv2d(cj, ci, 1, bias=False), BatchNorm2d(ci)))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(cj, ci if k == i - j - 1 else cj, 2, relu=k < i - j - 1)
                        for k in range(i - j)]))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    v = ys[j]
                elif j > i:
                    v = resize_bilinear_align_corners(layer(ys[j]), ys[i].shape[2], ys[i].shape[3])
                else:
                    v = layer(ys[j])
                acc = v if acc is None else acc + v
            fused.append(F.relu(acc))
        return fused


class HRNetEncoder(nn.Module):
    """HRNet-18 returning DIFFNet's stage-accumulated feature lists (see the
    module docstring). `stages` is the stage spec (HRNET18_STAGES)."""

    def __init__(self, stages=HRNET18_STAGES):
        super().__init__()
        c2, c3, c4 = (tuple(stages[s]["channels"]) for s in ("stage2", "stage3", "stage4"))
        self.num_ch_enc = (64,) + c4
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64), *[Bottleneck(256, 64) for _ in range(3)])
        self.transition1 = nn.ModuleList([_conv_bn(256, c2[0], 1),
                                          nn.Sequential(_conv_bn(256, c2[1], 2))])
        self.transition2 = nn.ModuleList([None] * len(c2) + [nn.Sequential(
            _conv_bn(c2[-1], c3[-1], 2))])
        self.transition3 = nn.ModuleList([None] * len(c3) + [nn.Sequential(
            _conv_bn(c3[-1], c4[-1], 2))])
        for name in ("stage2", "stage3", "stage4"):
            spec = stages[name]
            setattr(self, name, nn.Sequential(*[HRModule(spec["channels"], spec["blocks"])
                                                for _ in range(spec["modules"])]))

    def forward(self, x):
        x = (x - 0.45) / 0.225
        f_half = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(f_half)))
        list18, list36, list72 = [x], [], []
        x = self.layer1(x)
        xs = self.stage2([t(x) for t in self.transition1])
        list18.append(xs[0])
        list36.append(xs[1])
        for stage, transition in ((self.stage3, self.transition2),
                                  (self.stage4, self.transition3)):
            xs = stage(xs + [transition[-1](xs[-1])])
            list18.append(xs[0])
            list36.append(xs[1])
            list72.append(xs[2])
        return f_half, list18, list36, list72, xs[3]


class AttentionFuse(AttentionModule):
    """Upsampled high + concat lows -> MonoViT's AttentionModule (channel
    attention, 3x3 conv, ReLU; root hr_layers.py:443-467 Attention_Module)."""

    def forward(self, high, lows):
        feats = torch.cat([F.interpolate(high, scale_factor=2, mode="nearest")] + list(lows),
                          dim=1)
        return super().forward(feats)


class DIFFNetDecoder(nn.Module):
    """Encoder lists -> sigmoid disparities (disp_0 .. disp_3)
    [B, 1, H/2^s, W/2^s] in float32, finest first."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 18, 36, 72, 144)):
        super().__init__()
        c = num_ch_enc
        dec = (16, 32, 64, 128, 256)
        self.convs = nn.ModuleDict({
            "up_x9_0": ConvBlock(dec[1], dec[0]),
            "up_x9_1": ConvBlock(dec[0], dec[0]),
            "72": AttentionFuse(c[4] + 2 * c[3], 256),
            "36": AttentionFuse(256 + 3 * c[2], 128),
            "18": AttentionFuse(128 + c[0] + 3 * c[1], 64),
            "9": AttentionFuse(64 + c[0], 32),
            **{f"dispConvScale{s}": ReflectConv3x3(dec[s], 1) for s in range(4)},
        })

    def forward(self, feats):
        f_half, list18, list36, list72, f144 = feats
        c = self.convs
        x36 = c["36"](c["72"](f144, list72), list36)
        x18 = c["18"](x36, list18)
        x9 = c["9"](x18, [f_half])
        x6 = c["up_x9_1"](F.interpolate(c["up_x9_0"](x9), scale_factor=2, mode="nearest"))
        return tuple(torch.sigmoid(c[f"dispConvScale{s}"](y).float())
                     for s, y in enumerate((x6, x9, x18, x36)))


class DIFFNetDepthNet(nn.Module):
    """HRNet-18 encoder + attention-fusion decoder. NHWC images in, NHWC
    disparities out (strides 1, 2, 4, 8)."""

    def __init__(self, stages=HRNET18_STAGES):
        super().__init__()
        self.encoder = HRNetEncoder(stages)
        self.decoder = DIFFNetDecoder(self.encoder.num_ch_enc)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        disps = self.decoder(self.encoder(x.permute(0, 3, 1, 2)))
        return tuple(d.permute(0, 2, 3, 1) for d in disps)

    def dispconvs(self):
        return [self.decoder.convs[f"dispConvScale{s}"].conv for s in range(4)]
