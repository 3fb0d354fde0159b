"""Pose network in PyTorch, the counterpart of
`baseboostdepth_tpu/models/pose.py`: a ResNet-18 with 6-channel input and
the reference's PoseDecoder (networks/pose_decoder.py:9-48): 1x1 squeeze to
256, two 3x3 convs, a 1x1 head, global mean in float32, 0.01-scaled
(axisangle, translation).

The decoder's convs sit in `self.net` (0 = squeeze, 1/2 = pose convs, 3 =
head) as in the reference, so a published `pose.pth` loads directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from baseboostdepth_tpu_torch.models.resnet import ResnetEncoder


class PoseDecoder(nn.Module):
    """last feature [B, C, h, w] -> (axisangle, translation), each
    [B, 2, 3] in float32 (two predicted frames, as the reference's pose
    decoder; the step uses the first)."""

    NUM_FRAMES = 2

    def __init__(self, in_channels: int = 512):
        super().__init__()
        self.net = nn.ModuleList([
            nn.Conv2d(in_channels, 256, 1),
            nn.Conv2d(256, 256, 3, 1, 1),
            nn.Conv2d(256, 256, 3, 1, 1),
            nn.Conv2d(256, 6 * self.NUM_FRAMES, 1),
        ])

    def forward(self, last_feature: torch.Tensor):
        x = last_feature
        for conv in self.net[:3]:
            x = F.relu(conv(x))
        x = self.net[3](x)
        x = x.float().mean(dim=(2, 3))  # global average pool in fp32
        x = 0.01 * x.reshape(x.shape[0], self.NUM_FRAMES, 6)
        return x[..., :3], x[..., 3:]


class PoseNet(nn.Module):
    """ResNet-18 two-image encoder + PoseDecoder.

    pair [B, H, W, 6] (NHWC, as the JAX package) -> (axisangle [B, 3],
    translation [B, 3]) for the first predicted frame.
    """

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers, num_input_images=2)
        self.decoder = PoseDecoder(self.encoder.num_ch_enc[-1])

    def forward(self, pair: torch.Tensor):
        feats = self.encoder(pair.permute(0, 3, 1, 2))
        aa, t = self.decoder(feats[-1])
        return aa[:, 0], t[:, 0]


@torch.no_grad()
def realistic_pose_bias_(pose_net: PoseNet) -> None:
    """Bias the pose head so step poses have KITTI-scale magnitude (~0.08
    forward translation and ~0.006 rad rotation per frame), as bench.py's
    inject_realistic_pose_bias does: an untrained pose net emits
    ~0.001-scale poses. Frame-0 outputs are head bias elements 0..5."""
    pose_net.decoder.net[3].bias[:6] = torch.tensor([0.3, 0.6, 0.3, 1.0, 1.0, -8.0])
