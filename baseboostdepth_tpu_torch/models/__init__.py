"""Model zoo registry, the counterpart of `baseboostdepth_tpu/models/__init__.py`.

Every depth network obeys one contract:
    module(images [B, H, W, 3]) -> tuple of disparity maps [B, h, w, 1],
    finest first, disp_s at 1/2^s resolution, sigmoid in [0, 1], float32.
Only the md2 zoo is ported; the pose pair is always ResNet-18 2-frame +
pose head (reference trainer.py:94-103).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from baseboostdepth_tpu_torch.models.depth_decoder import DepthDecoder, init_decoder_
from baseboostdepth_tpu_torch.models.pose import PoseDecoder, PoseNet  # noqa: F401
from baseboostdepth_tpu_torch.models.resnet import ResnetEncoder, init_encoder_

#: zoos whose "disparity" output is already metric depth (SQLdepth).
DEPTH_IS_METRIC = frozenset({"sql", "sql_large"})


class MD2DepthNet(nn.Module):
    """Monodepth2: ResNet encoder + U-Net decoder (the default zoo).
    NHWC images in, NHWC disparities out; NCHW (channels-last) inside."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = DepthDecoder(self.encoder.num_ch_enc)

    def forward(self, x: torch.Tensor):
        feats = self.encoder(x.permute(0, 3, 1, 2))
        return tuple(d.permute(0, 2, 3, 1) for d in self.decoder(feats))


def build_depth_net(
    zoo: str = "md2",
    num_layers: int = 18,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build (and initialise from `generator`) a depth network by zoo name.
    The decoder always owns all four disparity heads (scales 0-3)."""
    zoo = zoo.lower()
    if zoo == "md2":
        net = MD2DepthNet(num_layers=num_layers)
        init_encoder_(net.encoder, generator)
        init_decoder_(net.decoder, generator)
        return net
    if zoo in ("monovit", "sql", "sql_large", "cadepth", "diffnet"):
        raise NotImplementedError(
            f"zoo {zoo!r} is not ported yet: ROADMAP.md, next slice 6 (the other zoos)"
        )
    raise ValueError(f"unknown zoo: {zoo}")


def build_pose_net(generator: Optional[torch.Generator] = None) -> PoseNet:
    net = PoseNet()
    init_encoder_(net.encoder, generator)
    init_decoder_(net.decoder, generator)
    return net
