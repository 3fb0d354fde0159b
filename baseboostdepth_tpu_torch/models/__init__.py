"""Model zoo registry, the counterpart of `baseboostdepth_tpu/models/__init__.py`.

Every depth network obeys one contract:
    module(images [B, H, W, 3], generator=None) -> tuple of four disparity
    maps [B, h, w, 1], finest first, disp_s at 1/2^s resolution, sigmoid in
    [0, 1], float32 (SQLdepth returns metric depth at 1/2 resolution
    instead, four times -- flagged via DEPTH_IS_METRIC). `generator` draws
    the SQL head's dropout masks and MonoViT's drop-path masks in train
    mode; the other zoos draw nothing.
    module.dispconvs() lists the disparity-head convs (none for SQLdepth).
Zoos: md2 (ResNet-18/34/50/101/152), monovit, cadepth, diffnet, sql and
sql_large, every zoo of the JAX package. The pose pair is always ResNet-18
2-frame + pose head (reference trainer.py:94-103).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from baseboostdepth_tpu_torch.models.cadepth import CADepthNet
from baseboostdepth_tpu_torch.models.depth_decoder import DepthDecoder, init_decoder_
from baseboostdepth_tpu_torch.models.diffnet import DIFFNetDepthNet
from baseboostdepth_tpu_torch.models.monovit import MonoViTDepthNet
from baseboostdepth_tpu_torch.models.pose import PoseDecoder, PoseNet  # noqa: F401
from baseboostdepth_tpu_torch.models.resnet import (  # noqa: F401
    ResnetEncoder,
    encoder_channels,
    init_encoder_,
)
from baseboostdepth_tpu_torch.models.sql import SQLDepthNet, init_sql_

#: zoos whose "disparity" output is already metric depth (SQLdepth).
DEPTH_IS_METRIC = frozenset({"sql", "sql_large"})


class MD2DepthNet(nn.Module):
    """Monodepth2: ResNet encoder + U-Net decoder (the default zoo).
    NHWC images in, NHWC disparities out; NCHW (channels-last) inside."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = DepthDecoder(self.encoder.num_ch_enc)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        feats = self.encoder(x.permute(0, 3, 1, 2))
        return tuple(d.permute(0, 2, 3, 1) for d in self.decoder(feats))

    def dispconvs(self):
        return [head.conv for head in self.decoder.decoder[10:]]


def build_depth_net(
    zoo: str = "md2",
    num_layers: int = 18,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build (and initialise from `generator`) a depth network by zoo name
    ('md2', 'monovit', 'cadepth', 'diffnet', 'sql', 'sql_large').
    `num_layers` is md2's ResNet depth; cadepth and sql always use a
    ResNet-50, monovit an MPViT-small and diffnet an HRNet-18, as in the JAX
    package. Every decoder but SQLdepth's owns all four disparity heads
    (scales 0-3). Initialisation follows flax's: the ResNet and HRNet trunks
    torchvision's kaiming fan-out, every other conv and linear layer
    lecun-normal with zero bias."""
    zoo = zoo.lower()
    if zoo in ("md2", "cadepth"):
        net = MD2DepthNet(num_layers=num_layers) if zoo == "md2" else CADepthNet()
        init_encoder_(net.encoder, generator)
        init_decoder_(net.decoder, generator)
        return net
    if zoo in ("sql", "sql_large"):
        net = SQLDepthNet(large=zoo == "sql_large")
        init_sql_(net, generator)
        return net
    if zoo == "monovit":
        net = MonoViTDepthNet()
        init_decoder_(net, generator)
        return net
    if zoo == "diffnet":
        net = DIFFNetDepthNet()
        init_encoder_(net.encoder, generator)
        init_decoder_(net.decoder, generator)
        return net
    raise ValueError(f"unknown zoo: {zoo}")


def build_pose_net(generator: Optional[torch.Generator] = None) -> PoseNet:
    net = PoseNet()
    init_encoder_(net.encoder, generator)
    init_decoder_(net.decoder, generator)
    return net
