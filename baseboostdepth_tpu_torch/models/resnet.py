"""ResNet-18/34/50/101/152 encoders (Monodepth2 zoo, and the ResNet-50 of
CADepth and SQLdepth) in PyTorch, the counterpart of
`baseboostdepth_tpu/models/resnet.py`.

Module names follow the reference's torch modules (networks/
resnet_encoder.py:12-91, a torchvision ResNet under `.encoder`: `conv1`,
`bn1`, `layer1.0.conv1`, `layer2.0.downsample.0/1`, ...), so a published
`encoder.pth` / `pose_encoder.pth` or a torchvision ImageNet file loads with
`load_state_dict` once its classifier (`fc.*`) is dropped
(models/torch_import.py). Inputs are NCHW (a channels-last view of the NHWC
images is fine).

BatchNorm keeps the JAX package's numbers: momentum 0.1 here is flax's 0.9,
statistics are reduced in float32 whatever the compute dtype, and the
running variance takes the *biased* batch variance (nn.BatchNorm2d would
take the unbiased one). In a process group of more than one rank its
train-mode statistics are those of the global batch, as under the JAX
package's data mesh (flax's fast variance, E[x^2] - E[x]^2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from baseboostdepth_tpu_torch.parallel.sharding import all_reduce_sum, world_size

_BN_MOMENTUM = 0.1  # torch convention; flax momentum 0.9
_BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's running-statistics update (biased batch
    variance, float32 statistics); over the global batch when the process
    group has more than one rank."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=_BN_EPS, momentum=_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        if world_size() > 1:
            return self._global_batch_norm(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN over every rank's rows: the per-channel sums of x
        and x^2 and the count, in float32 (float64 for a float64 input),
        summed over the ranks by one autograd-aware all_reduce, whose
        backward sums the cotangents, so the gradients are the global
        batch's too; mean and var = E[x^2] - E[x]^2 (clamped at 0) as flax's
        fast variance forms them."""
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        xf = x.to(acc)
        C = x.shape[1]
        count = torch.full((1,), xf.numel() // C, dtype=acc, device=x.device)
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        n = sums[2 * C]
        mean = sums[:C] / n
        var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        shift = self.bias.to(acc) - mean * scale
        return (xf * scale.view(1, C, 1, 1) + shift.view(1, C, 1, 1)).to(x.dtype)


class BasicBlock(nn.Module):
    """ResNet-18/34 block: 3x3 -> 3x3 with identity/projection skip."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False), BatchNorm2d(planes)
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """ResNet-50+ block: 1x1 -> 3x3 (stride) -> 1x1 (x4), torchvision v1.5
    stride placement (the stride on the 3x3)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False), BatchNorm2d(planes * 4)
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity)


#: block type and blocks per layer of each depth (torchvision's table)
_LAYER_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def encoder_channels(num_layers: int) -> Tuple[int, ...]:
    """Feature channels of the 5 taps; reference
    networks/resnet_encoder.py:63,88 ((64, 64, 128, 256, 512), x4 above 34)."""
    base = (64, 64, 128, 256, 512)
    if num_layers > 34:
        return (base[0],) + tuple(c * 4 for c in base[1:])
    return base


class ResNet(nn.Module):
    """The torchvision ResNet trunk the reference taps (no pool/fc head)."""

    def __init__(self, num_layers: int = 18, in_channels: int = 3):
        super().__init__()
        if num_layers not in _LAYER_SPECS:
            raise ValueError(f"no ResNet-{num_layers}; known: {sorted(_LAYER_SPECS)}")
        block, counts = _LAYER_SPECS[num_layers]
        expansion = 4 if block is Bottleneck else 1
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for li, (w, n) in enumerate(zip((64, 128, 256, 512), counts), start=1):
            blocks = []
            for bi in range(n):
                stride = 2 if (bi == 0 and li > 1) else 1
                blocks.append(block(inplanes, w, stride))
                inplanes = w * expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """Multi-scale feature encoder: images [B, 3*num_input_images, H, W] ->
    5 feature maps at strides 2, 4, 8, 16, 32."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        self.num_ch_enc = encoder_channels(num_layers)
        self.encoder = ResNet(num_layers, 3 * num_input_images)

    def forward(self, x: torch.Tensor):
        e = self.encoder
        x = (x - 0.45) / 0.225
        f0 = F.relu(e.bn1(e.conv1(x)))
        x = F.max_pool2d(f0, 3, 2, 1)  # implicit -inf padding
        feats = [f0]
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            feats.append(x)
        return feats


def init_encoder_(enc: ResnetEncoder, generator: torch.Generator) -> None:
    """torchvision's init: kaiming_normal(fan_out, relu) convs, BN (1, 0)."""
    for m in enc.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                    generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
