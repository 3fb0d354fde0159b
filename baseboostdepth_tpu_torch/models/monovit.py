"""MonoViT in PyTorch, the counterpart of `baseboostdepth_tpu/models/monovit.py`:
the MPViT-small encoder and the HR nested decoder (reference networksvit/).

- MPViT-small (networksvit/mpvit.py:602-726, 794-821): a stride-2 + stride-1
  conv stem (features at H/2), then 4 stages of {sequential depthwise patch
  embeds (the first of stride 2) -> a conv ResBlock on the first embed and
  one multi-head conv-attention path per embed -> concat -> 1x1 aggregate}.
  Paths (2, 3, 3, 3), layers (1, 3, 6, 3), widths (64, 128, 216, 288), MLP
  ratio 4, 8 heads, drop-path 0.2 decaying linearly over the 13 blocks.
- Factorized attention (mpvit.py:333-393): softmax of K over the tokens (in
  float32, cast back), K_soft^T V, then Q (K_soft^T V), scaled by Ch^-0.5
  after the products, plus the convolutional relative position encoding:
  depthwise convs over V (laid out head-major, the 8 heads split 2/3/3 over
  windows 3/5/7), gated by Q. One ConvPosEnc and one ConvRelPosEnc are
  shared by all blocks of a path; sharing them, not copying them, is what
  the checkpoint layout and the gradients need.
- LayerNorm eps 1e-6, exact (erf) GELU, BatchNorm with flax's numbers
  (models/resnet.py::BatchNorm2d: momentum 0.9 in flax terms, eps 1e-5).
- Drop-path: one mask per sample, broadcast over tokens and channels,
  scaled by 1/keep, drawn from the forward's explicit `generator`; off in
  eval mode.
- HR decoder (networksvit/hr_decoder.py:10-125): four channel-attention
  heads map the encoder widths onto the reference's "virtual" widths
  (64, 64, 128, 256, 512), a dense X_ij lattice with fSE attention at X_31,
  X_22, X_13 and X_04, nearest 2x upsampling, sigmoid disparity heads in
  float32 at scales 0-3. The phase-domain tail of the JAX package is off
  for this zoo and not carried.

Module names are the reference's: the encoder's `stem.{0,1}`,
`patch_embed_stages.{s}.patch_embeds.{p}.patch_conv.{dwconv,pwconv,bn}`,
`mhca_stages.{s}.{InvRes,aggregate,mhca_blks.{p}}`, each path's `cpe`,
`crpe.conv_list.{k}` and `MHCA_layers.{i}.{factoratt_crpe.{qkv,proj},
mlp.{fc1,fc2},norm1,norm2}` (the shared encodings under every alias the
reference's state dict has), and the decoder's `convs.*` ModuleDict
(`f{i}`, `X_{ij}_Conv_{0,1}`, `X_{ij}_attention`, `X_{ij}_downsample`,
`dispconv{s}`), so a released `mpvit_small.pth` or a reference MonoViT
weights folder loads with a key map and `load_state_dict`
(models/torch_import.py). NCHW inside; the depth network takes NHWC images
and returns NHWC disparities.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from baseboostdepth_tpu_torch.models.depth_decoder import ConvBlock, ReflectConv3x3
from baseboostdepth_tpu_torch.models.resnet import BatchNorm2d

_LN_EPS = 1e-6
#: (window, heads) of the relative position encoding (mpvit.py:453)
CRPE_WINDOWS = ((3, 2), (5, 3), (7, 3))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth: each sample's x is zeroed with probability `rate`,
    else scaled by 1/(1 - rate); one mask entry per sample, from
    `generator`."""
    if not training or rate == 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))


class ConvBN(nn.Module):
    """conv (no bias) + BN + optional hardswish (mpvit.py Conv2d_BN)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1,
                 pad: int = 0, act: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, pad, bias=False)
        self.bn = BatchNorm2d(out_ch)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.hardswish(x) if self.act else x


class DWPatchEmbed(nn.Module):
    """Depthwise-separable 3x3 patch embed (mpvit.py DWCPatchEmbed /
    DWConv2d_BN): dw conv -> pw conv -> BN -> hardswish."""

    def __init__(self, dim: int, stride: int = 1):
        super().__init__()
        self.patch_conv = nn.Sequential(OrderedDict(
            dwconv=nn.Conv2d(dim, dim, 3, stride, 1, groups=dim, bias=False),
            pwconv=nn.Conv2d(dim, dim, 1, bias=False),
            bn=BatchNorm2d(dim),
            act=nn.Hardswish(),
        ))

    def forward(self, x):
        return self.patch_conv(x)


class _PatchEmbedStage(nn.Module):
    """A stage's sequential patch embeds, the first of stride 2
    (mpvit.py:212-238); returns every embed's output."""

    def __init__(self, dim: int, num_path: int):
        super().__init__()
        self.patch_embeds = nn.ModuleList(
            DWPatchEmbed(dim, stride=2 if p == 0 else 1) for p in range(num_path))

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for embed in self.patch_embeds:
            x = embed(x)
            outs.append(x)
        return outs


class ConvPosEnc(nn.Module):
    """Shared depthwise 3x3 positional encoding with residual, on NCHW."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x):
        return x + self.proj(x)


class ConvRelPosEnc(nn.Module):
    """Convolutional relative position encoding: depthwise convs over V with
    per-head-group windows, gated elementwise by Q (mpvit.py:262-330)."""

    def __init__(self, head_dim: int, windows=CRPE_WINDOWS):
        super().__init__()
        self.splits = [heads * head_dim for _, heads in windows]
        self.conv_list = nn.ModuleList(
            nn.Conv2d(c, c, win, padding=win // 2, groups=c)
            for (win, _), c in zip(windows, self.splits))

    def forward(self, q, v, size: Tuple[int, int]):
        # q, v [B, h, N, Ch] -> V as an image [B, h*Ch, H, W], head-major
        B, h, N, Ch = q.shape
        H, W = size
        v_img = v.transpose(1, 2).reshape(B, H, W, h * Ch).permute(0, 3, 1, 2)
        conv_v = torch.cat([conv(part) for conv, part in
                            zip(self.conv_list, torch.split(v_img, self.splits, dim=1))], dim=1)
        conv_v = conv_v.permute(0, 2, 3, 1).reshape(B, N, h, Ch).transpose(1, 2)
        return q * conv_v


class FactorAttention(nn.Module):
    """Factorized attention Q (softmax_N(K)^T V) + CRPE (mpvit.py:333-393).
    `crpe` is the path's shared ConvRelPosEnc."""

    def __init__(self, dim: int, num_heads: int, crpe: ConvRelPosEnc):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.crpe = crpe

    def forward(self, x, size: Tuple[int, int]):
        B, N, C = x.shape
        h = self.num_heads
        Ch = C // h
        q, k, v = self.qkv(x).reshape(B, N, 3, h, Ch).permute(2, 0, 3, 1, 4)
        k_soft = torch.softmax(k.float(), dim=2).to(k.dtype)
        ktv = torch.einsum("bhnk,bhnv->bhkv", k_soft, v)
        att = torch.einsum("bhnk,bhkv->bhnv", q, ktv)
        out = Ch ** -0.5 * att + self.crpe(q, v, size)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class MHCABlock(nn.Module):
    """The shared CPE, then pre-LN factorized attention and MLP, each on a
    drop-path residual (mpvit.py:396-437)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, cpe: ConvPosEnc,
                 crpe: ConvRelPosEnc, drop_path: float = 0.0):
        super().__init__()
        self.cpe = cpe
        self.crpe = crpe
        self.factoratt_crpe = FactorAttention(dim, num_heads, crpe)
        self.mlp = nn.Sequential(OrderedDict(
            fc1=nn.Linear(dim, dim * mlp_ratio), act=nn.GELU(),
            fc2=nn.Linear(dim * mlp_ratio, dim)))
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.drop_rate = drop_path

    def forward(self, x, generator=None):  # [B, C, H, W]
        x = self.cpe(x)
        B, C, H, W = x.shape
        t = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        rate, train = self.drop_rate, self.training
        t = t + drop_path(self.factoratt_crpe(self.norm1(t), (H, W)), rate, train, generator)
        t = t + drop_path(self.mlp(self.norm2(t)), rate, train, generator)
        return t.reshape(B, H, W, C).permute(0, 3, 1, 2)


class MHCAEncoder(nn.Module):
    """One transformer path: a shared CPE and CRPE + stacked MHCA blocks."""

    def __init__(self, dim: int, num_layers: int, num_heads: int = 8, mlp_ratio: int = 4,
                 drop_path_list: Sequence[float] = ()):
        super().__init__()
        self.cpe = ConvPosEnc(dim)
        self.crpe = ConvRelPosEnc(dim // num_heads)
        self.MHCA_layers = nn.ModuleList(
            MHCABlock(dim, num_heads, mlp_ratio, self.cpe, self.crpe,
                      drop_path_list[i] if drop_path_list else 0.0)
            for i in range(num_layers))

    def forward(self, x, generator=None):
        for layer in self.MHCA_layers:
            x = layer(x, generator)
        return x


class ResBlockMP(nn.Module):
    """The conv path of a stage (mpvit.py ResBlock): 1x1 BN hardswish ->
    dw 3x3 BN hardswish -> 1x1 BN, residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = ConvBN(dim, dim, act=True)
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=False)
        self.norm = BatchNorm2d(dim)
        self.conv2 = ConvBN(dim, dim)

    def forward(self, x):
        y = F.hardswish(self.norm(self.dwconv(self.conv1(x))))
        return x + self.conv2(y)


class _MHCAStage(nn.Module):
    """The conv path and the transformer paths of a stage, concatenated and
    aggregated (mpvit.py:534-581)."""

    def __init__(self, dim: int, out_dim: int, num_layers: int, num_heads: int,
                 mlp_ratio: int, num_path: int, drop_path_list: Sequence[float]):
        super().__init__()
        self.mhca_blks = nn.ModuleList(
            MHCAEncoder(dim, num_layers, num_heads, mlp_ratio, drop_path_list)
            for _ in range(num_path))
        self.InvRes = ResBlockMP(dim)
        self.aggregate = ConvBN(dim * (num_path + 1), out_dim, act=True)

    def forward(self, inputs, generator=None):
        outs = [self.InvRes(inputs[0])]
        outs += [enc(x, generator) for x, enc in zip(inputs, self.mhca_blks)]
        return self.aggregate(torch.cat(outs, dim=1))


class MPViT(nn.Module):
    """Multi-Path ViT encoder: NCHW images -> 5 feature maps at strides
    2, 4, 8, 16, 32 with channels `num_ch_enc` ((64, 128, 216, 288, 288)
    for MPViT-small, the defaults)."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 216, 288),
                 num_path: Sequence[int] = (2, 3, 3, 3),
                 num_layers: Sequence[int] = (1, 3, 6, 3),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 num_heads: Sequence[int] = (8, 8, 8, 8),
                 drop_path_rate: float = 0.2):
        super().__init__()
        dims = tuple(embed_dims)
        n = len(dims)
        self.num_ch_enc = (dims[0],) + dims[1:] + (dims[-1],)
        # linear-decay drop-path rates over all blocks (mpvit.py:586-598)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(num_layers))]
        self.stem = nn.Sequential(ConvBN(3, dims[0] // 2, 3, 2, 1, act=True),
                                  ConvBN(dims[0] // 2, dims[0], 3, 1, 1, act=True))
        self.patch_embed_stages = nn.ModuleList(
            _PatchEmbedStage(dims[s], num_path[s]) for s in range(n))
        stages, cur = [], 0
        for s in range(n):
            stages.append(_MHCAStage(dims[s], dims[s + 1] if s + 1 < n else dims[s],
                                     num_layers[s], num_heads[s], mlp_ratios[s], num_path[s],
                                     dpr[cur:cur + num_layers[s]]))
            cur += num_layers[s]
        self.mhca_stages = nn.ModuleList(stages)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = [x]
        for embed, stage in zip(self.patch_embed_stages, self.mhca_stages):
            x = stage(embed(x), generator)
            outs.append(x)
        return outs


# ---------------------------------------------------------------------------
# HR decoder
# ---------------------------------------------------------------------------
#: the reference's "virtual" encoder widths and the decoder widths
NCE = (64, 64, 128, 256, 512)
NCD = (16, 32, 64, 128, 256)
#: lattice nodes in the order they are computed; fSE attention at four
LATTICE = ("01", "11", "21", "31", "02", "12", "22", "03", "13", "04")
ATTENTION = ("31", "22", "13", "04")


def _upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ChannelAttention(nn.Module):
    """Mean-pool SE gate (hr_layers.py ChannelAttention; the reference's max
    branch is off): x * sigmoid(fc(mean over H, W))."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // ratio, bias=False), nn.ReLU(),
                                nn.Linear(channels // ratio, channels, bias=False))

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean(dim=(2, 3))))[:, :, None, None]


class AttentionModule(nn.Module):
    """ChannelAttention + 3x3 conv + ReLU (hr_layers.py Attention_Module)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.ca = ChannelAttention(in_channels)
        self.conv_se = nn.Conv2d(in_channels, out_channels, 3, 1, 1)

    def forward(self, x):
        return F.relu(self.conv_se(self.ca(x)))


class FSEModule(ChannelAttention):
    """Upsampled high + concat lows -> SE gate -> 1x1 conv -> ReLU
    (hr_layers.py fSEModule, whose gate is its own `fc`); `high` channels
    out."""

    def __init__(self, high: int, low: int):
        super().__init__(high + low)
        self.conv_se = nn.Conv2d(high + low, high, 1)

    def forward(self, high, lows):
        feats = torch.cat([_upsample2x(high)] + list(lows), dim=1)
        return F.relu(self.conv_se(super().forward(feats)))


class Conv1x1(nn.Module):
    """Bias-free 1x1 conv (hr_layers.py Conv1x1)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.conv(x)


class HRDecoder(nn.Module):
    """Nested X_ij lattice decoder: 5 NCHW features -> sigmoid disparities
    (disp_0 .. disp_3) [B, 1, H/2^s, W/2^s] in float32, finest first.
    `ch_enc` are the encoder's real widths; only the four attention heads
    and the lattice's X_00 see them."""

    def __init__(self, ch_enc: Sequence[int] = (64, 128, 216, 288, 288)):
        super().__init__()
        convs = OrderedDict()
        for i in (4, 3, 2, 1):
            convs[f"f{i}"] = AttentionModule(ch_enc[i], NCE[i])
        for index in LATTICE:
            row, col = int(index[0]), int(index[1])
            src = f"{row + 1}{col - 1}"
            convs[f"X_{src}_Conv_0"] = ConvBlock(NCE[row + 1], NCE[row + 1] // 2)
            high = NCE[row + 1] // 2
            low = (ch_enc[0] if row == 0 else NCE[row]) + NCD[row + 1] * (col - 1)
            if index in ATTENTION:
                convs[f"X_{index}_attention"] = FSEModule(high, low)
            elif col == 1:
                convs[f"X_{src}_Conv_1"] = ConvBlock(high + low, NCD[row + 1])
            else:
                convs[f"X_{index}_downsample"] = Conv1x1(high + low, NCD[row + 1] * 2)
                convs[f"X_{src}_Conv_1"] = ConvBlock(NCD[row + 1] * 2, NCD[row + 1])
        convs["X_04_Conv_0"] = ConvBlock(NCE[0] // 2, NCE[0] // 4)
        convs["X_04_Conv_1"] = ConvBlock(NCE[0] // 4, NCD[0])
        for s in range(4):
            convs[f"dispconv{s}"] = ReflectConv3x3(NCD[s], 1)
        self.convs = nn.ModuleDict(convs)

    def forward(self, features):
        c = self.convs
        X = {"00": features[0]}
        for i in (1, 2, 3, 4):
            X[f"{i}0"] = c[f"f{i}"](features[i])
        for index in LATTICE:
            row, col = int(index[0]), int(index[1])
            src = f"{row + 1}{col - 1}"
            high = c[f"X_{src}_Conv_0"](X[src])
            lows = [X[f"{row}{k}"] for k in range(col)]
            if index in ATTENTION:
                X[index] = c[f"X_{index}_attention"](high, lows)
                continue
            cat = torch.cat([_upsample2x(high)] + lows, dim=1)
            if col != 1:
                cat = c[f"X_{index}_downsample"](cat)
            X[index] = c[f"X_{src}_Conv_1"](cat)
        x = c["X_04_Conv_1"](_upsample2x(c["X_04_Conv_0"](X["04"])))
        return tuple(torch.sigmoid(c[f"dispconv{s}"](y).float())
                     for s, y in enumerate((x, X["04"], X["13"], X["22"])))


class MonoViTDepthNet(nn.Module):
    """MPViT-small encoder + HR decoder. NHWC images in, NHWC disparities
    out (disp_0 full resolution .. disp_3 at H/8); the encoder's drop-path
    masks come from `generator` in train mode. `mpvit` sets the encoder's
    structural fields (MPViT's arguments); the defaults are MPViT-small."""

    def __init__(self, **mpvit):
        super().__init__()
        self.encoder = MPViT(**mpvit)
        self.decoder = HRDecoder(self.encoder.num_ch_enc)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        feats = self.encoder(x.permute(0, 3, 1, 2), generator)
        return tuple(d.permute(0, 2, 3, 1) for d in self.decoder(feats))

    def dispconvs(self):
        return [self.decoder.convs[f"dispconv{s}"].conv for s in range(4)]
