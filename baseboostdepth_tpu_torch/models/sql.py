"""SQLdepth in PyTorch, the counterpart of `baseboostdepth_tpu/models/sql.py`:
a ResNet-50 encoder-decoder and the Self-Query-Layer transformer head
(reference networksSQL/, trainer.py:60-67).

- The encoder-decoder (networksSQL/resnet_encoder.py:96-150): ResNet-50
  features and a BN U-Net (DecoderBN) -> a dense model_dim=32 feature map
  at H/2, with bilinear align_corners=True upsampling between stages.
- The head (networksSQL/lite_depth_decoder_QTR.py:6-74): 16x16 patch
  embedding + learned positional encodings (500 slots), a 4-layer post-LN
  transformer encoder (d=32, 4 heads, ff=512, dropout 0.1), 64 queries;
  the full query layer (networksSQL/layers.py:4-21) computes softmax
  energy maps and query summaries; a bins regressor turns the summaries
  into adaptive depth-bin widths (cumsum -> centers); softmax(prob) .
  centers is METRIC DEPTH (min 0.001, max 80): the zoo's "disparity" output
  is depth, which the step and the evaluators read through DEPTH_IS_METRIC.

Module names are the reference's: the encoder-decoder's `encoder.encoder.*`
(torchvision ResNet-50) and `decoder.conv2` / `up{1..4}._net.{0,1,3,4}` /
`conv3`, the head's `embedding_convPxP`, `positional_encodings`,
`transformer_encoder.layers.{i}.self_attn.in_proj_weight` / `out_proj` /
`linear1` / `linear2` / `norm1` / `norm2`, `conv3x3`, `bins_regressor` and
`convert_to_prob`, so a published `encoder.pth` (less its `fc.*`) and
`depth.pth` load with `load_state_dict`. Quirks of the reference kept as
they are: DecoderBN's conv2 is a 1x1 conv with padding 1, and the
positional table has 500 rows.

Attention is written as matmul + softmax so that its dropout, like the
feed-forward dropouts, draws from an explicit torch.Generator (the
forward's `generator`; torch's default generator when None). A rate of 0
draws nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from baseboostdepth_tpu_torch.models.resnet import BatchNorm2d, ResnetEncoder
from baseboostdepth_tpu_torch.ops.resize import resize_bilinear_align_corners
from baseboostdepth_tpu_torch.parallel.sharding import draw_local


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout at rate p, its mask drawn from `generator` (at the
    global batch in a process group: this rank's rows of the one-process
    draw; x's leading axis is the batch)."""
    if not training or p == 0.0:
        return x
    keep = draw_local(torch.rand, x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


class UpSampleBN(nn.Module):
    """Bilinear (align_corners=True) upsample to the skip's size, concat,
    then 2 x (conv3x3 + BN + LeakyReLU)."""

    def __init__(self, skip_input: int, output_features: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, output_features, 3, 1, 1), BatchNorm2d(output_features),
            nn.LeakyReLU(0.01),
            nn.Conv2d(output_features, output_features, 3, 1, 1), BatchNorm2d(output_features),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x, skip):
        x = resize_bilinear_align_corners(x, skip.shape[2], skip.shape[3])
        return self._net(torch.cat([x, skip], dim=1))


class DecoderBN(nn.Module):
    def __init__(self, num_ch_enc, num_features: int = 256, model_dim: int = 32):
        super().__init__()
        f = num_features
        self.conv2 = nn.Conv2d(num_ch_enc[4], f, 1, 1, 1)  # padding 1, as the reference
        self.up1 = UpSampleBN(f + num_ch_enc[3], f // 2)
        self.up2 = UpSampleBN(f // 2 + num_ch_enc[2], f // 4)
        self.up3 = UpSampleBN(f // 4 + num_ch_enc[1], f // 8)
        self.up4 = UpSampleBN(f // 8 + num_ch_enc[0], f // 16)
        self.conv3 = nn.Conv2d(f // 16, model_dim, 3, 1, 1)

    def forward(self, feats):
        x = self.conv2(feats[4])
        x = self.up1(x, feats[3])
        x = self.up2(x, feats[2])
        x = self.up3(x, feats[1])
        x = self.up4(x, feats[0])
        return self.conv3(x)


class ResnetEncoderDecoder(nn.Module):
    """ResNet-50 features + DecoderBN -> [B, model_dim, H/2, W/2]."""

    def __init__(self, num_layers: int = 50, model_dim: int = 32):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers)
        self.decoder = DecoderBN(self.encoder.num_ch_enc, model_dim=model_dim)

    def forward(self, x):
        return self.decoder(self.encoder(x))


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (in_proj_weight [3E, E],
    in_proj_bias, out_proj) as plain matmul + softmax, dropout on the
    attention weights."""

    def __init__(self, dim: int, heads: int, dropout_rate: float):
        super().__init__()
        self.heads = heads
        self.dropout_rate = dropout_rate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, generator=None):
        B, N, E = x.shape
        hd = E // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, N, self.heads, hd).transpose(1, 2) for t in (q, k, v))
        scores = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        attn = dropout(attn, self.dropout_rate, self.training, generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, E)
        return self.out_proj(out)


class TransformerLayer(nn.Module):
    """nn.TransformerEncoderLayer's computation: post-LN, ReLU
    feed-forward, dropout on the attention weights and both feed-forward
    outputs."""

    def __init__(self, dim: int, heads: int, ff: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = SelfAttention(dim, heads, dropout_rate)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, generator=None):
        p, train = self.dropout_rate, self.training
        x = self.norm1(x + dropout(self.self_attn(x, generator), p, train, generator))
        y = dropout(F.relu(self.linear1(x)), p, train, generator)
        y = dropout(self.linear2(y), p, train, generator)
        return self.norm2(x + y)


class _TransformerEncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class SQLHead(nn.Module):
    """Self Query Layer + adaptive bins: [B, C, h, w] -> metric depth
    [B, 1, h, w] in float32."""

    def __init__(self, in_channels: int = 32, embedding_dim: int = 32, patch_size: int = 16,
                 num_heads: int = 4, query_nums: int = 64, dim_out: int = 64,
                 ff_dim: int = 512, min_val: float = 0.001, max_val: float = 80.0,
                 dropout_rate: float = 0.1):
        super().__init__()
        E = embedding_dim
        self.query_nums, self.min_val, self.max_val = query_nums, min_val, max_val
        self.embedding_convPxP = nn.Conv2d(in_channels, E, patch_size, patch_size, 0)
        self.positional_encodings = nn.Parameter(torch.empty(500, E))
        self.transformer_encoder = _TransformerEncoder(
            [TransformerLayer(E, num_heads, ff_dim, dropout_rate) for _ in range(4)])
        self.conv3x3 = nn.Conv2d(in_channels, E, 3, 1, 1)
        self.bins_regressor = nn.Sequential(
            nn.Linear(E * query_nums, 16 * query_nums), nn.LeakyReLU(0.01),
            nn.Linear(16 * query_nums, 16 * 16), nn.LeakyReLU(0.01),
            nn.Linear(16 * 16, dim_out),
        )
        # the reference's Sequential(conv, Softmax(dim=1)); the softmax runs
        # in float32 in forward
        self.convert_to_prob = nn.Sequential(nn.Conv2d(query_nums, dim_out, 1, 1, 0))

    def forward(self, x0, generator=None):
        B, _, H, W = x0.shape
        Q = self.query_nums
        emb = self.embedding_convPxP(x0)
        N = emb.shape[2] * emb.shape[3]
        if N < Q:
            raise ValueError(
                f"SQL head needs >= {Q} patch tokens, got {N}; input resolution too small "
                "(the reference runs 192x640 -> 120 tokens)")
        tokens = emb.flatten(2).transpose(1, 2) + self.positional_encodings[None, :N]
        for layer in self.transformer_encoder.layers:
            tokens = layer(tokens, generator)
        queries = tokens[:, :Q]  # [B, Q, E]

        flat = self.conv3x3(x0).flatten(2).transpose(1, 2)  # [B, HW, E]
        energy = torch.matmul(flat, queries.transpose(1, 2))  # [B, HW, Q]
        attn = torch.softmax(energy.float(), dim=1).to(energy.dtype)
        summary = torch.matmul(attn.transpose(1, 2), flat)  # [B, Q, E]
        energy_maps = energy.transpose(1, 2).reshape(B, Q, H, W)

        y = self.bins_regressor(summary.reshape(B, -1))
        y = F.relu(y.float()) + 0.1  # norm='linear'
        y = y / y.sum(dim=1, keepdim=True)
        prob = torch.softmax(self.convert_to_prob(energy_maps).float(), dim=1)

        bin_widths = F.pad((self.max_val - self.min_val) * y, (1, 0), value=self.min_val)
        edges = torch.cumsum(bin_widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])  # [B, dim_out]
        return (prob * centers[:, :, None, None]).sum(dim=1, keepdim=True)


class SQLDepthNet(nn.Module):
    """The SQLdepth zoo: NHWC images -> a tuple of four references to ONE map,
    metric depth [B, H/2, W/2, 1]; the trainer runs SQL with scales (0,)
    (trainer.py:209-212). `large` is sql_large (patch 20, 128 queries and
    bins)."""

    def __init__(self, large: bool = False, num_layers: int = 50, dropout_rate: float = 0.1):
        super().__init__()
        self.encoder = ResnetEncoderDecoder(num_layers)
        head = dict(patch_size=20, dim_out=128, query_nums=128) if large else {}
        self.head = SQLHead(dropout_rate=dropout_rate, **head)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        depth = self.head(self.encoder(x.permute(0, 3, 1, 2)), generator).permute(0, 2, 3, 1)
        return (depth, depth, depth, depth)

    def dispconvs(self):
        return []


def init_sql_(net: SQLDepthNet, generator: Optional[torch.Generator]) -> None:
    """The encoder as torchvision initialises it, the rest as flax does:
    lecun_normal weights with zero bias (the attention's packed in_proj
    too), norms (1, 0), the positional table uniform in [0, 1)."""
    from baseboostdepth_tpu_torch.models.depth_decoder import init_decoder_, lecun_normal_
    from baseboostdepth_tpu_torch.models.resnet import init_encoder_

    init_encoder_(net.encoder.encoder, generator)
    init_decoder_(net.encoder.decoder, generator)
    init_decoder_(net.head, generator)
    with torch.no_grad():
        for layer in net.head.transformer_encoder.layers:
            lecun_normal_(layer.self_attn.in_proj_weight, generator)
            nn.init.zeros_(layer.self_attn.in_proj_bias)
        net.head.positional_encodings.uniform_(0.0, 1.0, generator=generator)
