"""JAX (flax) parameters -> the port's state_dicts.

`from_jax` maps the JAX package's parameter and BatchNorm-statistics trees
(numpy leaves, `{'depth': ..., 'pose': ...}`) onto the port's depth network
(`MD2DepthNet` of any ResNet depth, `CADepthNet`, `SQLDepthNet`) and
`PoseNet`; it is the inverse of the JAX package's importers of reference
torch checkpoints (`models/torch_import.py`: `resnet_torch_to_flax`,
`depth_decoder_torch_to_flax`, `cadepth_decoder_torch_to_flax`,
`sql_encoder_torch_to_flax`, `sql_head_torch_to_flax`,
`pose_decoder_torch_to_flax`), written again here. Conv kernels go from HWIO
to OIHW and dense kernels are transposed; BN `scale/bias/mean/var` become
`weight/bias/running_mean/running_var`, LayerNorm `scale` becomes `weight`;
flax attention's per-head `query/key/value` kernels [E, h, hd] are packed
into `in_proj_weight` [3E, E] and its `out` kernel [h, hd, E] becomes
`out_proj.weight`. The zoo is read from the tree: a `head` is SQLdepth, a
`dem_4` in the decoder CADepth.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _conv(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _dense(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).T))


def _conv_b(sd, dst, p):
    """A biased flax conv {kernel, bias} -> dst.weight / dst.bias."""
    sd[dst + ".weight"] = _conv(p["kernel"])
    sd[dst + ".bias"] = _t(p["bias"])


def _bn(sd, dst, p, s):
    sd[dst + ".weight"] = _t(p["scale"])
    sd[dst + ".bias"] = _t(p["bias"])
    sd[dst + ".running_mean"] = _t(s["mean"])
    sd[dst + ".running_var"] = _t(s["var"])
    sd[dst + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _encoder(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    """ResnetEncoder: flax conv1, bn1, layer{l}_{b}/{conv,bn}{c},
    downsample_{conv,bn} -> <prefix>conv1, bn1, layer{l}.{b}.*, downsample.0/1."""
    sd: Dict[str, torch.Tensor] = {}
    sd[prefix + "conv1.weight"] = _conv(params["conv1"]["conv"]["kernel"])
    _bn(sd, prefix + "bn1", params["bn1"]["bn"], stats["bn1"]["bn"])
    for name, block in params.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if not m:
            continue
        base = f"{prefix}layer{m.group(1)}.{m.group(2)}"
        bstats = stats[name]
        for sub in block:
            if sub.startswith("conv"):
                sd[f"{base}.{sub}.weight"] = _conv(block[sub]["conv"]["kernel"])
            elif sub.startswith("bn"):
                _bn(sd, f"{base}.{sub}", block[sub]["bn"], bstats[sub]["bn"])
        if "downsample_conv" in block:
            sd[f"{base}.downsample.0.weight"] = _conv(block["downsample_conv"]["conv"]["kernel"])
            _bn(sd, f"{base}.downsample.1", block["downsample_bn"]["bn"],
                bstats["downsample_bn"]["bn"])
    return sd


def _depth_decoder(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    """The md2 decoder (0..9 upconvs, 10..13 dispconvs) or, with DEMs, the
    CA decoder (per stage upconv 0, upconv 1, DEM; 15..18 dispconvs)."""
    sd: Dict[str, torch.Tensor] = {}
    ca = "dem_4" in params
    per_stage = 3 if ca else 2
    for i in range(5):
        base = per_stage * (4 - i)
        for j in range(2):
            _conv_b(sd, f"{prefix}{base + j}.conv.conv", params[f"upconv_{i}_{j}"]["conv"]["conv"])
        if ca:
            p, s, d = params[f"dem_{i}"], stats[f"dem_{i}"], f"{prefix}{base + 2}"
            _conv_b(sd, d + ".conv1.1", p["conv"])
            _bn(sd, d + ".conv1.2", p["bn"], s["bn"])
            _conv_b(sd, d + ".global_path.1", p["gate1"])
            _conv_b(sd, d + ".global_path.3", p["gate2"])
    for s in range(4):
        _conv_b(sd, f"{prefix}{5 * per_stage + s}.conv", params[f"dispconv_{s}"]["conv"])
    return sd


def _sql_decoder(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    """DecoderBN: conv2, up{n}/{conv,bn}{0,1} -> up{n}._net.{0,1,3,4}, conv3."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_b(sd, prefix + "conv2", params["conv2"])
    _conv_b(sd, prefix + "conv3", params["conv3"])
    for n in range(1, 5):
        p, s = params[f"up{n}"], stats[f"up{n}"]
        for k, idx in ((0, 0), (1, 3)):
            _conv_b(sd, f"{prefix}up{n}._net.{idx}", p[f"conv{k}"])
            _bn(sd, f"{prefix}up{n}._net.{idx + 1}", p[f"bn{k}"], s[f"bn{k}"])
    return sd


def _sql_head(params, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv_b(sd, prefix + "embedding_convPxP", params["embedding_conv"])
    sd[prefix + "positional_encodings"] = _t(params["positional_encodings"])
    _conv_b(sd, prefix + "conv3x3", params["conv3x3"])
    _conv_b(sd, prefix + "convert_to_prob.0", params["convert_to_prob"])
    for i, idx in enumerate((0, 2, 4)):
        p = params[f"bins{i + 1}"]
        sd[f"{prefix}bins_regressor.{idx}.weight"] = _dense(p["kernel"])
        sd[f"{prefix}bins_regressor.{idx}.bias"] = _t(p["bias"])
    for i in range(4):
        p, dst = params[f"layer{i}"], f"{prefix}transformer_encoder.layers.{i}."
        attn = p["attn"]
        E = np.shape(attn["out"]["bias"])[0]
        sd[dst + "self_attn.in_proj_weight"] = torch.cat(
            [_dense(np.reshape(attn[n]["kernel"], (E, E))) for n in ("query", "key", "value")])
        sd[dst + "self_attn.in_proj_bias"] = torch.cat(
            [_t(np.reshape(attn[n]["bias"], (E,))) for n in ("query", "key", "value")])
        sd[dst + "self_attn.out_proj.weight"] = _dense(np.reshape(attn["out"]["kernel"], (E, E)))
        sd[dst + "self_attn.out_proj.bias"] = _t(attn["out"]["bias"])
        for name, src in (("linear1", "ff1"), ("linear2", "ff2")):
            sd[f"{dst}{name}.weight"] = _dense(p[src]["kernel"])
            sd[f"{dst}{name}.bias"] = _t(p[src]["bias"])
        for name in ("norm1", "norm2"):
            sd[f"{dst}{name}.weight"] = _t(p[name]["scale"])
            sd[f"{dst}{name}.bias"] = _t(p[name]["bias"])
    return sd


def _pose_decoder(params, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        sd[f"{prefix}{idx}.weight"] = _conv(params[name]["kernel"])
        sd[f"{prefix}{idx}.bias"] = _t(params[name]["bias"])
    return sd


def from_jax(params_np, stats_np) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, batch_stats) trees of a JAX md2, cadepth or sql zoo ->
    (depth network state_dict, PoseNet state_dict)."""
    dp, ds = params_np["depth"], stats_np["depth"]
    pp, ps = params_np["pose"], stats_np["pose"]
    if "head" in dp:  # SQLdepth: encoder-decoder under `encoder.`, head under `head.`
        depth_sd = _encoder(dp["encoder"], ds["encoder"], "encoder.encoder.encoder.")
        depth_sd.update(_sql_decoder(dp["decoder_bn"], ds["decoder_bn"], "encoder.decoder."))
        depth_sd.update(_sql_head(dp["head"], "head."))
    else:
        depth_sd = _encoder(dp["encoder"], ds["encoder"], "encoder.encoder.")
        depth_sd.update(_depth_decoder(dp["decoder"], ds.get("decoder", {}), "decoder.decoder."))
    pose_sd = _encoder(pp["encoder"], ps["encoder"], "encoder.encoder.")
    pose_sd.update(_pose_decoder(pp["decoder"], "decoder.net."))
    return depth_sd, pose_sd
