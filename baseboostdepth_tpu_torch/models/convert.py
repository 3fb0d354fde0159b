"""JAX (flax) parameters -> the port's state_dicts.

`from_jax` maps the JAX package's parameter and BatchNorm-statistics trees
(numpy leaves, `{'depth': ..., 'pose': ...}`) onto the port's depth network
(`MD2DepthNet` of any ResNet depth, `CADepthNet`, `SQLDepthNet`) and
`PoseNet`; it is the inverse of the JAX package's importers of reference
torch checkpoints (`models/torch_import.py`: `resnet_torch_to_flax`,
`depth_decoder_torch_to_flax`, `cadepth_decoder_torch_to_flax`,
`sql_encoder_torch_to_flax`, `sql_head_torch_to_flax`, `mpvit_torch_to_flax`,
`monovit_decoder_torch_to_flax`, `hrnet18_torch_to_flax`,
`diffnet_decoder_torch_to_flax`, `pose_decoder_torch_to_flax`), written
again here. Conv kernels go from HWIO
to OIHW and dense kernels are transposed; BN `scale/bias/mean/var` become
`weight/bias/running_mean/running_var`, LayerNorm `scale` becomes `weight`;
flax attention's per-head `query/key/value` kernels [E, h, hd] are packed
into `in_proj_weight` [3E, E] and its `out` kernel [h, hd, E] becomes
`out_proj.weight`. The zoo is read from the tree: a `head` is SQLdepth, a
`dem_4` in the decoder CADepth, a `stem_0` in the encoder MonoViT (MPViT
of any stage, path and block count), a `stem1` in the encoder DIFFNet. The
state dicts carry MPViT's shared position encodings under every alias key
the module has (each block's `cpe` / `crpe` / `factoratt_crpe.crpe`).
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
        if m:
            _block(sd, f"{prefix}layer{m.group(1)}.{m.group(2)}", block, stats[name])
    return sd


def _block(sd, base, block, bstats):
    """A Basic or Bottleneck block: {conv,bn}{c}, downsample_{conv,bn} ->
    base.{conv,bn}{c}, base.downsample.0/1."""
    for sub in block:
        if sub.startswith("conv"):
            sd[f"{base}.{sub}.weight"] = _conv(block[sub]["conv"]["kernel"])
        elif sub.startswith("bn"):
            _bn(sd, f"{base}.{sub}", block[sub]["bn"], bstats[sub]["bn"])
    if "downsample_conv" in block:
        sd[f"{base}.downsample.0.weight"] = _conv(block["downsample_conv"]["conv"]["kernel"])
        _bn(sd, f"{base}.downsample.1", block["downsample_bn"]["bn"],
            bstats["downsample_bn"]["bn"])


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


def _linear_b(sd, dst, p):
    sd[dst + ".weight"] = _dense(p["kernel"])
    sd[dst + ".bias"] = _t(p["bias"])


def _conv_bn(sd, dst, p, s):
    """An MPViT ConvBN {conv, bn} -> dst.conv.weight, dst.bn.*."""
    sd[dst + ".conv.weight"] = _conv(p["conv"]["kernel"])
    _bn(sd, dst + ".bn", p["bn"], s["bn"])


def _mpvit(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    """MPViT: stem_{i}, stage{s}_embed{p}, stage{s}_invres, stage{s}_path{p}
    (cpe, crpe/conv_{k}, block_{i}), stage{s}_aggregate -> the reference's
    stem / patch_embed_stages / mhca_stages names."""
    sd: Dict[str, torch.Tensor] = {}
    for i in (0, 1):
        _conv_bn(sd, f"{prefix}stem.{i}", params[f"stem_{i}"], stats[f"stem_{i}"])
    for name, p in params.items():
        m = re.fullmatch(r"stage(\d)_(embed|path|invres|aggregate)(\d*)", name)
        if not m:
            continue
        st, kind, idx = m.group(1), m.group(2), m.group(3)
        stage = f"{prefix}mhca_stages.{st}"
        if kind == "embed":
            dst = f"{prefix}patch_embed_stages.{st}.patch_embeds.{idx}.patch_conv"
            sd[dst + ".dwconv.weight"] = _conv(p["dwconv"]["kernel"])
            sd[dst + ".pwconv.weight"] = _conv(p["pwconv"]["kernel"])
            _bn(sd, dst + ".bn", p["bn"], stats[name]["bn"])
        elif kind == "aggregate":
            _conv_bn(sd, stage + ".aggregate", p, stats[name])
        elif kind == "invres":
            s, dst = stats[name], stage + ".InvRes"
            _conv_bn(sd, dst + ".conv1", p["conv1"], s["conv1"])
            sd[dst + ".dwconv.weight"] = _conv(p["dwconv"]["kernel"])
            _bn(sd, dst + ".norm", p["norm"], s["norm"])
            _conv_bn(sd, dst + ".conv2", p["conv2"], s["conv2"])
        else:
            dst = f"{stage}.mhca_blks.{idx}"
            shared: Dict[str, torch.Tensor] = {}
            _conv_b(shared, "cpe.proj", p["cpe"]["proj"])
            for k, conv in p["crpe"].items():
                _conv_b(shared, f"crpe.conv_list.{k.split('_')[1]}", conv)
            blocks = sorted(int(b.split("_")[1]) for b in p if b.startswith("block_"))
            aliases = [""] + [f"MHCA_layers.{i}." for i in blocks]
            aliases += [f"MHCA_layers.{i}.factoratt_crpe." for i in blocks]
            for alias in aliases:
                for k, v in shared.items():
                    if not (alias.endswith("factoratt_crpe.") and k.startswith("cpe")):
                        sd[f"{dst}.{alias}{k}"] = v
            for i in blocks:
                b, blk = p[f"block_{i}"], f"{dst}.MHCA_layers.{i}"
                for n in ("norm1", "norm2"):
                    sd[f"{blk}.{n}.weight"] = _t(b[n]["scale"])
                    sd[f"{blk}.{n}.bias"] = _t(b[n]["bias"])
                _linear_b(sd, blk + ".factoratt_crpe.qkv", b["attn"]["qkv"])
                _linear_b(sd, blk + ".factoratt_crpe.proj", b["attn"]["proj"])
                _linear_b(sd, blk + ".mlp.fc1", b["mlp_fc1"])
                _linear_b(sd, blk + ".mlp.fc2", b["mlp_fc2"])
    return sd


def _se(sd, dst, p):
    """An SE gate's bias-free dense pair fc1, fc2 -> dst.fc.0, dst.fc.2."""
    sd[dst + ".fc.0.weight"] = _dense(p["fc1"]["kernel"])
    sd[dst + ".fc.2.weight"] = _dense(p["fc2"]["kernel"])


def _hr_decoder(params, prefix: str) -> Dict[str, torch.Tensor]:
    """MonoViT's HRDecoder -> the reference's convs.* names: X_{ij}_conv0 ->
    X_{ij}_Conv_0; X_{rc}_conv1 -> X_{r+1}{c-1}_Conv_1 (the reference keys
    it by its input node), X_04's own second conv -> X_04_Conv_1."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        dst = prefix + name
        if re.fullmatch(r"f\d", name):
            _se(sd, dst + ".ca", p["ca"])
            _conv_b(sd, dst + ".conv_se", p["conv_se"])
        elif name.endswith("_conv0"):
            _conv_b(sd, f"{prefix}{name[:4]}_Conv_0.conv.conv", p["conv"]["conv"])
        elif name.endswith("_conv1"):
            r, c = int(name[2]), int(name[3])
            src = "04" if (r, c) == (0, 4) else f"{r + 1}{c - 1}"
            _conv_b(sd, f"{prefix}X_{src}_Conv_1.conv.conv", p["conv"]["conv"])
        elif name.endswith("_att"):
            _se(sd, f"{prefix}{name[:4]}_attention", p)
            _conv_b(sd, f"{prefix}{name[:4]}_attention.conv_se", p["conv_se"])
        elif name.endswith("_down"):
            sd[f"{prefix}{name[:4]}_downsample.conv.weight"] = _conv(p["kernel"])
        elif name.startswith("dispconv"):
            _conv_b(sd, dst + ".conv", p["conv"])
    return sd


def _conv_bn_relu(sd, dst, p, s, conv=".0", bn=".1"):
    """A ConvBNRelu {conv: {conv}, bn: {bn}} -> dst<conv>.weight, dst<bn>.*."""
    sd[dst + conv + ".weight"] = _conv(p["conv"]["conv"]["kernel"])
    _bn(sd, dst + bn, p["bn"]["bn"], s["bn"]["bn"])


def _hrnet(params, stats, prefix: str) -> Dict[str, torch.Tensor]:
    """HRNet-18: stem{1,2}, layer1_{b}, tr{n}_{i}, stage{s}_m{m}/{branch{i}_
    block{b}, fuse{i}_{j}_{conv,bn}, fuse{i}_{j}_down{k}} -> the reference's
    conv1/bn1/conv2/bn2, layer1, transition{n}, stage{s} names."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_bn_relu(sd, prefix, params["stem1"], stats["stem1"], "conv1", "bn1")
    _conv_bn_relu(sd, prefix, params["stem2"], stats["stem2"], "conv2", "bn2")
    for name, p in params.items():
        s = stats[name]
        if name.startswith("layer1_"):
            _block(sd, f"{prefix}layer1.{name[7:]}", p, s)
        elif name.startswith("tr"):
            n, i = name[2], name[4]
            nested = "" if name == "tr1_0" else ".0"  # new branches nest once more
            _conv_bn_relu(sd, f"{prefix}transition{n}.{i}{nested}", p, s)
        elif name.startswith("stage"):
            base = f"{prefix}{name[:6]}.{name[8:]}"
            for sub, q in p.items():
                m = re.fullmatch(r"branch(\d)_block(\d)|fuse(\d)_(\d)_(conv|bn|down)(\d*)", sub)
                if m.group(1) is not None:
                    _block(sd, f"{base}.branches.{m.group(1)}.{m.group(2)}", q, s[sub])
                    continue
                dst = f"{base}.fuse_layers.{m.group(3)}.{m.group(4)}"
                if m.group(5) == "conv":
                    sd[dst + ".0.weight"] = _conv(q["conv"]["kernel"])
                elif m.group(5) == "bn":
                    _bn(sd, dst + ".1", q["bn"], s[sub]["bn"])
                else:
                    _conv_bn_relu(sd, f"{dst}.{m.group(6)}", q, s[sub])
    return sd


def _diffnet_decoder(params, prefix: str) -> Dict[str, torch.Tensor]:
    """att{72,36,18,9}, up_x9_{0,1}, dispconv{s} -> convs.{72,...},
    convs.up_x9_{0,1}, convs.dispConvScale{s}."""
    sd: Dict[str, torch.Tensor] = {}
    for n in ("72", "36", "18", "9"):
        _se(sd, f"{prefix}{n}.ca", params[f"att{n}"]["ca"])
        _conv_b(sd, f"{prefix}{n}.conv_se", params[f"att{n}"]["conv_se"])
    for n in ("up_x9_0", "up_x9_1"):
        _conv_b(sd, f"{prefix}{n}.conv.conv", params[n]["conv"]["conv"])
    for i in range(4):
        _conv_b(sd, f"{prefix}dispConvScale{i}.conv", params[f"dispconv{i}"]["conv"])
    return sd


def _pose_decoder(params, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        sd[f"{prefix}{idx}.weight"] = _conv(params[name]["kernel"])
        sd[f"{prefix}{idx}.bias"] = _t(params[name]["bias"])
    return sd


def from_jax(params_np, stats_np) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, batch_stats) trees of a JAX md2, cadepth, sql, monovit or
    diffnet zoo -> (depth network state_dict, PoseNet state_dict)."""
    dp, ds = params_np["depth"], stats_np["depth"]
    pp, ps = params_np["pose"], stats_np["pose"]
    if "stem_0" in dp["encoder"]:  # MonoViT
        depth_sd = _mpvit(dp["encoder"], ds["encoder"], "encoder.")
        depth_sd.update(_hr_decoder(dp["decoder"], "decoder.convs."))
    elif "stem1" in dp["encoder"]:  # DIFFNet
        depth_sd = _hrnet(dp["encoder"], ds["encoder"], "encoder.")
        depth_sd.update(_diffnet_decoder(dp, "decoder.convs."))
    elif "head" in dp:  # SQLdepth: encoder-decoder under `encoder.`, head under `head.`
        depth_sd = _encoder(dp["encoder"], ds["encoder"], "encoder.encoder.encoder.")
        depth_sd.update(_sql_decoder(dp["decoder_bn"], ds["decoder_bn"], "encoder.decoder."))
        depth_sd.update(_sql_head(dp["head"], "head."))
    else:
        depth_sd = _encoder(dp["encoder"], ds["encoder"], "encoder.encoder.")
        depth_sd.update(_depth_decoder(dp["decoder"], ds.get("decoder", {}), "decoder.decoder."))
    pose_sd = _encoder(pp["encoder"], ps["encoder"], "encoder.encoder.")
    pose_sd.update(_pose_decoder(pp["decoder"], "decoder.net."))
    return depth_sd, pose_sd
