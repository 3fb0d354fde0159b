"""JAX (flax) parameters -> the port's state_dicts.

`from_jax` maps the JAX package's parameter and BatchNorm-statistics trees
(numpy leaves, `{'depth': ..., 'pose': ...}`) onto `MD2DepthNet` and
`PoseNet`; it is the inverse of `resnet_torch_to_flax`,
`depth_decoder_torch_to_flax` and `pose_decoder_torch_to_flax` in the JAX
package's `models/torch_import.py`, written again here. Conv kernels go from
HWIO to OIHW; BN `scale/bias/mean/var` become
`weight/bias/running_mean/running_var`.
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


def _depth_decoder(params, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for i in range(5):
        for j in range(2):
            p = params[f"upconv_{i}_{j}"]["conv"]["conv"]
            idx = 2 * (4 - i) + j
            sd[f"{prefix}{idx}.conv.conv.weight"] = _conv(p["kernel"])
            sd[f"{prefix}{idx}.conv.conv.bias"] = _t(p["bias"])
    for s in range(4):
        p = params[f"dispconv_{s}"]["conv"]
        sd[f"{prefix}{10 + s}.conv.weight"] = _conv(p["kernel"])
        sd[f"{prefix}{10 + s}.conv.bias"] = _t(p["bias"])
    return sd


def _pose_decoder(params, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        sd[f"{prefix}{idx}.weight"] = _conv(params[name]["kernel"])
        sd[f"{prefix}{idx}.bias"] = _t(params[name]["bias"])
    return sd


def from_jax(params_np, stats_np) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, batch_stats) trees of the JAX md2 zoo -> (MD2DepthNet
    state_dict, PoseNet state_dict)."""
    dp, ds = params_np["depth"], stats_np["depth"]
    pp, ps = params_np["pose"], stats_np["pose"]
    depth_sd = _encoder(dp["encoder"], ds["encoder"], "encoder.encoder.")
    depth_sd.update(_depth_decoder(dp["decoder"], "decoder.decoder."))
    pose_sd = _encoder(pp["encoder"], ps["encoder"], "encoder.encoder.")
    pose_sd.update(_pose_decoder(pp["decoder"], "decoder.net."))
    return depth_sd, pose_sd
