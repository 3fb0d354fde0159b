"""Torch checkpoints -> the port's networks: torchvision ImageNet ResNets
and the reference's saved weights folders, the counterpart of
`baseboostdepth_tpu/models/torch_import.py` for the md2, cadepth and sql
zoos.

The port's modules carry the reference's torch attribute names, so an
import is a key map and `load_state_dict(strict=True)`, not a layout
conversion. The key map: entries that are not tensors (the reference's
`height` / `width` / `use_stereo` in `encoder.pth`) and a torchvision
ResNet's classifier `fc.*` are dropped; BatchNorm `num_batches_tracked`
counters that older files lack keep the module's own. Every other key must
match, in both directions.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth state dict as CPU tensors, without its non-tensor entries
    (the reference's height/width/use_stereo, trainer.py:798-800)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def load_into(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load `sd` into `module` with the key map above (a ResNet's `fc.*`
    dropped, missing num_batches_tracked filled from the module), then
    strict=True."""
    own = module.state_dict()
    mapped = {k: v for k, v in sd.items() if k in own or k.split(".")[-2:-1] != ["fc"]}
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in mapped:
            mapped[k] = v
    with torch.no_grad():
        module.load_state_dict(mapped, strict=True)


def _resnet(net: nn.Module) -> nn.Module:
    """The torchvision-layout ResNet trunk of a depth or pose network."""
    enc = net.encoder
    return enc.encoder.encoder if hasattr(enc.encoder, "encoder") else enc.encoder


def load_pretrained_encoder(depth_net: nn.Module, pose_net: nn.Module, path: str, zoo: str,
                            pose_path: Optional[str] = None) -> None:
    """ImageNet init: the depth encoder's ResNet from a torchvision ResNet
    .pth (md2: resnet{num_layers}; cadepth and sql: resnet50 --
    trainer.py:61-71), and the 2-frame pose encoder from a resnet18 .pth with
    its conv1 tiled over the two frames and halved
    (networks/resnet_encoder.py:49-52). The pose encoder is always a
    ResNet-18 (trainer.py:92-99): where the depth encoder is not one, pass
    the resnet18 .pth as `pose_path`. In place."""
    if zoo in ("monovit", "diffnet"):
        raise NotImplementedError(
            f"zoo {zoo!r} is not ported yet: ROADMAP.md, A5 (diffnet and monovit)")
    sd = load_torch_state_dict(path)
    load_into(_resnet(depth_net), sd)
    pose_sd = dict(load_torch_state_dict(pose_path) if pose_path else sd)
    w = pose_sd["conv1.weight"]
    pose_sd["conv1.weight"] = torch.cat([w, w], dim=1) / 2.0
    load_into(_resnet(pose_net), pose_sd)


def _load(folder: str, name: str) -> Dict[str, torch.Tensor]:
    return load_torch_state_dict(os.path.join(folder, name))


def _import_pose(folder: str, pose_net: nn.Module) -> None:
    load_into(pose_net.encoder, _load(folder, "pose_encoder.pth"))
    load_into(pose_net.decoder, _load(folder, "pose.pth"))


def import_reference_md2(folder: str, depth_net: nn.Module, pose_net: nn.Module) -> None:
    """A reference weights_* folder (encoder.pth, depth.pth,
    pose_encoder.pth, pose.pth) into an MD2DepthNet of the encoder's depth
    and a PoseNet, in place."""
    load_into(depth_net.encoder, _load(folder, "encoder.pth"))
    load_into(depth_net.decoder, _load(folder, "depth.pth"))
    _import_pose(folder, pose_net)


def import_reference_cadepth(folder: str, depth_net: nn.Module, pose_net: nn.Module) -> None:
    """A reference CADepth folder (encoder.pth = ResNet-50, depth.pth = the
    SPM/DEM decoder, + the pose pair; reference evaluate_depth.py:160-168)
    into a CADepthNet and a PoseNet, in place."""
    import_reference_md2(folder, depth_net, pose_net)


def import_reference_sql(folder: str, depth_net: nn.Module, pose_net: nn.Module) -> None:
    """A reference SQLdepth folder (encoder.pth = ResnetEncoderDecoder,
    depth.pth = the query-transformer head, + the pose pair; reference
    evaluate_depth.py:146-158) into an SQLDepthNet and a PoseNet, in
    place."""
    load_into(depth_net.encoder, _load(folder, "encoder.pth"))
    load_into(depth_net.head, _load(folder, "depth.pth"))
    _import_pose(folder, pose_net)


#: one folder importer per ported zoo (reference checkpoint folders,
#: evaluate_depth.py:141-199 / trainer.py:807-829 load paths)
IMPORTERS = {
    "md2": import_reference_md2,
    "cadepth": import_reference_cadepth,
    "sql": import_reference_sql,
    "sql_large": import_reference_sql,
}
