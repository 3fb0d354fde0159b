"""Torch checkpoints -> the port's networks: ImageNet encoders
(torchvision ResNets, the released mpvit_small.pth, an HRNet-18 file) and
the reference's saved weights folders of every zoo, the counterpart of
`baseboostdepth_tpu/models/torch_import.py`.

The port's modules carry the reference's torch attribute names, so an
import is a key map and `load_state_dict(strict=True)`, not a layout
conversion. The key map: entries that are not tensors (the reference's
`height` / `width` / `use_stereo` in `encoder.pth`) are dropped, and a
file whose tensors sit under `model` (the MPViT release) is unwrapped; a
torchvision ResNet's classifier `fc.*`, the MPViT release's `cls_head.*`
and an ImageNet HRNet's heads (`incre_modules`, `downsamp_modules`,
`final_layer`, `classifier`) are dropped; the reference decoders' ModuleList
`decoder.*`, which repeats their `convs.*` ModuleDict, is dropped, and so
are the four lattice blocks MonoViT's HR decoder builds and never runs
(`convs.X_0{0,1,2,3}_Conv_0`); BatchNorm `num_batches_tracked` counters
that older files lack keep the module's own. Every other key must match,
in both directions.
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
    if isinstance(sd.get("model"), dict) and not any(
            torch.is_tensor(v) for k, v in sd.items() if k != "model"):
        sd = sd["model"]  # the MPViT release wraps its tensors under 'model'
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def _without(sd: Dict[str, torch.Tensor], *prefixes: str) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if not k.startswith(prefixes)}


def mpvit_key_map(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The MPViT release's classifier dropped."""
    return _without(sd, "cls_head.")


def hrnet_key_map(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ImageNet HRNet-18's classification heads dropped."""
    return _without(sd, "incre_modules.", "downsamp_modules.", "final_layer.", "classifier.")


def decoder_key_map(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A MonoViT or DIFFNet depth.pth: the `decoder.*` aliases of `convs.*`
    and the HR decoder's unused X_00..X_03 Conv_0 blocks dropped."""
    return _without(sd, "decoder.", *(f"convs.X_0{j}_Conv_0." for j in range(4)))


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
    """ImageNet init: the depth encoder from `path` -- a torchvision ResNet
    .pth for md2 (resnet{num_layers}), cadepth and sql (resnet50;
    trainer.py:61-71), the released mpvit_small.pth for monovit
    (networksvit/mpvit.py:815), an ImageNet HRNet-18 .pth for diffnet
    (test_hr_encoder.py:500-547) -- and the 2-frame pose encoder from a
    resnet18 .pth with its conv1 tiled over the two frames and halved
    (networks/resnet_encoder.py:49-52). The pose encoder is always a
    ResNet-18 (trainer.py:92-99): where the depth encoder is not one, pass
    the resnet18 .pth as `pose_path`; for monovit and diffnet without it
    the pose encoder keeps its init (their files cannot seed a ResNet-18).
    In place."""
    sd = load_torch_state_dict(path)
    if zoo == "monovit":
        load_into(depth_net.encoder, mpvit_key_map(sd))
    elif zoo == "diffnet":
        load_into(depth_net.encoder, hrnet_key_map(sd))
    else:
        load_into(_resnet(depth_net), sd)
    if pose_path is None and zoo in ("monovit", "diffnet"):
        return
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


def import_reference_monovit(folder: str, depth_net: nn.Module, pose_net: nn.Module) -> None:
    """A reference MonoViT folder (encoder.pth = MPViT, depth.pth = the HR
    decoder, + the pose pair) into a MonoViTDepthNet and a PoseNet, in
    place."""
    load_into(depth_net.encoder, mpvit_key_map(_load(folder, "encoder.pth")))
    load_into(depth_net.decoder, decoder_key_map(_load(folder, "depth.pth")))
    _import_pose(folder, pose_net)


def import_reference_diffnet(folder: str, depth_net: nn.Module, pose_net: nn.Module) -> None:
    """A reference DIFFNet folder (encoder.pth = HRNet-18, depth.pth = the
    attention-fusion decoder, + the pose pair; reference
    evaluate_depth.py:170-185) into a DIFFNetDepthNet and a PoseNet, in
    place."""
    load_into(depth_net.encoder, hrnet_key_map(_load(folder, "encoder.pth")))
    load_into(depth_net.decoder, decoder_key_map(_load(folder, "depth.pth")))
    _import_pose(folder, pose_net)


#: one folder importer per zoo (reference checkpoint folders,
#: evaluate_depth.py:141-199 / trainer.py:807-829 load paths)
IMPORTERS = {
    "md2": import_reference_md2,
    "monovit": import_reference_monovit,
    "sql": import_reference_sql,
    "sql_large": import_reference_sql,
    "cadepth": import_reference_cadepth,
    "diffnet": import_reference_diffnet,
}
