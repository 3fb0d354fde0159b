"""Port parity: the importers of torch checkpoints, and utils/download.py.

Torchvision-layout ImageNet ResNet files (ResNet-18 from a seeded port
trunk plus a classifier, written without BatchNorm counters as older
torchvision files are; ResNet-50 from tests/torch_zoo_refs.py's replica)
the released mpvit_small.pth (tests/torch_mpvit_ref.py's replica, its
tensors under 'model', plus an ImageNet classifier) and an ImageNet HRNet-18
(tests/torch_zoo_refs.py::make_hrnet18 plus classification heads), and
reference-layout weights folders (md2 at ResNet-18 and -50, CADepth,
SQLdepth, MonoViT, DIFFNet: `encoder.pth` with the reference's
height/width/use_stereo entries and the torchvision classifier, `depth.pth`
(the MonoViT and DIFFNet decoders with their `decoder.*` ModuleList
aliases), `pose_encoder.pth`, `pose.pth`, from seeded port modules and the
replicas) are written with
torch.save, then loaded by the JAX package's `load_pretrained_encoder` /
`IMPORTERS` and by the port's. The JAX result, carried to torch's layout by
models/convert.py::from_jax, must equal the port's networks exactly: both
sides only transpose, tile and halve float32 numbers. The download tests
mirror tests/test_download.py over file:// URLs (no network).

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 35 s.

Some of this file's tests are in test_torch_port_import_pretrained.py (ImageNet encoders, the download
tables, download's main) and test_torch_port_download.py (utils/download.py), so that each file has at most
seven tests: a file with more queues ahead of tests/test_zoo_training.py,
the suite's longest (ROADMAP.md, "The time budget").
"""

import os

import pytest
import torch

from baseboostdepth_tpu.models.torch_import import IMPORTERS as JAX_IMPORTERS
from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.models.resnet import ResNet, init_encoder_
from baseboostdepth_tpu_torch.models.torch_import import IMPORTERS
from tests.test_torch_port_zoos import perturb_
from tests.torch_mpvit_ref import mpvit_small
from tests.torch_zoo_refs import (
    make_ca_decoder,
    make_hrnet18,
    make_resnet50,
    make_sql_encoder,
    make_sql_head,
)
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def _seeded(make, seed):
    """A replica module built under a fixed seed, without touching the
    caller's global RNG, its BN statistics moved off (0, 1)."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        m = make()
    perturb_(m, torch.Generator().manual_seed(seed))
    return m


def _resnet18_file(path, seed=0):
    """A torchvision resnet18 file: conv1 ... layer4 + fc, no
    num_batches_tracked (files saved before torch 0.4.1 lack them)."""
    gen = torch.Generator().manual_seed(seed)
    trunk = ResNet(18)
    init_encoder_(trunk, gen)
    perturb_(trunk, gen)
    sd = {k: v for k, v in trunk.state_dict().items() if not k.endswith("num_batches_tracked")}
    torch.save({**sd, **_fc(512, "", gen)}, path)
    return path


def _resnet50_file(path, seed=1):
    torch.save(_seeded(make_resnet50, seed).state_dict(), path)
    return path


def _fc(width, prefix, gen):
    """The torchvision classifier a ResNet file carries."""
    return {prefix + "fc.weight": torch.randn(1000, width, generator=gen),
            prefix + "fc.bias": torch.randn(1000, generator=gen)}


def _prefixed(sd, prefix):
    return {prefix + k: v for k, v in sd.items()}


def _encoder_pth(sd, path):
    """The reference's encoder.pth: the state dict plus its input size and
    stereo flag (trainer.py:798-800)."""
    torch.save({**sd, "height": 192, "width": 640, "use_stereo": True}, path)


def _write_folder(folder, zoo, num_layers=18, seed=2):
    os.makedirs(folder, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    pose = build_pose_net(gen)
    perturb_(pose, gen)
    torch.save({**pose.encoder.state_dict(), **_fc(512, "encoder.", gen)},
               os.path.join(folder, "pose_encoder.pth"))
    torch.save(pose.decoder.state_dict(), os.path.join(folder, "pose.pth"))
    if zoo == "sql":
        enc = _seeded(make_sql_encoder, seed).state_dict()
        depth = _seeded(make_sql_head, seed + 1).state_dict()
    elif zoo in ("monovit", "diffnet"):
        enc = _seeded(mpvit_small if zoo == "monovit" else make_hrnet18, seed).state_dict()
        dec = build_depth_net(zoo, generator=gen).decoder
        perturb_(dec, gen)
        depth = dec.state_dict()
        # the reference decoders' ModuleList over their convs ModuleDict
        depth.update({f"decoder.{i}.{k.split('.', 2)[2]}": v for i, name in
                      enumerate(dec.convs) for k, v in depth.items()
                      if k.startswith(f"convs.{name}.")})
    elif zoo == "cadepth":
        enc = _prefixed(_seeded(make_resnet50, seed).state_dict(), "encoder.")
        depth = _seeded(make_ca_decoder, seed + 1).state_dict()
    else:
        net = build_depth_net("md2", num_layers, gen)
        perturb_(net, gen)
        enc = {**net.encoder.state_dict(), **_fc(net.encoder.num_ch_enc[-1], "encoder.", gen)}
        depth = net.decoder.state_dict()
    _encoder_pth(enc, os.path.join(folder, "encoder.pth"))
    torch.save(depth, os.path.join(folder, "depth.pth"))
    return folder


def _assert_equal_to_jax(depth_net, pose_net, params, stats):
    dsd, psd = from_jax(params, stats)
    for net, ref in ((depth_net, dsd), (pose_net, psd)):
        own = net.state_dict()
        assert set(own) == set(ref)
        for k, v in own.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("zoo,num_layers", [("md2", 18), ("md2", 50), ("cadepth", 50),
                                            ("sql", 50), ("sql_large", 50)])
def test_reference_folder_import_matches_jax(tmp_path, zoo, num_layers):
    """IMPORTERS[zoo] on a reference-layout folder: every tensor of the
    port's networks equals the JAX importer's (strict key match both
    ways)."""
    folder = _write_folder(str(tmp_path / "weights_19"), "sql" if "sql" in zoo else zoo,
                           num_layers)
    gen = torch.Generator().manual_seed(9)
    depth_net, pose_net = build_depth_net(zoo, num_layers, gen), build_pose_net(gen)
    if zoo == "sql_large":  # sql_large's head is larger: its folder has sql_large's head
        head = build_depth_net("sql_large", 50, gen).head
        perturb_(head, gen)
        torch.save(head.state_dict(), os.path.join(folder, "depth.pth"))
    IMPORTERS[zoo](folder, depth_net, pose_net)
    params, stats = JAX_IMPORTERS[zoo](folder)
    _assert_equal_to_jax(depth_net, pose_net, params, stats)


def test_import_refuses_a_foreign_key(tmp_path):
    """strict=True: a key the network lacks is an error, not a silent skip."""
    folder = _write_folder(str(tmp_path / "w"), "md2")
    sd = torch.load(os.path.join(folder, "depth.pth"))
    sd["decoder.99.conv.weight"] = torch.zeros(1)
    torch.save(sd, os.path.join(folder, "depth.pth"))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        IMPORTERS["md2"](folder, build_depth_net("md2"), build_pose_net())


# ---------------------------------------------------------------------------
# utils/download.py, as tests/test_download.py holds the JAX package's
