"""Port parity of the monovit and diffnet importers, on the CPU, as
tests/test_torch_port_import.py holds the other zoos' (its helpers write
the files): reference weights folders (`encoder.pth` from
tests/torch_mpvit_ref.py's MPViT-small or tests/torch_zoo_refs.py's
HRNet-18 replica, seeded, with the reference's height/width/use_stereo
entries; `depth.pth` from the port's seeded decoder with the reference's
`decoder.*` ModuleList aliases; the pose pair) through `IMPORTERS`, and
the released mpvit_small.pth layout (tensors under 'model', an ImageNet
classifier) and an ImageNet HRNet-18 (its classification heads) through
`load_pretrained_encoder`, each against the JAX package's importer of the
same file, equal to the bit. A file of its own with fewer tests than
tests/test_zoo_training.py, so that xdist queues it behind that file
(ROADMAP.md, Tier-1 verify).

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 20 s.
"""

import pytest
import torch

from baseboostdepth_tpu.models.torch_import import IMPORTERS as JAX_IMPORTERS
from baseboostdepth_tpu.models.torch_import import load_pretrained_encoder as jax_load_pretrained
from baseboostdepth_tpu.training.step import TrainState as JaxTrainState
from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
from baseboostdepth_tpu_torch.models.torch_import import (
    IMPORTERS,
    load_pretrained_encoder,
    load_torch_state_dict,
)
from tests.test_torch_port_import import (
    _assert_equal_to_jax,
    _resnet18_file,
    _seeded,
    _write_folder,
)
from tests.test_torch_port_zoos import depth_to_flax, pose_to_flax
from tests.torch_mpvit_ref import mpvit_small
from tests.torch_zoo_refs import make_hrnet18
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("zoo", ["monovit", "diffnet"])
def test_vit_reference_folder_import_matches_jax(tmp_path, zoo):
    """IMPORTERS[zoo] on a reference-layout folder: every tensor of the
    port's networks equals the JAX importer's (strict key match both
    ways)."""
    folder = _write_folder(str(tmp_path / "weights_19"), zoo)
    gen = torch.Generator().manual_seed(9)
    depth_net, pose_net = build_depth_net(zoo, generator=gen), build_pose_net(gen)
    IMPORTERS[zoo](folder, depth_net, pose_net)
    params, stats = JAX_IMPORTERS[zoo](folder)
    _assert_equal_to_jax(depth_net, pose_net, params, stats)


@pytest.mark.parametrize("zoo,pose", [("monovit", False), ("diffnet", True)])
def test_pretrained_encoder_for_vit_zoos_matches_jax(tmp_path, zoo, pose):
    """load_pretrained_encoder for monovit (the released mpvit_small.pth
    layout: tensors under 'model', an ImageNet classifier `cls_head.*`) and
    diffnet (an ImageNet HRNet-18 with its classification heads): the depth
    encoder loaded, the decoder untouched; the pose encoder from a resnet18
    file given as pose_path, else untouched (their files cannot seed a
    ResNet-18). Equal to JAX's on every tensor."""
    gen = torch.Generator().manual_seed(4)
    if zoo == "monovit":
        enc = _seeded(mpvit_small, 4).state_dict()
        extra = {"cls_head.weight": torch.randn(1000, 288, generator=gen),
                 "cls_head.bias": torch.randn(1000, generator=gen)}
        torch.save({"model": {**enc, **extra}}, str(tmp_path / "mpvit_small.pth"))
        path = str(tmp_path / "mpvit_small.pth")
    else:
        enc = _seeded(make_hrnet18, 4).state_dict()
        extra = {"incre_modules.0.0.conv1.weight": torch.randn(32, 18, 1, 1, generator=gen),
                 "downsamp_modules.0.0.weight": torch.randn(256, 128, 3, 3, generator=gen),
                 "final_layer.0.weight": torch.randn(2048, 1024, 1, 1, generator=gen),
                 "classifier.weight": torch.randn(1000, 2048, generator=gen)}
        path = str(tmp_path / "hrnetv2_w18.pth")
        torch.save({**enc, **extra}, path)
    rn18 = _resnet18_file(str(tmp_path / "resnet18-00000000.pth")) if pose else None
    depth_net, pose_net = build_depth_net(zoo, generator=gen), build_pose_net(gen)
    before = {k: v.clone() for k, v in depth_net.state_dict().items()}
    pose_before = {k: v.clone() for k, v in pose_net.state_dict().items()}
    dp, ds = depth_to_flax(zoo, depth_net.state_dict())
    pp, ps = pose_to_flax(pose_net.state_dict())
    jstate = JaxTrainState(step=0, params={"depth": dp, "pose": pp},
                           stats={"depth": ds, "pose": ps}, opt_state=None)

    load_pretrained_encoder(depth_net, pose_net, path, zoo, pose_path=rn18)
    jstate = jax_load_pretrained(jstate, path, zoo, pose_path=rn18)
    _assert_equal_to_jax(depth_net, pose_net, jstate.params, jstate.stats)

    after = depth_net.state_dict()
    for k, v in after.items():
        if k.startswith("encoder."):
            assert torch.equal(v, enc[k[8:]]), k
        else:
            assert torch.equal(v, before[k]), f"{k} changed"
    if pose:
        w = load_torch_state_dict(rn18)["conv1.weight"]
        assert torch.equal(pose_net.encoder.encoder.conv1.weight, torch.cat([w, w], 1) / 2)
    else:
        assert all(torch.equal(v, pose_before[k]) for k, v in pose_net.state_dict().items())
