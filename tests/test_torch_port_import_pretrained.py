"""Port parity: pretrained ImageNet encoders imported through
models/torch_import.py against the JAX package's importers, the download
tables against the JAX package's, and utils/download.py's main importing a
folder. The setup and tolerances are test_torch_port_import.py's, split
from it so that each file has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~15 s.
"""

import os
import pytest
import torch
import zipfile

from baseboostdepth_tpu.models.torch_import import load_pretrained_encoder as jax_load_pretrained
from baseboostdepth_tpu.training.step import TrainState as JaxTrainState
from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
from baseboostdepth_tpu_torch.models.torch_import import (
    load_pretrained_encoder,
    load_torch_state_dict,
)
from baseboostdepth_tpu_torch.utils import download as dl
from test_torch_port_import import (
    _assert_equal_to_jax,
    _resnet18_file,
    _resnet50_file,
    _write_folder,
)
from tests.test_torch_port_zoos import depth_to_flax, pose_to_flax
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other port test files, at a lowered
    CPU priority (torch_port_helpers.lowered_priority)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("zoo", ["md2", "cadepth", "sql"])
def test_pretrained_encoder_matches_jax(tmp_path, zoo):
    """load_pretrained_encoder: the depth encoder from a torchvision file
    (resnet18 for md2, resnet50 for cadepth and sql), the pose encoder from
    a resnet18 file with conv1 tiled over the two frames and halved; the
    rest of both networks untouched. Equal to JAX's on every tensor."""
    rn18 = _resnet18_file(str(tmp_path / "resnet18-00000000.pth"))
    depth_path = rn18 if zoo == "md2" else _resnet50_file(str(tmp_path / "resnet50.pth"))
    pose_path = None if zoo == "md2" else rn18
    gen = torch.Generator().manual_seed(3)
    depth_net, pose_net = build_depth_net(zoo, 18, gen), build_pose_net(gen)
    before = {k: v.clone() for k, v in depth_net.state_dict().items()}
    dp, ds = depth_to_flax(zoo, depth_net.state_dict())
    pp, ps = pose_to_flax(pose_net.state_dict())
    jstate = JaxTrainState(step=0, params={"depth": dp, "pose": pp},
                           stats={"depth": ds, "pose": ps}, opt_state=None)

    load_pretrained_encoder(depth_net, pose_net, depth_path, zoo, pose_path=pose_path)
    jstate = jax_load_pretrained(jstate, depth_path, zoo, pose_path=pose_path)
    _assert_equal_to_jax(depth_net, pose_net, jstate.params, jstate.stats)

    src = load_torch_state_dict(depth_path)
    trunk = "encoder.encoder.encoder." if zoo == "sql" else "encoder.encoder."
    after = depth_net.state_dict()
    assert torch.equal(after[trunk + "conv1.weight"], src["conv1.weight"])
    for k, v in after.items():
        if not k.startswith(trunk):
            assert torch.equal(v, before[k]), f"{k} changed"
    w = load_torch_state_dict(rn18)["conv1.weight"]
    assert torch.equal(pose_net.encoder.encoder.conv1.weight, torch.cat([w, w], 1) / 2)


def test_download_tables_equal_the_jax_package():
    from baseboostdepth_tpu.utils import download as jax_dl

    assert dl.MODEL_URLS == jax_dl.MODEL_URLS and len(dl.MODEL_URLS) == 9
    assert dl.TORCHVISION_RESNETS == jax_dl.TORCHVISION_RESNETS
    assert sorted(dl.TORCHVISION_RESNETS) == [18, 34, 50, 101, 152]


def test_download_main_imports_a_folder(tmp_path, capsys):
    """main --zoo: fetch (file://) a zipped reference folder and import it
    with the port's IMPORTERS."""
    folder = _write_folder(str(tmp_path / "src"), "md2")
    zpath = tmp_path / "md2.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for name in os.listdir(folder):
            zf.write(os.path.join(folder, name), name)
    dl.main(["md2_weights", "--models_dir", str(tmp_path / "models"), "--url",
             f"file://{zpath}", "--zoo", "md2"])
    out = capsys.readouterr().out
    n = sum(p.numel() for net in (build_depth_net("md2"), build_pose_net())
            for p in net.parameters())
    assert f"imported md2 checkpoint: {n:,} parameters" in out
