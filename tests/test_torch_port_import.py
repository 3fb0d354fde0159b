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
"""

import hashlib
import os
import shutil
import zipfile

import pytest
import torch

from baseboostdepth_tpu.models.torch_import import IMPORTERS as JAX_IMPORTERS
from baseboostdepth_tpu.models.torch_import import load_pretrained_encoder as jax_load_pretrained
from baseboostdepth_tpu.training.step import TrainState as JaxTrainState
from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.models.resnet import ResNet, init_encoder_
from baseboostdepth_tpu_torch.models.torch_import import (
    IMPORTERS,
    load_pretrained_encoder,
    load_torch_state_dict,
)
from baseboostdepth_tpu_torch.utils import download as dl
from tests.test_torch_port_zoos import depth_to_flax, perturb_, pose_to_flax
from tests.torch_mpvit_ref import mpvit_small
from tests.torch_zoo_refs import (
    make_ca_decoder,
    make_hrnet18,
    make_resnet50,
    make_sql_encoder,
    make_sql_head,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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


# ---------------------------------------------------------------------------
# utils/download.py, as tests/test_download.py holds the JAX package's


@pytest.fixture()
def zip_fixture(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "encoder.pth").write_bytes(b"fake-encoder")
    (src / "depth.pth").write_bytes(b"fake-depth")
    zpath = tmp_path / "weights.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for f in src.iterdir():
            zf.write(f, f.name)
    md5 = hashlib.md5(zpath.read_bytes()).hexdigest()
    return str(zpath), md5, str(tmp_path / "models")


def test_download_fetch_verify_unpack(zip_fixture):
    zpath, md5, models_dir = zip_fixture
    folder = dl.download_model_if_doesnt_exist("myweights", models_dir, url=f"file://{zpath}",
                                               md5=md5)
    assert os.path.exists(os.path.join(folder, "encoder.pth"))
    # a second call is a no-op: the unreachable url is never fetched
    assert dl.download_model_if_doesnt_exist(
        "myweights", models_dir, url="http://invalid.invalid/x.zip", md5=md5) == folder


def test_download_checksum_mismatch_raises(zip_fixture):
    zpath, _, models_dir = zip_fixture
    with pytest.raises(RuntimeError, match="checksum"):
        dl.download_model_if_doesnt_exist("bad", models_dir, url=f"file://{zpath}", md5="0" * 32)


def test_download_unknown_name_raises(tmp_path):
    with pytest.raises(KeyError, match="unknown model"):
        dl.download_model_if_doesnt_exist("nope", str(tmp_path))


def test_download_existing_zip_without_md5_not_refetched(zip_fixture):
    zpath, _, models_dir = zip_fixture
    os.makedirs(models_dir, exist_ok=True)
    shutil.copy(zpath, os.path.join(models_dir, "trusted.zip"))
    folder = dl.download_model_if_doesnt_exist("trusted", models_dir,
                                               url="http://invalid.invalid/x.zip", md5=None)
    assert os.path.exists(os.path.join(folder, "encoder.pth"))


def test_fetch_torchvision_resnet_verifies_and_is_a_noop_after(tmp_path, monkeypatch):
    content = b"imagenet-weights"
    src = tmp_path / f"resnet18-{hashlib.sha256(content).hexdigest()[:8]}.pth"
    src.write_bytes(content)
    monkeypatch.setattr(dl, "TORCHVISION_RESNETS", {18: f"file://{src}"})
    path = dl.fetch_torchvision_resnet(18, str(tmp_path / "models"))
    assert open(path, "rb").read() == content
    monkeypatch.setattr(dl, "TORCHVISION_RESNETS",
                        {18: "http://invalid.invalid/" + os.path.basename(path)})
    assert dl.fetch_torchvision_resnet(18, str(tmp_path / "models")) == path


def test_fetch_torchvision_resnet_checksum_mismatch_raises(tmp_path, monkeypatch):
    src = tmp_path / "resnet18-00000000.pth"
    src.write_bytes(b"corrupt")
    monkeypatch.setattr(dl, "TORCHVISION_RESNETS", {18: f"file://{src}"})
    with pytest.raises(RuntimeError, match="checksum"):
        dl.fetch_torchvision_resnet(18, str(tmp_path / "models"))


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
