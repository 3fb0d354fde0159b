"""utils/download.py over file:// URLs: fetch, verify and unpack, checksum
mismatches, unknown names, an existing zip not fetched again, and the
torchvision ResNet fetch. Split from test_torch_port_import.py so that each
file has at most seven tests (ROADMAP.md, "The time budget"); nothing is fetched from a
network.

Single-worker time: ~2 s.
"""

import hashlib
import os
import pytest
import shutil
import torch
import zipfile

from baseboostdepth_tpu_torch.utils import download as dl
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
