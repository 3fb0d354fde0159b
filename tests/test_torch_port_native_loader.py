"""Port parity: the port's native batch JPEG decoder
(baseboostdepth_tpu_torch/native, its own copy of bbd_loader.cpp built into
build/native/) against the JAX package's, and the training loaders of both
packages at their defaults (use_native=None, which takes the native decoder
wherever it builds).

Everything is held byte for byte: the two libraries are one C++ source
built with the same g++ flags. Skips only where g++ or libjpeg is missing
(neither decoder builds), as tests/test_data.py does. About 3 s on one
worker.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from baseboostdepth_tpu.data import curriculum as jcur
from baseboostdepth_tpu.data import kitti as jkitti
from baseboostdepth_tpu.data import loader as jloader
from baseboostdepth_tpu.native import loader as jnative
from baseboostdepth_tpu_torch.data import curriculum as tcur
from baseboostdepth_tpu_torch.data import kitti as tkitti
from baseboostdepth_tpu_torch.data import loader as tloader
from baseboostdepth_tpu_torch.native import loader as tnative
from torch_port_helpers import lowered_priority

FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"
N_FRAMES = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def native():
    if not (jnative.native_available() and tnative.native_available()):
        pytest.skip("native loader not built (no g++ or libjpeg)")


@pytest.fixture(scope="module")
def kitti_jpegs(tmp_path_factory):
    """Four smooth random JPEGs at KITTI's 1242x375, as chip_smoke.py writes
    them (a 12x40 texture upsampled, quality 90)."""
    root = tmp_path_factory.mktemp("native_jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        base = rng.integers(30, 220, (12, 40, 3), dtype=np.uint8)
        path = str(root / f"{i:010d}.jpg")
        Image.fromarray(base).resize((1242, 375), Image.BILINEAR).save(path, quality=90)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A KITTI-raw tree: one drive, both cameras, small smooth JPEGs, and a
    split file whose baselines mix window sizes."""
    root = tmp_path_factory.mktemp("kitti_native")
    rng = np.random.default_rng(1)
    for cam in (2, 3):
        d = root / FOLDER / f"image_0{cam}" / "data"
        d.mkdir(parents=True)
        for i in range(N_FRAMES):
            base = rng.integers(40, 200, (8, 25, 3), dtype=np.uint8)
            Image.fromarray(base).resize((100, 32), Image.BILINEAR).save(d / f"{i:010d}.jpg")
    baselines = (0.0, 0.02, 0.05, 0.1, 0.3)
    lines = [f"{FOLDER} {i} {'lr'[i % 2]} kt {baselines[i % len(baselines)]}"
             for i in range(1, N_FRAMES - 1)]
    split = root / "train_files_baselines.txt"
    split.write_text("\n".join(lines) + "\n")
    return str(root), str(split)


@pytest.mark.parametrize("size", [(640, 192), (64, 32)], ids=["640x192", "64x32"])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_decode_resize_batch_byte_equal_to_jax(native, kitti_jpegs, size, fast):
    w, h = size
    t_img, t_ok = tnative.decode_resize_batch(kitti_jpegs, w, h, threads=2, fast=fast)
    j_img, j_ok = jnative.decode_resize_batch(kitti_jpegs, w, h, threads=2, fast=fast)
    assert t_img.shape == (len(kitti_jpegs), h, w, 3) and t_img.dtype == np.uint8
    assert t_ok.all() and j_ok.all()
    np.testing.assert_array_equal(t_img, j_img)


def test_missing_path_is_not_ok(native, kitti_jpegs, tmp_path):
    paths = [kitti_jpegs[0], str(tmp_path / "missing.jpg"), kitti_jpegs[1]]
    img, ok = tnative.decode_resize_batch(paths, 64, 32, threads=2)
    assert ok.tolist() == [True, False, True]
    assert not img[1].any()  # a failed slot is zeroed, as JAX's is


def test_library_is_built_under_build_keyed_by_source():
    so = tnative._so_path()
    assert so.parent.parts[-2:] == ("build", "native")
    assert so.name.startswith("libbbd_loader_") and so.suffix == ".so"


@pytest.mark.parametrize("bucket_fs", [None, (2, 5, 7)], ids=["unbucketed", "bucketed"])
def test_train_loaders_at_defaults_byte_identical(native, tree, bucket_fs):
    """Both loaders at use_native=None pick the native decoder here and give
    the same batches."""
    data, split = tree
    epoch = 12 if bucket_fs else 0
    common = dict(height=32, width=64, trimin=True, num_workers=2, seed=3 + epoch,
                  bucket_fs=bucket_fs)
    jl = jloader.KittiTrainLoader(jkitti.KittiRawIndex(data, split),
                                  jcur.stage_for_epoch(epoch, True), 3, **common)
    tl = tloader.KittiTrainLoader(tkitti.KittiRawIndex(data, split),
                                  tcur.stage_for_epoch(epoch, True), 3, **common)
    assert jl.use_native and tl.use_native
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_native_train_loader_raises_on_missing_frame(native, tree, tmp_path):
    data, split = tree
    lines = open(split).read().splitlines()
    bad = tmp_path / "split.txt"
    bad.write_text("\n".join(lines + [f"{FOLDER} 40 l kt 0.0"]) + "\n")
    loader = tloader.KittiTrainLoader(tkitti.KittiRawIndex(data, str(bad)),
                                      tcur.stage_for_epoch(0, True), len(lines) + 1, 32, 64,
                                      trimin=True, num_workers=2, seed=0, use_native=True)
    with pytest.raises(FileNotFoundError, match="0000000040"):
        list(loader)
