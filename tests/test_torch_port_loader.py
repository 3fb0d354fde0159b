"""Port parity: the host-side data modules of baseboostdepth_tpu_torch
(loader, curriculum, KITTI index and calibration, validation metrics,
utilities) against the JAX package's, on a tiny JPEG tree.

Batches must be byte-identical (same plan from the same numpy RNG stream,
same decoder: PIL with use_native=False on both sides, each package's
default otherwise); curriculum draws and indices equal; metrics to 1e-6
relative (the same numpy expressions, so in practice equal). The native
decoders are held against each other in test_torch_port_native_loader.py.
"""

import os

import numpy as np
import pytest
from PIL import Image

from baseboostdepth_tpu.data import curriculum as jcur
from baseboostdepth_tpu.data import kitti as jkitti
from baseboostdepth_tpu.data import kitti_utils as jku
from baseboostdepth_tpu.data import loader as jloader
from baseboostdepth_tpu.evaluation import metrics as jmetrics
from baseboostdepth_tpu.utils import misc as jmisc
from baseboostdepth_tpu_torch.data import curriculum as tcur
from baseboostdepth_tpu_torch.data import kitti as tkitti
from baseboostdepth_tpu_torch.data import kitti_utils as tku
from baseboostdepth_tpu_torch.data import loader as tloader
from baseboostdepth_tpu_torch.evaluation import metrics as tmetrics
from baseboostdepth_tpu_torch.utils import misc as tmisc

FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"
N_FRAMES = 24
BASELINES = (0.0, 0.02, 0.05, 0.1, 0.3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A KITTI-raw tree: one drive, both cameras, smooth random JPEGs, and a
    split file whose baselines mix window sizes (0 = the stage's budget)."""
    root = tmp_path_factory.mktemp("kitti_loader")
    rng = np.random.default_rng(0)
    for cam in (2, 3):
        d = root / FOLDER / f"image_0{cam}" / "data"
        d.mkdir(parents=True)
        for i in range(N_FRAMES):
            base = rng.integers(40, 200, (8, 25, 3), dtype=np.uint8)
            img = Image.fromarray(base).resize((100, 32), Image.BILINEAR)
            img.save(d / f"{i:010d}.jpg")
    lines = [f"{FOLDER} {i} {'lr'[i % 2]} kt {BASELINES[i % len(BASELINES)]}"
             for i in range(1, N_FRAMES - 1)]
    split = root / "train_files_baselines.txt"
    split.write_text("\n".join(lines) + "\n")
    return str(root), str(split)


def _indices(tree):
    data, split = tree
    return jkitti.KittiRawIndex(data, split), tkitti.KittiRawIndex(data, split)


def _assert_batches_equal(jb, tb):
    assert len(jb) == len(tb) and len(tb) > 0
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


CASES = {
    "unbucketed": dict(epoch=0, batch_size=4),
    "unbucketed_skip": dict(epoch=0, batch_size=4, skip_batches=2),
    "bucketed": dict(epoch=12, batch_size=3, bucket_fs=(2, 5, 7)),
    "bucketed_skip": dict(epoch=12, batch_size=3, bucket_fs=(2, 5, 7), skip_batches=1),
    "classic": dict(epoch=0, batch_size=4, classic=True, trimin=False),
    "process_slice": dict(epoch=3, batch_size=4, process_index=1, process_count=2),
    "defaults": dict(epoch=0, batch_size=4, use_native=None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batches_byte_identical_to_jax_loader(tree, case):
    """PIL on both sides (use_native=False), or both packages at their
    default decoder choice (use_native not passed: the native decoder
    wherever it builds, PIL elsewhere)."""
    kw = dict(CASES[case])
    epoch = kw.pop("epoch")
    trimin = kw.pop("trimin", True)
    if kw.pop("use_native", False) is not None:
        kw["use_native"] = False
    jidx, tidx = _indices(tree)
    common = dict(height=32, width=64, trimin=trimin, num_workers=2, seed=7 + epoch, **kw)
    jl = jloader.KittiTrainLoader(jidx, jcur.stage_for_epoch(epoch, trimin), **common)
    tl = tloader.KittiTrainLoader(tidx, tcur.stage_for_epoch(epoch, trimin), **common)
    assert jl.use_native == tl.use_native
    jb, tb = list(jl), list(tl)
    _assert_batches_equal(jb, tb)
    if "bucket_fs" in kw:  # the classes really mix
        assert len({b["frames"].shape[1] for b in tb}) > 1


def test_eval_loader_and_native_decoder_refused(tree):
    """EvalLoader (PIL in both packages) and load_resized are equal; the
    port's training loader no longer refuses a decoder: use_native=False on
    both sides decodes with PIL and gives equal batches."""
    data, _ = tree
    paths = [os.path.join(data, FOLDER, "image_02", "data", f"{i:010d}.jpg") for i in range(5)]
    jb = list(jloader.EvalLoader(paths, 32, 64, batch_size=2, num_workers=2))
    tb = list(tloader.EvalLoader(paths, 32, 64, batch_size=2, num_workers=2))
    assert len(tb) == 3
    for (ja, js, jn), (ta, ts, tn) in zip(jb, tb):
        np.testing.assert_array_equal(ja, ta)
        assert (js, jn) == (ts, tn)
    np.testing.assert_array_equal(jloader.load_resized(paths[0], 64, 32),
                                  tloader.load_resized(paths[0], 64, 32))
    jidx, tidx = _indices(tree)
    common = dict(batch_size=4, height=32, width=64, trimin=True, num_workers=2, seed=2,
                  use_native=False)
    jl = jloader.KittiTrainLoader(jidx, jcur.stage_for_epoch(0, True), **common)
    tl = tloader.KittiTrainLoader(tidx, tcur.stage_for_epoch(0, True), **common)
    assert jl.use_native is False and tl.use_native is False
    _assert_batches_equal(list(jl), list(tl))


def test_curriculum_equal():
    for epoch in range(20):
        for trimin in (True, False):
            for switch in (10, 5):
                for sql in (False, True):
                    js = jcur.stage_for_epoch(epoch, trimin, switch, sql)
                    ts = tcur.stage_for_epoch(epoch, trimin, switch, sql)
                    assert (js.epoch, js.F, js.cutoff, js.scales, js.incremental_active) == (
                        ts.epoch, ts.F, ts.cutoff, ts.scales, ts.incremental_active)
    for epoch in range(20):
        stage_j = jcur.stage_for_epoch(epoch, True)
        stage_t = tcur.stage_for_epoch(epoch, True)
        for baseline in (0.0, -1.0, 0.01, 0.03, 0.05, 0.1, 0.2, 0.5, 2.0):
            for seed in range(6):
                for exists in (None, lambda o: -3 <= o <= 5):
                    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
                    assert jcur.sample_f_max(baseline, stage_j, rj, exists) == \
                        tcur.sample_f_max(baseline, stage_t, rt, exists)
                    assert rj.random() == rt.random()  # the same draws were consumed


def test_kitti_index_and_intrinsics_equal(tree):
    jidx, tidx = _indices(tree)
    assert len(jidx) == len(tidx) == N_FRAMES - 2
    for a, b in zip(jidx.samples, tidx.samples):
        assert (a.folder, a.frame_index, a.side, a.baseline) == (
            b.folder, b.frame_index, b.side, b.baseline)
        assert jidx.image_path(a.folder, a.frame_index, a.side) == \
            tidx.image_path(b.folder, b.frame_index, b.side)
        for o in (-2, 0, 30):
            assert jidx.exists(a.folder, a.frame_index + o, a.side) == \
                tidx.exists(b.folder, b.frame_index + o, b.side)
    for line in ("f 3", "f 3 r", "f 3 l kt 0.25", "f"):
        a, b = jkitti.parse_split_line(line), tkitti.parse_split_line(line)
        assert (a.folder, a.frame_index, a.side, a.baseline) == (
            b.folder, b.frame_index, b.side, b.baseline)
    assert tkitti.OTHER_SIDE == jkitti.OTHER_SIDE
    for w, h in ((640, 192), (64, 32)):
        for a, b in zip(jkitti.intrinsics(w, h), tkitti.intrinsics(w, h)):
            np.testing.assert_array_equal(a, b)


def test_calibration_and_depth_projection_equal(tmp_path):
    """read_calib_file and generate_depth_map on a synthetic calibration
    and velodyne scan (with duplicate hits, so the nearest-point rule acts)."""
    rng = np.random.default_rng(3)
    P = np.array([[700.0, 0, 60, 0], [0, 700.0, 20, 0], [0, 0, 1, 0]])
    (tmp_path / "calib_cam_to_cam.txt").write_text(
        "calib_time: 09-Jan-2012 13:57:47\n"
        "S_rect_02: 1.2e+02 4.0e+01\n"
        f"R_rect_00: {' '.join(map(str, np.eye(3).ravel()))}\n"
        f"P_rect_02: {' '.join(map(str, P.ravel()))}\n")
    R = np.array([[0.0, -1, 0], [0, 0, -1], [1, 0, 0]])
    (tmp_path / "calib_velo_to_cam.txt").write_text(
        f"R: {' '.join(map(str, R.ravel()))}\nT: 0.0 0.0 0.0\n")
    pts = np.concatenate([rng.uniform([2, -3, -1, 0], [40, 3, 1, 1], (400, 4)),
                          np.tile([[10.0, 0.0, 0.0, 1.0], [12.0, 0.0, 0.0, 1.0]], (3, 1))])
    velo = tmp_path / "scan.bin"
    pts.astype(np.float32).tofile(velo)
    a = jku.read_calib_file(str(tmp_path / "calib_cam_to_cam.txt"))
    b = tku.read_calib_file(str(tmp_path / "calib_cam_to_cam.txt"))
    assert a.keys() == b.keys() and a["calib_time"] == b["calib_time"]
    np.testing.assert_array_equal(a["P_rect_02"], b["P_rect_02"])
    for vel_depth in (False, True):
        da = jku.generate_depth_map(str(tmp_path), str(velo), 2, vel_depth)
        db = tku.generate_depth_map(str(tmp_path), str(velo), 2, vel_depth)
        assert da.shape == (40, 120) and (da > 0).sum() > 50
        np.testing.assert_array_equal(da, db)


def test_validation_metrics_equal():
    rng = np.random.default_rng(2)
    assert tmetrics.METRIC_NAMES == jmetrics.METRIC_NAMES
    for h, w in ((375, 1242), (32, 100)):
        np.testing.assert_array_equal(tmetrics.garg_crop_mask(h, w), jmetrics.garg_crop_mask(h, w))
        gt = np.where(rng.random((h, w)) < 0.3, rng.uniform(0.5, 90, (h, w)), 0.0)
        gt = gt.astype(np.float32)
        pred = rng.uniform(0.05, 120, (h, w)).astype(np.float32)
        np.testing.assert_allclose(tmetrics.single_image_errors(pred, gt),
                                   jmetrics.single_image_errors(pred, gt), rtol=1e-6)
    g, p = rng.uniform(1, 80, 500), rng.uniform(1, 80, 500)
    np.testing.assert_allclose(tmetrics.compute_errors(g, p), jmetrics.compute_errors(g, p),
                               rtol=1e-6)


def test_utils_equal(tmp_path):
    for t in (0, 59, 3599, 10239, 360000):
        assert tmisc.sec_to_hm_str(t) == jmisc.sec_to_hm_str(t)
    assert tmisc.resolve_splits_dir("splits") == jmisc.resolve_splits_dir("splits")
    assert os.path.isdir(tmisc.resolve_splits_dir("splits"))
    assert tmisc.resolve_splits_dir(str(tmp_path)) == str(tmp_path)
    x = np.random.default_rng(1).random((6, 9)).astype(np.float32)
    np.testing.assert_array_equal(tmisc.colormap(x, "magma"), jmisc.colormap(x, "magma"))
    f = tmp_path / "lines.txt"
    f.write_text("a b\n\nc\n")
    assert tmisc.readlines(str(f)) == jmisc.readlines(str(f)) == ["a b", "c"]
