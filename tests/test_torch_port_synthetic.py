"""Port parity: data/synthetic.py, the analytic scene renderer, against the
JAX package's, on the CPU. Renders (images, depth, poses) and the written
KITTI-raw and KITTI-odometry trees must be byte-equal for the same seed,
at small sizes (64x32 and 96x32; 18 and 4 frames). The .npz archives
carry their write time in their zip headers, so their arrays are compared
instead of their bytes; every other file byte for byte.

Single-worker time (one pytest process, Intel Xeon): about 15 s.
"""

import os

import numpy as np
import pytest

from baseboostdepth_tpu.data import synthetic as jax_synthetic
from baseboostdepth_tpu.data.kitti import intrinsics as jax_intrinsics
from baseboostdepth_tpu_torch.data import synthetic


@pytest.mark.parametrize("seed,frame,side", [(0, 0, "l"), (0, 9, "r"), (3, 25, "l")])
def test_render_is_byte_equal(seed, frame, side):
    K, _ = jax_intrinsics(96, 32)
    img, depth = synthetic.SyntheticScene(seed=seed).render(frame, side, K, 96, 32)
    jimg, jdepth = jax_synthetic.SyntheticScene(seed=seed).render(frame, side, K, 96, 32)
    assert img.dtype == np.uint8 and img.shape == (32, 96, 3)
    assert img.tobytes() == jimg.tobytes()
    assert depth.dtype == np.float32 and depth.tobytes() == jdepth.tobytes()
    scene, jscene = synthetic.SyntheticScene(seed=seed), jax_synthetic.SyntheticScene(seed=seed)
    assert scene.pose_0_to_f(frame + 2, frame).tobytes() == \
        jscene.pose_0_to_f(frame + 2, frame).tobytes()


def _tree(root):
    files = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            files[os.path.relpath(path, root)] = path
    return files


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert set(ta) == set(tb) and ta
    for rel, path in ta.items():
        if rel.endswith(".npz"):
            with np.load(path, allow_pickle=True) as x, np.load(tb[rel], allow_pickle=True) as y:
                assert set(x.files) == set(y.files)
                for k in x.files:
                    assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), rel
        else:
            with open(path, "rb") as f, open(tb[rel], "rb") as g:
                assert f.read() == g.read(), rel


def test_kitti_layout_is_byte_equal(tmp_path):
    out = synthetic.materialize_kitti_layout(str(tmp_path / "port"), n_frames=18, width=64,
                                             height=32, seed=1)
    ref = jax_synthetic.materialize_kitti_layout(str(tmp_path / "jax"), n_frames=18, width=64,
                                                 height=32, seed=1)
    assert out[1] == os.path.join(out[0], "splits") and ref[1] == os.path.join(ref[0], "splits")
    _assert_same_tree(out[0], ref[0])
    with open(os.path.join(out[1], "synth", "train_files_baselines.txt")) as f:
        assert len(f.readlines()) == 3  # frames 7-10 usable, the last held out


def test_odometry_layout_is_byte_equal(tmp_path):
    out = synthetic.materialize_odometry_layout(str(tmp_path / "port"), n_frames=4, width=64,
                                                height=32, seed=2)
    ref = jax_synthetic.materialize_odometry_layout(str(tmp_path / "jax"), n_frames=4,
                                                    width=64, height=32, seed=2)
    assert os.path.relpath(out[2], out[0]) == os.path.relpath(ref[2], ref[0])
    _assert_same_tree(out[0], ref[0])
