"""Port parity of the evaluation library's pieces that need no network:
the odometry index paths, back-projection and projection, the disparity
evaluation of each protocol and the batch post-process, against the JAX
package on the CPU. The setup and tolerances are test_torch_port_eval.py's,
split from it so that each file has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~10 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu import geometry as jgeometry
from baseboostdepth_tpu.data import kitti as jkitti
from baseboostdepth_tpu.evaluation import depth as jdepth
from baseboostdepth_tpu.evaluation import metrics as jmetrics
from baseboostdepth_tpu_torch import geometry
from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.evaluation import depth, metrics
from test_torch_port_eval import _rel
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


def test_kitti_odom_index_paths(tmp_path):
    split = tmp_path / "test_files_09.txt"
    split.write_text("09 0 l\n9 17 r\n10 4540\n")
    ours = kitti.KittiOdomIndex("/data/odom", str(split))
    ref = jkitti.KittiOdomIndex("/data/odom", str(split))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours.samples, ref.samples):
        assert (a.folder, a.frame_index, a.side) == (b.folder, b.frame_index, b.side)
        assert ours.image_path(a.folder, a.frame_index, a.side) == \
            ref.image_path(b.folder, b.frame_index, b.side)
        assert ours.image_path(a.folder, a.frame_index) == ref.image_path(b.folder, b.frame_index)


def test_backproject_and_project_match_jax():
    rng = np.random.default_rng(1)
    B, h, w = 2, 6, 10
    depth_np = rng.uniform(1, 80, (B, h, w)).astype(np.float32)
    K = np.tile(kitti.intrinsics(w, h)[0], (B, 1, 1))
    inv_K = np.linalg.inv(K).astype(np.float32)
    T = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    T[:, :3, 3] = rng.normal(0, 0.3, (B, 3))
    T[1, :3, :3] = np.asarray(jgeometry.rot_from_axisangle(jnp.asarray([0.02, -0.05, 0.01])))
    pts = geometry.backproject_depth(torch.from_numpy(depth_np), torch.from_numpy(inv_K))
    jpts = jgeometry.backproject_depth(jnp.asarray(depth_np), jnp.asarray(inv_K))
    _rel(pts.numpy(), jpts, 1e-6, "backproject")
    grid = geometry.project_3d(pts, torch.from_numpy(K), torch.from_numpy(T), h, w)
    jgrid = jgeometry.project_3d(jpts, jnp.asarray(K), jnp.asarray(T), h, w)
    assert grid.shape == (B, h, w, 2)
    _rel(grid.numpy(), jgrid, 1e-6, "project")


@pytest.mark.parametrize("protocol", ["mono", "stereo", "syns_range", "metric"])
def test_evaluate_disparities_equal(protocol):
    rng = np.random.default_rng(2)
    disps = rng.uniform(0.02, 0.5, (3, 24, 80)).astype(np.float32)
    gts = [np.where(rng.random((50, 160)) < 0.4, rng.uniform(0.5, 120, (50, 160)), 0.0)
           .astype(np.float32) for _ in range(3)]
    made = []
    for M in (metrics, jmetrics):
        p = M.EvalProtocol.stereo() if protocol == "stereo" else M.EvalProtocol.mono()
        if protocol == "syns_range":
            p.garg_crop, p.max_depth = False, M.SYNS_MAX_DEPTH
        if protocol == "metric":
            p.disp_input = False
        made.append(M.evaluate_disparities(disps * (100 if protocol == "metric" else 1), gts, p))
    for a, b in zip(*made):
        np.testing.assert_array_equal(a, b)
    assert metrics.STEREO_SCALE_FACTOR == jmetrics.STEREO_SCALE_FACTOR
    assert metrics.SYNS_MAX_DEPTH == jmetrics.SYNS_MAX_DEPTH


def test_batch_post_process_equal():
    rng = np.random.default_rng(4)
    d, df = rng.random((2, 3, 2, 50)).astype(np.float32)
    np.testing.assert_array_equal(depth._batch_post_process(d, df),
                                  jdepth._batch_post_process(d, df))
