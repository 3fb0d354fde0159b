"""Port parity: the SYNS and odometry helpers and the chamfer search against
the JAX package on the CPU, and the evaluators' default device. The setup
and tolerances are test_torch_port_eval.py's, split from it so that each
file has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~15 s.
"""

import numpy as np
import pytest
import torch

from baseboostdepth_tpu.evaluation import syns as jsyns
from baseboostdepth_tpu.ops import chamfer as jchamfer
from baseboostdepth_tpu_torch.evaluation import depth, pose, syns
from baseboostdepth_tpu_torch.ops import chamfer
from baseboostdepth_tpu_torch.training.step import StepStatic
from test_torch_port_eval import nets  # noqa: F401 (fixtures)
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


def test_syns_helpers_equal():
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(syns.syns_intrinsics(), jsyns.syns_intrinsics())
    d = rng.uniform(0.5, 100, (38, 116)).astype(np.float32)
    d[3, :9] = 0
    np.testing.assert_array_equal(syns.to_log_depth(d), jsyns.to_log_depth(d))
    pe = syns.predicted_edges(d)
    np.testing.assert_array_equal(pe, jsyns.predicted_edges(d))
    ge, mask = rng.random((38, 116)) < 0.1, rng.random((38, 116)) < 0.9
    assert syns.edge_metrics(ge, pe, mask) == jsyns.edge_metrics(ge, pe, mask)
    inv_K3 = np.linalg.pinv(syns.syns_intrinsics())
    np.testing.assert_array_equal(syns.backproject_points(d, inv_K3, mask),
                                  jsyns.backproject_points(d, inv_K3, mask))


def test_chamfer_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.normal(size=(3000, 3)).astype(np.float32) * 20 + 40
    q = np.concatenate([p[:2000] + rng.normal(0, 0.05, (2000, 3)),
                        rng.normal(size=(2500, 3)) * 22 + 40]).astype(np.float32)
    ours = chamfer.chamfer_nn_distances(p, q, device="cpu")
    ref = jchamfer.chamfer_nn_distances(p, q)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for th in (0.1, 0.5, 1e-9):
        assert chamfer.pointcloud_f_iou(*ours, th=th) == jchamfer.pointcloud_f_iou(*ref, th=th)


def test_evaluators_need_the_card_by_default(nets):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        depth.make_disp_forward(StepStatic())
    with pytest.raises(RuntimeError, match="cuda"):
        chamfer.chamfer_nn_distances(np.zeros((2, 3)), np.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="cuda"):
        pose.make_pose_forward()
