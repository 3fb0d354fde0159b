"""The port's evaluation library against the JAX package's, on the CPU: the
odometry index, backproject/project, the metric protocol, the disparity
forward, flip post-processing, KITTI, SYNS (with chamfer) and odometry
evaluation, on the same weights (JAX's trees, loaded into the port by
models/convert.py::from_jax) and the fixtures of tests/test_eval_e2e.py, at
64x128, float32.

Tolerances: host numpy copied line for line (metric protocol, post
processing, SYNS helpers) exactly; backproject/project 1e-6 (the same
float32 expressions, summed in another order); the forward 1e-5 relative
(the networks' convolutions summed in another order); metrics 1e-4
relative, except SYNS's point-cloud F-score and IoU, which count points
whose nearest-neighbour distance is below 0.1 m: a disparity ~1e-6 apart
moves a point by up to 6e-5 m and can carry it across the threshold, so they
are held to two such crossings, 5e-4 absolute (ROADMAP.md, C); chamfer
distances 1e-4 absolute; ATEs 1e-5.

Some of this file's tests are in test_torch_port_eval_metrics.py (the pieces that need no network) and
test_torch_port_eval_syns.py (SYNS helpers, chamfer, the default device), so that each file has at most
seven tests: a file with more queues ahead of tests/test_zoo_training.py,
the suite's longest (ROADMAP.md, "The time budget").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from baseboostdepth_tpu.config import Config as JaxConfig
from baseboostdepth_tpu.evaluation import depth as jdepth
from baseboostdepth_tpu.evaluation import pose as jpose
from baseboostdepth_tpu.evaluation import syns as jsyns
from baseboostdepth_tpu.models.torch_import import (
    depth_decoder_torch_to_flax,
    pose_decoder_torch_to_flax,
    resnet_torch_to_flax,
)
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.evaluation import depth, pose, syns
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state
from torch_port_helpers import lowered_priority

H, W = 64, 128
FOLDER = "2011_09_26/2011_09_26_drive_0002_sync"


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


def _rel(a, b, rtol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-12),
                               err_msg=what)


def _metrics_close(ours: dict, ref: dict, rtol=1e-4, atol=None):
    """Every metric to rtol; those named in `atol` to that absolute error."""
    assert ours.keys() == ref.keys()
    for k in ref:
        if atol and k in atol:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=atol[k], err_msg=k)
        else:
            _rel(ours[k], ref[k], rtol, k)


def to_flax(depth_sd, pose_sd):
    """The port's state_dicts -> the JAX package's (params, batch_stats)
    trees through its own importers of reference torch checkpoints (as in
    tests/test_torch_port_models.py)."""
    d = {k: v.detach().numpy() for k, v in depth_sd.items()}
    p = {k: v.detach().numpy() for k, v in pose_sd.items()}

    def sub(sd, prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    de_p, de_s = resnet_torch_to_flax(d, prefix="encoder.encoder.")
    pe_p, pe_s = resnet_torch_to_flax(p, prefix="encoder.encoder.")
    params = {
        "depth": {"encoder": de_p, "decoder": depth_decoder_torch_to_flax(sub(d, "decoder."))},
        "pose": {"encoder": pe_p, "decoder": pose_decoder_torch_to_flax(sub(p, "decoder."))},
    }
    return params, {"depth": {"encoder": de_s}, "pose": {"encoder": pe_s}}


@pytest.fixture(scope="module")
def nets():
    """(JAX (params, stats), the port's TrainState holding from_jax of them).

    The weights start as the port's init from seed 0 with moved BatchNorm
    statistics, go to JAX through its importers, and come back through
    from_jax (JAX's own init compiles for half a minute on the CPU)."""
    state = init_state(StepStatic(height=H, width=W, dtype="float32"), device="cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, b in [*state.depth_net.named_buffers(), *state.pose_net.named_buffers()]:
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    params, stats = to_flax(state.depth_net.state_dict(), state.pose_net.state_dict())
    depth_sd, pose_sd = from_jax(params, stats)
    state.depth_net.load_state_dict(depth_sd)
    state.pose_net.load_state_dict(pose_sd)
    jax_tree = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
    return jax_tree, state


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """KITTI eigen, SYNS (test + val, GT and edges) and odometry trees, as
    tests/test_eval_e2e.py builds them."""
    root = tmp_path_factory.mktemp("port_eval")
    rng = np.random.default_rng(0)
    d = root / "kitti" / FOLDER / "image_02" / "data"
    d.mkdir(parents=True)
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (40, 120, 3), dtype=np.uint8)).save(
            d / f"{i:010d}.jpg")
    eigen = root / "splits" / "eigen"
    eigen.mkdir(parents=True)
    (eigen / "test_files.txt").write_text("\n".join(f"{FOLDER} {i} l" for i in range(5)) + "\n")
    yy, xx = np.meshgrid(np.linspace(0, 1, 40), np.linspace(0, 1, 120), indexing="ij")
    gt = np.empty(5, dtype=object)
    for i in range(5):
        gt[i] = (4 + 30 * yy + 5 * np.sin(4 * xx) + i).astype(np.float32)
    np.savez_compressed(eigen / "gt_depths.npz", data=gt)

    synsd = root / "splits" / "SYNS"
    synsd.mkdir(parents=True)
    lines, gt_d, gt_e = [], [], []
    for i in range(3):
        folder = f"{i + 1:02d}"
        (root / "syns" / "images" / folder).mkdir(parents=True)
        Image.fromarray(rng.integers(0, 255, (38, 116, 3), dtype=np.uint8)).save(
            root / "syns" / "images" / folder / f"{i:02d}.png")
        lines.append(f"{folder} {i:02d}")
        gt_d.append((np.linspace(1, 60, 38)[:, None] * np.ones((1, 116))).astype(np.float32))
        edges = np.zeros((38, 116, 1), dtype=bool)
        edges[::7] = True
        gt_e.append(edges)
    (synsd / "test_files.txt").write_text("\n".join(lines[:2]) + "\n")
    (synsd / "val_files.txt").write_text(lines[2] + "\n")
    for suffix, sl in (("", slice(0, 2)), ("_val", slice(2, 3))):
        np.savez_compressed(synsd / f"gt_depths{suffix}.npz", data=np.array(gt_d[sl], dtype=object))
        np.savez_compressed(synsd / f"gt_edges{suffix}.npz", data=np.array(gt_e[sl], dtype=object))

    seq = root / "odom" / "sequences" / "09" / "image_2"
    seq.mkdir(parents=True)
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (40, 120, 3), dtype=np.uint8)).save(
            seq / f"{i:06d}.png")
    odom = root / "splits" / "odom"
    odom.mkdir(parents=True)
    (odom / "test_files_09.txt").write_text("\n".join(f"09 {i} l" for i in range(8)) + "\n")
    poses = []
    for i in range(8):
        T = np.eye(4)
        T[2, 3] = i * 1.0
        T[0, 3] = 0.1 * i * i
        poses.append(T[:3].reshape(-1))
    np.savetxt(root / "poses09.txt", np.array(poses))
    return root


def _cfgs(root, kt="kitti"):
    cfg = Config()
    cfg.data.kt_path = str(root / kt)
    cfg.data.splits_dir = str(root / "splits")
    cfg.data.syns_path = str(root / "syns")
    cfg.data.height, cfg.data.width = H, W
    cfg.model.dtype = "float32"
    return cfg, JaxConfig.from_dict(cfg.to_dict())


def test_disp_forward_matches_jax(nets):
    jax_state, state = nets
    x = np.random.default_rng(3).random((2, H, W, 3)).astype(np.float32)
    st = StepStatic(height=H, width=W, dtype="float32")
    ours = depth.make_disp_forward(st, device="cpu")(state.depth_net, x).numpy()
    ref = jdepth.make_disp_forward(JaxStepStatic(height=H, width=W, dtype="float32"))(
        *jax_state, jnp.asarray(x))
    assert ours.shape == (2, H, W)
    _rel(ours, ref, 1e-5, "scaled disparity")


@pytest.mark.parametrize("mode", ["mono", "stereo", "post_process"])
def test_evaluate_kitti_matches_jax(nets, trees, tmp_path, mode):
    jax_state, state = nets
    cfg, jcfg = _cfgs(trees)
    kw = dict(stereo=mode == "stereo", post_process=mode == "post_process")
    out = str(tmp_path / "disps.npy")
    ours = depth.evaluate_kitti(cfg, state.depth_net, save_pred_disps=out, device="cpu", **kw)
    ref = jdepth.evaluate_kitti(jcfg, *jax_state, **kw)
    assert np.load(out).shape == (5, H, W)
    assert ("median_ratio" in ours) == (mode != "stereo")
    _metrics_close(ours, ref)


@pytest.mark.parametrize("file_name", ["test_files.txt", "val_files.txt"])
def test_evaluate_syns_matches_jax(nets, trees, file_name):
    jax_state, state = nets
    cfg, jcfg = _cfgs(trees)
    chamfer_on = file_name == "test_files.txt"
    ours = syns.evaluate_syns(cfg, state.depth_net, chamfer=chamfer_on, file_name=file_name,
                              device="cpu")
    ref = jsyns.evaluate_syns(jcfg, *jax_state, chamfer=chamfer_on,
                              file_name=file_name)
    assert ("f1" in ours) == chamfer_on
    # one point across the 0.1 m threshold moves the mean F-score over two
    # images of 38x116 points by at most 2 / (2 * 4408)
    _metrics_close(ours, ref, atol={"f1": 5e-4, "iou": 5e-4})


def test_evaluate_odometry_matches_jax(nets, trees):
    jax_state, state = nets
    cfg, jcfg = _cfgs(trees, kt="odom")
    gt = str(trees / "poses09.txt")
    ours = pose.evaluate_odometry(cfg, state.pose_net, 9, gt, batch_size=4, device="cpu")
    ref = jpose.evaluate_odometry(jcfg, *jax_state, 9, gt, batch_size=4)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # the SfMLearner helpers are copied numpy
    rng = np.random.default_rng(6)
    Ts = [np.linalg.qr(rng.normal(size=(4, 4)))[0] for _ in range(3)]
    np.testing.assert_array_equal(pose.dump_xyz(Ts), jpose.dump_xyz(Ts))
    a, b = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    assert pose.compute_ate(a, b) == jpose.compute_ate(a, b)
