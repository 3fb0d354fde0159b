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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from baseboostdepth_tpu.config import Config as JaxConfig
from baseboostdepth_tpu.data import kitti as jkitti
from baseboostdepth_tpu import geometry as jgeometry
from baseboostdepth_tpu.evaluation import depth as jdepth
from baseboostdepth_tpu.evaluation import metrics as jmetrics
from baseboostdepth_tpu.evaluation import pose as jpose
from baseboostdepth_tpu.evaluation import syns as jsyns
from baseboostdepth_tpu.models.torch_import import (
    depth_decoder_torch_to_flax,
    pose_decoder_torch_to_flax,
    resnet_torch_to_flax,
)
from baseboostdepth_tpu.ops import chamfer as jchamfer
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu_torch import geometry
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.evaluation import depth, metrics, pose, syns
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.ops import chamfer
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state

H, W = 64, 128
FOLDER = "2011_09_26/2011_09_26_drive_0002_sync"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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


def test_disp_forward_matches_jax(nets):
    jax_state, state = nets
    x = np.random.default_rng(3).random((2, H, W, 3)).astype(np.float32)
    st = StepStatic(height=H, width=W, dtype="float32")
    ours = depth.make_disp_forward(st, device="cpu")(state.depth_net, x).numpy()
    ref = jdepth.make_disp_forward(JaxStepStatic(height=H, width=W, dtype="float32"))(
        *jax_state, jnp.asarray(x))
    assert ours.shape == (2, H, W)
    _rel(ours, ref, 1e-5, "scaled disparity")


def test_batch_post_process_equal():
    rng = np.random.default_rng(4)
    d, df = rng.random((2, 3, 2, 50)).astype(np.float32)
    np.testing.assert_array_equal(depth._batch_post_process(d, df),
                                  jdepth._batch_post_process(d, df))


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


def test_evaluators_need_the_card_by_default(nets):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        depth.make_disp_forward(StepStatic())
    with pytest.raises(RuntimeError, match="cuda"):
        chamfer.chamfer_nn_distances(np.zeros((2, 3)), np.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="cuda"):
        pose.make_pose_forward()
