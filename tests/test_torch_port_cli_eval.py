"""The port's evaluation and inference entry points on the CPU: export_gt
against the JAX package's, evaluate_depth / evaluate_pose / infer /
visualize on a checkpoint that the port's cli.train writes, the display
upsampling against jax.image.resize, the colormap against matplotlib, and
the Trainer's SYNS validation.

Sizes: training and evaluation at 32x64 (64x128 for the infer parity),
float32, batch 4. Tolerances: export_gt, the colormap and
--ext_disp_to_eval against --save_pred_disps exactly (the same host code on
the same arrays); infer's disparity 1e-5 relative to JAX's forward (the
networks' convolutions summed in another order); the display upsampling
1e-5 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from baseboostdepth_tpu.cli import export_gt as jexport_gt
from baseboostdepth_tpu.evaluation import depth as jdepth
from baseboostdepth_tpu.models.torch_import import (
    depth_decoder_torch_to_flax,
    resnet_torch_to_flax,
)
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu_torch.cli import evaluate_depth, evaluate_pose, export_gt, infer
from baseboostdepth_tpu_torch.cli import train as cli_train
from baseboostdepth_tpu_torch.cli import visualize
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state
from baseboostdepth_tpu_torch.training.trainer import Trainer
from baseboostdepth_tpu_torch.utils import colormap

FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_syns(root, rng, n=3, size=(38, 116)):
    """SYNS images, depth maps, and test (all but the last) / val (the last)
    lists under root/syns and root/splits/SYNS."""
    h, w = size
    split = root / "splits" / "SYNS"
    split.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        folder = f"{i + 1:02d}"
        (root / "syns" / "images" / folder).mkdir(parents=True)
        (root / "syns" / "depths" / folder).mkdir(parents=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "syns" / "images" / folder / f"{i:02d}.png")
        depth = (np.linspace(1, 60, h)[:, None] * np.ones((1, w))
                 + rng.normal(0, 0.5, (h, w))).astype(np.float32)
        np.save(root / "syns" / "depths" / folder / f"{i:02d}.npy", depth)
        lines.append(f"{folder} {i:02d}")
    (split / "test_files.txt").write_text("\n".join(lines[:-1]) + "\n")
    (split / "val_files.txt").write_text(lines[-1] + "\n")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny KITTI tree (eigen_zhou training split, eigen test split with
    GT), a SYNS tree with exported GT, an odometry sequence, and cli.train
    run for one epoch of 2 steps with SYNS validation at every step."""
    root = tmp_path_factory.mktemp("port_cli_eval")
    rng = np.random.default_rng(0)
    for cam in (2, 3):
        d = root / "raw" / FOLDER / f"image_0{cam}" / "data"
        d.mkdir(parents=True)
        for i in range(16):
            base = rng.integers(40, 200, (8, 25, 3), dtype=np.uint8)
            Image.fromarray(base).resize((100, 32), Image.BILINEAR).save(d / f"{i:010d}.jpg")
    zhou = root / "splits" / "eigen_zhou"
    zhou.mkdir(parents=True)
    (zhou / "train_files_baselines.txt").write_text(
        "\n".join(f"{FOLDER} {i} l kt 0.05" for i in range(4, 12)) + "\n")
    eigen = root / "splits" / "eigen"
    eigen.mkdir(parents=True)
    (eigen / "test_files.txt").write_text("\n".join(f"{FOLDER} {i} l" for i in range(12, 16)) + "\n")
    yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 100), indexing="ij")
    gt = np.empty(4, dtype=object)
    for i in range(4):
        gt[i] = (4 + 30 * yy + 5 * np.sin(4 * xx) + i).astype(np.float32)
    np.savez_compressed(eigen / "gt_depths.npz", data=gt)

    _write_syns(root, rng)
    args = ["--split", "SYNS", "--syns_path", str(root / "syns"),
            "--splits_dir", str(root / "splits")]
    export_gt.main(args)
    export_gt.main(args + ["--val"])

    seq = root / "odom" / "sequences" / "09" / "image_2"
    seq.mkdir(parents=True)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (32, 100, 3), dtype=np.uint8)).save(
            seq / f"{i:06d}.png")
    (root / "splits" / "odom").mkdir()
    (root / "splits" / "odom" / "test_files_09.txt").write_text(
        "\n".join(f"09 {i} l" for i in range(6)) + "\n")
    np.savetxt(root / "poses09.txt",
               np.array([np.c_[np.eye(3), [0.0, 0.0, float(i)]].reshape(-1) for i in range(6)]))

    argv = ["--data.kt_path", str(root / "raw"), "--data.splits_dir", str(root / "splits"),
            "--data.syns_path", str(root / "syns"), "--data.height", "32",
            "--data.width", "64", "--data.num_workers", "2", "--model.dtype", "float32",
            "--optim.batch_size", "4", "--optim.num_epochs", "1",
            "--log.log_dir", str(root / "logs"), "--log.model_name", "m",
            "--log.log_frequency", "1", "--log.syns_val", "True"]
    tr = cli_train.main(argv, device="cpu")
    assert tr.state.step == 2
    log = root / "logs" / "m"
    return root, str(log / "config.json"), str(log / "checkpoints")


def test_trainer_syns_val_logs_syns_metrics(trained):
    """log.syns_val (refused before the eval slice) runs the SYNS val split
    at every log step and logs syns/<metric>."""
    root, _, _ = trained
    lines = [json.loads(ln) for ln in open(root / "logs" / "m" / "metrics.jsonl")]
    syns_lines = [m for m in lines if any(k.startswith("syns/") for k in m)]
    assert len(syns_lines) == 1 and syns_lines[0]["step"] == 2
    keys = {k for k in syns_lines[0] if k.startswith("syns/")}
    assert keys == {f"syns/{k}" for k in ("abs_rel", "err", "sq_rel", "rmse", "rmse_log",
                                          "edge_acc", "edge_comp")}
    assert all(np.isfinite(syns_lines[0][k]) for k in keys)
    assert os.listdir(root / "logs" / "m" / "panels")  # image panels on by default


def test_trainer_syns_val_skips_missing_assets(trained, tmp_path, capsys):
    root, config, _ = trained
    cfg = Config.load(config)
    cfg.data.syns_path = str(tmp_path / "nowhere")
    cfg.log.log_dir, cfg.log.model_name = str(tmp_path), "skip"
    tr = Trainer(cfg, device="cpu")
    tr.validate_syns(0)
    assert "[syns-val] skipped" in capsys.readouterr().out
    tr.logger.close()
    assert not any("syns/" in ln for ln in open(tmp_path / "skip" / "metrics.jsonl"))


def test_export_gt_syns_matches_jax(tmp_path):
    for pkg, main in (("port", export_gt.main), ("jax", jexport_gt.main)):
        _write_syns(tmp_path / pkg, np.random.default_rng(3))
        args = ["--split", "SYNS", "--syns_path", str(tmp_path / pkg / "syns"),
                "--splits_dir", str(tmp_path / pkg / "splits")]
        main(args)
        main(args + ["--val"])
    for name in ("gt_depths", "gt_edges", "gt_depths_val", "gt_edges_val"):
        ours = np.load(tmp_path / "port" / "splits" / "SYNS" / f"{name}.npz", allow_pickle=True)
        ref = np.load(tmp_path / "jax" / "splits" / "SYNS" / f"{name}.npz", allow_pickle=True)
        assert len(ours["data"]) == len(ref["data"]) == (1 if name.endswith("_val") else 2)
        for a, b in zip(ours["data"], ref["data"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("protocol", [[], ["--stereo"]], ids=["mono", "stereo"])
def test_evaluate_depth_cli_and_saved_disparities(trained, tmp_path, protocol):
    """evaluate_depth on cli.train's checkpoint; scoring the saved stack with
    --ext_disp_to_eval reproduces the live metrics exactly."""
    _, config, ckpt = trained
    saved = str(tmp_path / "disps.npy")
    base = ["--config", config, "--checkpoint", ckpt, *protocol]
    live = evaluate_depth.main(base + ["--save_pred_disps", saved], device="cpu")
    assert np.load(saved).shape == (4, 32, 64)
    assert all(np.isfinite(v) for v in live.values())
    assert ("median_ratio" in live) == (not protocol)
    assert evaluate_depth.main(base + ["--ext_disp_to_eval", saved], device="cpu") == live
    pp = evaluate_depth.main(base + ["--post_process"], device="cpu")
    assert pp.keys() == live.keys() and all(np.isfinite(v) for v in pp.values())


def test_evaluate_depth_cli_syns_and_pose_cli(trained, tmp_path):
    root, config, ckpt = trained
    syns = evaluate_depth.main(["--config", config, "--checkpoint", ckpt, "--split", "SYNS",
                                "--chamfer"], device="cpu")
    assert {"abs_rel", "edge_acc", "edge_comp", "f1", "iou"} <= syns.keys()
    assert all(np.isfinite(v) for v in syns.values())

    cfg = Config.load(config)
    cfg.data.kt_path = str(root / "odom")
    cfg.save(str(tmp_path / "odom.json"))
    ates = evaluate_pose.main(["--config", str(tmp_path / "odom.json"), "--checkpoint", ckpt,
                               "--sequence", "9", "--gt_poses", str(root / "poses09.txt")],
                              device="cpu")
    assert set(ates) == {"ate_direct", "ate_direct_std", "ate_chained", "ate_chained_std"}
    assert all(np.isfinite(v) for v in ates.values())


def test_infer_and_visualize_cli(trained, tmp_path):
    root, config, ckpt = trained
    frames = root / "raw" / FOLDER / "image_02" / "data"
    written = infer.main(["--config", config, "--checkpoint", ckpt, "--image_path", str(frames),
                          "--out_dir", str(tmp_path / "infer")], device="cpu")
    assert len(written) == 2 * 16
    assert all(os.path.getsize(p) > 0 for p in written)
    assert np.load(written[0]).shape == (32, 64)
    assert Image.open(written[1]).size == (100, 32)

    gt = np.empty(16, dtype=object)
    for i in range(16):
        gt[i] = np.full((32, 100), 10.0 + i, np.float32)
    np.savez_compressed(tmp_path / "gt.npz", data=gt)
    out = visualize.main(["--image_dir", str(frames), "--out", str(tmp_path / "v.avi"),
                          "--model", f"{config}:{ckpt}", "--model", f"{config}:{ckpt}",
                          "--gt_npz", str(tmp_path / "gt.npz")], device="cpu")
    assert os.path.getsize(out) > 0


def test_infer_matches_jax_disp_forward(tmp_path):
    """infer's saved disparity against JAX's make_disp_forward on the same
    image (decoded and LANCZOS-resized as infer does) and weights."""
    cfg = Config()
    cfg.data.height, cfg.data.width = 64, 128
    cfg.model.dtype = "float32"
    cfg.save(str(tmp_path / "cfg.json"))
    state = init_state(StepStatic(height=64, width=128, dtype="float32"), seed=4, device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(1, state)
    img = np.random.default_rng(8).integers(0, 255, (90, 300, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "frame.jpg")
    infer.main(["--config", str(tmp_path / "cfg.json"), "--checkpoint", str(tmp_path / "ckpt"),
                "--image_path", str(tmp_path / "frame.jpg")], device="cpu")
    ours = np.load(tmp_path / "frame_disp.npy")

    d = {k: v.numpy() for k, v in state.depth_net.state_dict().items()}
    enc_p, enc_s = resnet_torch_to_flax(d, prefix="encoder.encoder.")
    dec = depth_decoder_torch_to_flax({k[len("decoder."):]: v for k, v in d.items()
                                       if k.startswith("decoder.")})
    params = {"depth": {"encoder": enc_p, "decoder": dec}}
    stats = {"depth": {"encoder": enc_s}}
    with Image.open(tmp_path / "frame.jpg") as im:
        x = np.asarray(im.convert("RGB").resize((128, 64), Image.LANCZOS), np.float32) / 255.0
    fwd = jdepth.make_disp_forward(JaxStepStatic(height=64, width=128, dtype="float32"))
    ref = np.asarray(fwd(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                         jnp.asarray(x[None])))[0]
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert os.path.getsize(tmp_path / "frame_disp.jpeg") > 0


@pytest.mark.parametrize("size", [(375, 1242), (20, 50), (100, 60)], ids=["up", "down", "mixed"])
def test_display_upsampling_matches_jax_resize(size):
    disp = np.random.default_rng(9).random((64, 128)).astype(np.float32)
    ours = infer.upsample_for_display(torch.from_numpy(disp), *size).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(disp), size, method="linear"))
    assert ours.shape == size
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("cmap", ["plasma", "magma"])
def test_colormap_matches_matplotlib(cmap):
    rng = np.random.default_rng(10)
    edge = [0.0, 1.0, 1 - 1e-7, -1e-7, -0.5, 1.5, np.nan, np.inf, -np.inf, 1 / 256, 255 / 256]
    for dtype in (np.float32, np.float64):
        x = np.concatenate([rng.random(989), edge]).astype(dtype).reshape(25, 40)
        ref = matplotlib.colormaps[cmap](x)[..., :3]
        np.testing.assert_array_equal(colormap(x, cmap, normalize=False), ref)
    y = rng.normal(size=(7, 9)).astype(np.float32)
    lo, hi = float(y.min()), float(y.max())
    np.testing.assert_array_equal(colormap(y, cmap),
                                  matplotlib.colormaps[cmap]((y - lo) / (hi - lo))[..., :3])
    with pytest.raises(ValueError):
        colormap(y, "viridis")


def test_entry_points_default_to_the_card(trained):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, config, ckpt = trained
    for main in (evaluate_depth.main, evaluate_pose.main, infer.main, visualize.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--config", config, "--checkpoint", ckpt])
