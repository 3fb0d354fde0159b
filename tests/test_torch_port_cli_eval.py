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

Some of this file's tests are in test_torch_port_cli_eval_entry.py (export_gt, the infer parity, the
default device) and test_torch_port_colormap.py (display upsampling,
colormaps), so that each file has at most
seven tests: a file with more queues ahead of tests/test_zoo_training.py,
the suite's longest (ROADMAP.md, "The time budget").
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from baseboostdepth_tpu_torch.cli import evaluate_depth, evaluate_pose, export_gt, infer
from baseboostdepth_tpu_torch.cli import train as cli_train
from baseboostdepth_tpu_torch.cli import visualize
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state
from baseboostdepth_tpu_torch.training.trainer import Trainer
from torch_port_helpers import lowered_priority

FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


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


def test_evaluate_depth_cli_on_an_sql_checkpoint(trained, tmp_path):
    """The metric-depth path end to end: evaluate_depth on an SQLdepth
    checkpoint (128x512, the smallest size its head takes) saves metric
    depth at H/2, scores it without inverting it (disp_input=False), and
    --ext_disp_to_eval on the saved stack reproduces the live metrics."""
    from baseboostdepth_tpu_torch.evaluation.depth import load_gt, score_disparities

    root, config, _ = trained
    cfg = Config.load(config)
    cfg.model.zoo, cfg.data.height, cfg.data.width = "sql", 128, 512
    cfg.save(str(tmp_path / "sql.json"))
    st = StepStatic(zoo="sql", height=128, width=512, dtype="float32")
    CheckpointManager(str(tmp_path / "ckpt")).save(1, init_state(st, seed=4, device="cpu"), {})
    saved = str(tmp_path / "depths.npy")
    base = ["--config", str(tmp_path / "sql.json"), "--checkpoint", str(tmp_path / "ckpt")]
    live = evaluate_depth.main(base + ["--save_pred_disps", saved], device="cpu")
    depths = np.load(saved)
    assert depths.shape == (4, 64, 256) and (depths > 0).all()
    assert all(np.isfinite(v) for v in live.values())
    assert evaluate_depth.main(base + ["--ext_disp_to_eval", saved], device="cpu") == live
    gt = load_gt(str(root / "splits" / "eigen" / "gt_depths.npz"))
    assert score_disparities(depths, gt, False, disp_input=False) == live
    assert score_disparities(depths, gt, False, disp_input=True) != live


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
