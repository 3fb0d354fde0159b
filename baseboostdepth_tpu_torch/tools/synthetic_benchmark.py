"""Accuracy benchmark on the analytic synthetic scene, the counterpart of
the JAX package's `tools/synthetic_benchmark.py`.

Trains the full BaseBoostDepth method (both curriculum stages) on a
procedurally generated, exactly multi-view-consistent driving scene
(data/synthetic.py) through the real pipeline -- KittiRawIndex, the
curriculum loader, the Trainer -- then scores abs_rel / a1 against the
scene's analytic ground-truth depth (median scaling, Garg crop).

    python -m baseboostdepth_tpu_torch.tools.synthetic_benchmark [--zoo Z]
        [--disp-bias -2.2] [--seed S] [--dtype float32]

The scene is rendered once under --root (in a process per CPU core) and
reused through its `.done_*` marker. The result lands in
logs/synth_bench_<dtype><suffix>/result.json with the JAX tool's keys;
`wall_s` is this run's time from the Trainer's construction to the final
score, `device` the card's name and power limit, and `epoch_s` /
`epoch_steps` each epoch's wall clock (loader and checkpoint included) and
steps. Runs on the GPU; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
from baseboostdepth_tpu_torch.data.loader import EvalLoader
from baseboostdepth_tpu_torch.data.synthetic import SyntheticScene, materialize_kitti_layout
from baseboostdepth_tpu_torch.device import describe, require_device
from baseboostdepth_tpu_torch.evaluation.metrics import METRIC_NAMES, single_image_errors
from baseboostdepth_tpu_torch.training.step import make_eval_forward
from baseboostdepth_tpu_torch.training.trainer import Trainer


def ensure_scene(root: str, n_frames: int, width: int, height: int, seed: int,
                 workers: int | None = None):
    """Render (or reuse) the scene in KITTI layout under root, the frames in
    `workers` processes (default: one per usable CPU core)."""
    marker = os.path.join(root, f".done_{n_frames}_{width}x{height}_{seed}")
    if not os.path.exists(marker):
        t0 = time.time()
        materialize_kitti_layout(
            root, n_frames=n_frames, width=width, height=height, seed=seed,
            scene=SyntheticScene(seed=seed),
            workers=workers or len(os.sched_getaffinity(0)),
        )
        open(marker, "w").close()
        print(f"rendered {n_frames} frames x2 cams in {time.time() - t0:.0f}s")
    return root, os.path.join(root, "splits")


def evaluate(cfg: Config, state, st, device="cuda") -> dict:
    """abs_rel / a1 & friends of `state`'s depth network on the synthetic val
    split (the online-val protocol: median scaling + Garg crop, which here
    keeps the lower image band where ground / billboard parallax lives)."""
    import cv2

    split = os.path.join(cfg.data.splits_dir, cfg.data.split)
    val_index = kitti.KittiRawIndex(cfg.data.kt_path, os.path.join(split, "val_files.txt"))
    paths = [val_index.image_path(s.folder, s.frame_index, s.side) for s in val_index.samples]
    gt = np.load(os.path.join(split, "gt_depths.npz"))["data"]
    fwd = make_eval_forward(st, device)
    totals = np.zeros(len(METRIC_NAMES))
    n = 0
    for imgs, start, cnt in EvalLoader(paths, cfg.data.height, cfg.data.width, batch_size=8):
        depth = fwd(state.depth_net, imgs.astype(np.float32) / 255.0).cpu().numpy()
        for j in range(cnt):
            g = gt[start + j]
            pred = cv2.resize(depth[j], (g.shape[1], g.shape[0]))
            totals += np.array(single_image_errors(pred, g))
            n += 1
    return dict(zip(METRIC_NAMES, (totals / max(n, 1)).tolist()))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--zoo", default="md2", choices=["md2", "monovit", "sql", "cadepth", "diffnet"],
                    help="depth-network zoo (convergence evidence per zoo)")
    ap.add_argument("--root", default="logs/synth_scene")
    ap.add_argument("--n-frames", type=int, default=420)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--switch-epoch", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--disp-bias", type=float, default=None,
                    help="cold-start disparity-head bias (method.disp_init_bias)")
    ap.add_argument("--pose-scale", type=float, default=1.0,
                    help="model.pose_input_scale (perf mode; quantify here)")
    ap.add_argument("--no-bucket", action="store_true",
                    help="disable f_max bucketing (data.bucket_fs=()); A/B "
                    "the default-on bucketed loader's accuracy impact")
    return ap.parse_args(argv)


def scene_root(args: argparse.Namespace) -> str:
    return args.root if args.seed == 0 else f"{args.root}_seed{args.seed}"


def make_config(args: argparse.Namespace) -> Config:
    """The Config the benchmark trains: the default method on the scene's
    `synth` split, the 20-epoch LR milestones scaled to --epochs."""
    cfg = Config()
    cfg.model.zoo = args.zoo
    cfg.model.dtype = args.dtype
    cfg.data.kt_path = scene_root(args)
    cfg.data.splits_dir = os.path.join(scene_root(args), "splits")
    cfg.data.split = "synth"
    cfg.data.height, cfg.data.width = args.height, args.width
    cfg.optim.batch_size = args.batch_size
    cfg.optim.num_epochs = args.epochs
    # compress the 20-epoch schedule: milestones scale with the epoch count
    scale = args.epochs / 20.0
    cfg.optim.lr_milestones = tuple(
        sorted({max(1, round(m * scale)) for m in cfg.optim.lr_milestones})
    )
    cfg.method.curriculum_switch_epoch = args.switch_epoch
    cfg.method.disp_init_bias = args.disp_bias
    cfg.model.pose_input_scale = args.pose_scale
    if args.no_bucket:
        cfg.data.bucket_fs = ()
    suffix = "" if args.zoo == "md2" else f"_{args.zoo}"
    suffix += "" if args.disp_bias is None else f"_bias{args.disp_bias}"
    if args.pose_scale != 1.0:
        suffix += f"_ps{args.pose_scale}"
    if args.no_bucket:
        suffix += "_nobucket"
    if args.seed != 0:
        suffix += f"_seed{args.seed}"
    cfg.log.model_name = f"synth_bench_{args.dtype}{suffix}"
    cfg.log.log_frequency = 10**9  # no online val; we evaluate at the end
    cfg.seed = args.seed
    return cfg


class EpochTimedTrainer(Trainer):
    """The Trainer, with each epoch's wall clock and steps recorded in
    `epochs`."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__(cfg, device)
        self.epochs = []

    def _train_epoch(self, epoch, t0, stop_requested):
        t, step = time.perf_counter(), self.state.step
        going_on = super()._train_epoch(epoch, t0, stop_requested)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.epochs.append((time.perf_counter() - t, self.state.step - step))
        return going_on


def main(argv=None, device="cuda") -> dict:
    device = require_device(device)
    card = describe(device)
    args = parse_args(argv)
    cfg = make_config(args)
    ensure_scene(scene_root(args), args.n_frames, args.width, args.height, args.seed)

    t0 = time.time()
    tr = EpochTimedTrainer(cfg, device)
    st0 = tr._static_for_stage(stage_for_epoch(0, cfg.method.trimin))
    init_metrics = evaluate(cfg, tr.state, st0, device)
    print("init:", {k: round(v, 4) for k, v in init_metrics.items()})
    tr.train()
    st = tr._static_for_stage(
        stage_for_epoch(args.epochs - 1, cfg.method.trimin, args.switch_epoch)
    )
    final_metrics = evaluate(cfg, tr.state, st, device)
    wall = time.time() - t0
    print("final:", {k: round(v, 4) for k, v in final_metrics.items()})

    out = {
        "dtype": args.dtype,
        "zoo": args.zoo,
        "disp_bias": args.disp_bias,
        "pose_input_scale": args.pose_scale,
        "bucket_fs": list(cfg.data.bucket_fs),
        "epochs": args.epochs,
        "n_frames": args.n_frames,
        "resolution": [args.height, args.width],
        "wall_s": round(wall, 1),
        "device": card,
        "seed": args.seed,
        "epoch_s": [round(s, 2) for s, _ in tr.epochs],
        "epoch_steps": [n for _, n in tr.epochs],
        "init": init_metrics,
        "final": final_metrics,
    }
    path = os.path.join(tr.log_path, "result.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
