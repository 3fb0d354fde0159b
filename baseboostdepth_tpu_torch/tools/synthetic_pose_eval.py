"""Pose accuracy on the synthetic scene, the counterpart of the JAX
package's `tools/synthetic_pose_eval.py`: the real odometry evaluator
(evaluation/pose.py) over a synthetic-scene sequence with exact GT poses,
with a checkpoint that tools/synthetic_benchmark.py trained.

    python -m baseboostdepth_tpu_torch.tools.synthetic_pose_eval \\
        --ckpt logs/synth_bench_bfloat16/checkpoints
    python -m baseboostdepth_tpu_torch.tools.synthetic_pose_eval --untrained

Reports the SfMLearner-protocol ATE of the direct 2-frame pose and of the
chained (step-composed) pose, the two estimates the reference's
evaluate_pose.py compares. Runs on the GPU; `main(argv, device="cpu")`
runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.data.synthetic import SyntheticScene, materialize_odometry_layout
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.depth import eval_static
from baseboostdepth_tpu_torch.evaluation.pose import evaluate_odometry
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import init_state


def main(argv=None, device="cuda") -> dict:
    device = require_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="logs/synth_bench_bfloat16/checkpoints")
    ap.add_argument("--root", default="logs/synth_odom")
    ap.add_argument("--n-frames", type=int, default=80)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--untrained", action="store_true",
                    help="baseline: freshly initialized pose net")
    args = ap.parse_args(argv)

    marker = os.path.join(args.root, f".done_{args.n_frames}_{args.width}x{args.height}")
    if not os.path.exists(marker):
        materialize_odometry_layout(
            args.root, n_frames=args.n_frames, width=args.width,
            height=args.height, scene=SyntheticScene(seed=0),
        )
        open(marker, "w").close()
    gt_path = os.path.join(args.root, "poses", "09.txt")

    cfg = Config()
    cfg.data.kt_path = args.root
    cfg.data.splits_dir = os.path.join(args.root, "splits")
    cfg.data.height, cfg.data.width = args.height, args.width

    # md2's networks at the sequence's size, from seed 0
    state = init_state(eval_static(cfg), seed=0, device=device)
    if not args.untrained:
        ckpt = CheckpointManager(args.ckpt)
        step = ckpt.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint under {args.ckpt}")
        ckpt.restore(state, step)
        print(f"restored step {step} from {args.ckpt}")

    res = evaluate_odometry(cfg, state.pose_net, 9, gt_path, device=device)
    tag = "untrained" if args.untrained else "trained"
    print(f"[{tag}] ate_direct {res['ate_direct']:.4f} +- {res['ate_direct_std']:.4f} | "
          f"ate_chained {res['ate_chained']:.4f} +- {res['ate_chained_std']:.4f} "
          f"(units; 1 unit ~ 5.4 m)")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
