"""Odometry ATE evaluation entry point (reference evaluate_pose.py), the
counterpart of `baseboostdepth_tpu/cli/evaluate_pose.py`.

Usage:
  python -m baseboostdepth_tpu_torch.cli.evaluate_pose --config cfg.json \
      --checkpoint ckpts --sequence 9 --gt_poses /data/odom/poses/09.txt

Runs on the GPU; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.depth import restore_state
from baseboostdepth_tpu_torch.evaluation.pose import evaluate_odometry


def main(argv=None, device="cuda") -> dict:
    device = require_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--sequence", type=int, required=True, choices=[9, 10])
    ap.add_argument("--gt_poses", required=True, help="KITTI odometry poses txt")
    ap.add_argument("--skip_frame", type=int, default=2)
    args = ap.parse_args(argv)

    cfg = Config.load(args.config)
    state = restore_state(cfg, args.checkpoint, device)
    res = evaluate_odometry(cfg, state.pose_net, args.sequence, args.gt_poses, args.skip_frame,
                            device=device)
    print(f"\n  Trajectory error (direct):  {res['ate_direct']:.3f}, std {res['ate_direct_std']:.3f}")
    print(f"  Trajectory error (chained): {res['ate_chained']:.3f}, std {res['ate_chained_std']:.3f}\n")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
