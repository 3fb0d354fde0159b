"""Depth evaluation entry point (reference evaluate_depth.py), the
counterpart of `baseboostdepth_tpu/cli/evaluate_depth.py`.

Usage:
  python -m baseboostdepth_tpu_torch.cli.evaluate_depth --config cfg.json \
      --checkpoint logs/bbd/checkpoints [--split eigen] [--stereo]

Runs on the GPU; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.depth import (
    evaluate_kitti,
    load_gt,
    print_metrics,
    restore_state,
    score_disparities,
)
from baseboostdepth_tpu_torch.evaluation.syns import evaluate_syns
from baseboostdepth_tpu_torch.models import DEPTH_IS_METRIC
from baseboostdepth_tpu_torch.utils import resolve_splits_dir


def main(argv=None, device="cuda") -> dict:
    device = require_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--split", default="eigen",
                    choices=["eigen", "eigen_benchmark", "benchmark", "SYNS"])
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--post_process", action="store_true")
    ap.add_argument("--chamfer", action="store_true")
    ap.add_argument("--save_pred_disps", default=None)
    ap.add_argument("--ext_disp_to_eval", default=None,
                    help="evaluate a saved .npy disparity stack instead of a model")
    args = ap.parse_args(argv)

    cfg = Config.load(args.config)

    if args.ext_disp_to_eval:
        # metric loop only, over precomputed disparities (reference
        # evaluate_depth.py --ext_disp_to_eval), with the live eval's input
        # interpretation (SQL saves metric depth, not disparity), so scoring
        # a --save_pred_disps file reproduces the live run bit for bit
        disps = np.load(args.ext_disp_to_eval)
        gt = load_gt(os.path.join(resolve_splits_dir(cfg.data.splits_dir), args.split,
                                  "gt_depths.npz"))
        result = score_disparities(disps, gt, args.stereo,
                                   disp_input=cfg.model.zoo not in DEPTH_IS_METRIC)
    else:
        state = restore_state(cfg, args.checkpoint, device)
        if args.split == "SYNS":
            result = evaluate_syns(cfg, state.depth_net, chamfer=args.chamfer, device=device)
        else:
            result = evaluate_kitti(
                cfg, state.depth_net, eval_split=args.split, stereo=args.stereo,
                post_process=args.post_process, save_pred_disps=args.save_pred_disps,
                device=device,
            )
    print_metrics(result)
    for k, v in result.items():
        print(f"{k}: {v:.6f}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
