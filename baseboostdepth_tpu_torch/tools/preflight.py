"""Day-1 data runbook, the counterpart of the JAX package's
`tools/preflight.py`: validate a KITTI tree, its splits and its exported
GT in minutes, before spending hours on a training run.

Checks, in order (each prints PASS / FAIL / SKIP; the tool exits 1 on any
FAIL):
  1. splits resolve and parse (train/val lists, baseline column)
  2. KITTI image tree: sampled existence of train frames + stereo pairs
  3. decode and resize of one image (intrinsics / resolution sanity)
  4. exported GT depths present and aligned with the val list
  5. one real train batch loads through the production loader
  6. one train step runs on the device with a finite loss (the step the
     Trainer runs: stage 0, md2, bf16)
  7. a 10-image eval through the metric path returns finite numbers

    python -m baseboostdepth_tpu_torch.tools.preflight --kt_path /data/kitti_raw \\
        [--splits_dir splits] [--split eigen_zhou] [--quick]

--quick runs the host checks only. Runs on the GPU; `main(argv,
device="cpu")` runs the device checks on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
from baseboostdepth_tpu_torch.data.loader import EvalLoader, KittiTrainLoader, load_resized
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.metrics import single_image_errors
from baseboostdepth_tpu_torch.training.step import (
    StepStatic,
    init_state,
    make_eval_forward,
    make_train_step,
)
from baseboostdepth_tpu_torch.utils import readlines, resolve_splits_dir


def require(cond, detail) -> None:
    """A check's condition (an assert that -O does not remove)."""
    if not cond:
        raise AssertionError(detail)


class Checks:
    """Runs named checks, printing PASS / FAIL / SKIP, and keeps the names
    of those that failed."""

    def __init__(self):
        self.failures = []

    def __call__(self, name, fn, skip=False):
        if skip:
            print(f"SKIP  {name}")
            return None
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 -- every failure is reported, then exit 1
            print(f"FAIL  {name}: {type(e).__name__}: {e}")
            self.failures.append(name)
            return None
        print(f"PASS  {name}" + (f"  ({out})" if isinstance(out, str) else ""))
        return out


def main(argv=None, device="cuda") -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kt_path", required=True)
    ap.add_argument("--splits_dir", default="splits")
    ap.add_argument("--split", default="eigen_zhou")
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--batch_size", type=int, default=12)
    ap.add_argument("--png", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="host-side checks only (nothing runs on the device)")
    ap.add_argument("--sample", type=int, default=200,
                    help="existence-check sample size per list")
    args = ap.parse_args(argv)
    if not args.quick:
        device = require_device(device)

    check = Checks()
    splits_dir = resolve_splits_dir(args.splits_dir)
    split_dir = os.path.join(splits_dir, args.split)
    ext = ".png" if args.png else ".jpg"
    train_file = os.path.join(split_dir, "train_files_baselines.txt")
    if not os.path.exists(train_file):
        train_file = os.path.join(split_dir, "train_files.txt")

    # 1. splits ------------------------------------------------------------
    def parse_splits():
        train = readlines(train_file)
        val = readlines(os.path.join(split_dir, "val_files.txt"))
        has_baseline = len(train[0].split()) == 5
        if has_baseline:
            bs = [float(ln.split()[4]) for ln in train[:1000]]
            require(min(bs) > 0, "non-positive baseline entries")
        return f"{len(train)} train / {len(val)} val, baselines={has_baseline}"

    check("splits parse", parse_splits)

    index = kitti.KittiRawIndex(args.kt_path, train_file, ext)

    # 2. image tree --------------------------------------------------------
    def existence():
        n = len(index)
        sel = np.linspace(0, n - 1, min(args.sample, n)).astype(int)
        missing = []
        for i in sel:
            s = index.samples[int(i)]
            p = index.image_path(s.folder, s.frame_index, s.side)
            if not os.path.exists(p):
                missing.append(p)
            ps = index.image_path(s.folder, s.frame_index, kitti.OTHER_SIDE[s.side])
            if not os.path.exists(ps):
                missing.append(ps)
        require(not missing, f"{len(missing)} missing, e.g. {missing[:2]}")
        return f"{2 * len(sel)} files sampled"

    check("KITTI image tree", existence)

    # 3. decode sanity -----------------------------------------------------
    def decode():
        s = index.samples[0]
        img = load_resized(
            index.image_path(s.folder, s.frame_index, s.side), args.width, args.height
        )
        require(img.shape == (args.height, args.width, 3), img.shape)
        require(img.std() > 1.0, "image looks blank")
        return f"shape {img.shape}"

    check("image decode+resize", decode)

    # 4. exported GT -------------------------------------------------------
    gt_file = os.path.join(split_dir, "gt_depths.npz")

    def gt():
        require(os.path.exists(gt_file),
                f"{gt_file} missing -- run python -m baseboostdepth_tpu_torch.cli.export_gt "
                f"--split {args.split} --kt_path {args.kt_path} --val")
        data = np.load(gt_file, fix_imports=True, encoding="latin1",
                       allow_pickle=True)["data"]
        val = readlines(os.path.join(split_dir, "val_files.txt"))
        require(len(data) == len(val), (len(data), len(val)))
        d0 = data[0]
        require(d0.ndim == 2 and (d0 > 0).sum() > 100, "GT depth 0 looks empty")
        return f"{len(data)} GT maps"

    check("exported GT depths", gt)

    # 5-7. device path -----------------------------------------------------
    if args.quick:
        for name in ("train batch", "train step", "10-image eval"):
            check(name, lambda: None, skip=True)
    else:
        device_checks(check, args, index, split_dir, gt_file, ext, device)

    print()
    if check.failures:
        print(f"preflight FAILED: {check.failures}")
        raise SystemExit(1)
    print("preflight OK -- ready to train")


def device_checks(check: Checks, args, index, split_dir: str, gt_file: str, ext: str,
                  device) -> None:
    """Checks 5-7: a loader batch, a train step and a 10-image eval on
    `device`."""
    import cv2

    stage = stage_for_epoch(0, trimin=True)
    batch_holder = {}

    def one_batch():
        loader = KittiTrainLoader(
            index, stage, args.batch_size, args.height, args.width,
            trimin=True, use_stereo=True, num_workers=4, seed=0,
        )
        batch_holder["b"] = next(iter(loader))
        return f"frames {batch_holder['b']['frames'].shape}"

    check("train batch", one_batch)

    def one_step():
        st = StepStatic(
            zoo="md2", height=args.height, width=args.width,
            F=stage.F, scales=tuple(stage.scales), trimin=True,
            decomp=True, dtype="bfloat16",
        )
        state = init_state(st, seed=0, device=device, steps_per_epoch=100)
        fn = make_train_step(st, device)
        metrics = fn(state, batch_holder["b"], generator=torch.Generator(device).manual_seed(1))
        loss = float(metrics["loss"])
        require(np.isfinite(loss), loss)
        return f"loss {loss:.4f}"

    check("train step", one_step, skip="b" not in batch_holder)

    def small_eval():
        data = np.load(gt_file, fix_imports=True, encoding="latin1",
                       allow_pickle=True)["data"]
        val_index = kitti.KittiRawIndex(
            args.kt_path, os.path.join(split_dir, "val_files.txt"), ext
        )
        paths = [
            val_index.image_path(s.folder, s.frame_index, s.side)
            for s in val_index.samples[:10]
        ]
        st = StepStatic(zoo="md2", height=args.height, width=args.width)
        state = init_state(st, seed=0, device=device, steps_per_epoch=100)
        fwd = make_eval_forward(st, device)
        errs = []
        for imgs, start, n in EvalLoader(paths, args.height, args.width, 10):
            depth = fwd(state.depth_net, imgs.astype(np.float32) / 255.0).cpu().numpy()
            for j in range(n):
                gt_d = data[start + j]
                pred = cv2.resize(depth[j], (gt_d.shape[1], gt_d.shape[0]))
                errs.append(single_image_errors(pred, gt_d))
        m = np.mean(np.asarray(errs), axis=0)
        require(np.all(np.isfinite(m)), m)
        return f"abs_rel {m[0]:.3f} (untrained net -- finiteness check only)"

    check("10-image eval", small_eval, skip=not os.path.exists(gt_file))


if __name__ == "__main__":
    main(sys.argv[1:])
