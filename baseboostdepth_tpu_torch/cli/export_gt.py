"""Ground-truth exporter (reference export_gt_depth.py), a copy of
`baseboostdepth_tpu/cli/export_gt.py`: builds gt_depths.npz for a split
(velodyne projection for eigen/eigen_zhou, PNG/256 for eigen_benchmark) and
gt_edges.npz for SYNS (Sobel on log depth). Host code only: it runs no
network and needs no GPU.

Usage:
  python -m baseboostdepth_tpu_torch.cli.export_gt --split eigen_zhou \
      --kt_path /data/KITTI_RAW --splits_dir splits [--val]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def to_log(depth: np.ndarray) -> np.ndarray:
    return (depth > 0) * np.log(depth.clip(min=1.1920928955078125e-07))


def _suffix(split_dir: str, which: str) -> str:
    """GT filename suffix. A val export is tagged `_val` only when the split
    ALSO has a test set -- so it can never clobber the test GT (SYNS has
    both; evaluation/syns.py reads the *_val.npz sidecars for the online
    val). A val-only split (eigen_zhou) keeps the plain name: its val GT IS
    the file the Trainer's online validation and the reference's exporter
    use (export_gt_depth.py:32-34 reads val_files for eigen_zhou but still
    writes gt_depths.npz)."""
    has_test = os.path.exists(os.path.join(split_dir, "test_files.txt"))
    return "_val" if (which == "val" and has_test) else ""


def export_kitti(split: str, kt_path: str, splits_dir: str, which: str = "test"):
    from PIL import Image

    from baseboostdepth_tpu_torch.data.kitti_utils import generate_depth_map
    from baseboostdepth_tpu_torch.utils import readlines

    split_dir = os.path.join(splits_dir, split)
    # val-only splits (eigen_zhou) export their val list by default, exactly
    # as the reference does (export_gt_depth.py:32-34)
    if which == "test" and not os.path.exists(
        os.path.join(split_dir, "test_files.txt")
    ):
        which = "val"
    fname = {"test": "test_files.txt", "val": "val_files.txt"}[which]
    lines = readlines(os.path.join(split_dir, fname))

    print(f"exporting GT depths for {split}/{fname} ({len(lines)} samples)")
    gt_depths = []
    for line in lines:
        parts = line.split()
        folder, frame_id = parts[0], int(parts[1])
        if split in ("eigen", "eigen_zhou", "eigen_full"):
            calib_dir = os.path.join(kt_path, folder.split("/")[0])
            velo = os.path.join(
                kt_path, folder, "velodyne_points", "data", f"{frame_id:010d}.bin"
            )
            gt_depths.append(generate_depth_map(calib_dir, velo, 2, True).astype(np.float32))
        elif split == "eigen_benchmark":
            path = os.path.join(
                kt_path, folder, "proj_depth", "groundtruth", "image_02",
                f"{frame_id:010d}.png",
            )
            gt_depths.append(np.asarray(Image.open(path)).astype(np.float32) / 256.0)
        else:
            raise ValueError(f"no GT exporter for split {split}")

    out = os.path.join(split_dir, f"gt_depths{_suffix(split_dir, which)}.npz")
    np.savez_compressed(out, data=np.array(gt_depths, dtype=object))
    print(f"wrote {out}")


def export_syns_edges(syns_path: str, splits_dir: str, which: str = "test"):
    """SYNS: depth .npy files -> gt_depths.npz + Sobel log-depth edge maps
    (reference export_gt_depth.py SYNS branch)."""
    import cv2

    from baseboostdepth_tpu_torch.utils import readlines

    split_dir = os.path.join(splits_dir, "SYNS")
    lines = readlines(os.path.join(split_dir, f"{which}_files.txt"))
    gt_depths, gt_edges = [], []
    for line in lines:
        folder, frame = line.split()
        depth = np.load(os.path.join(syns_path, "depths", folder, f"{frame}.npy"))
        gt_depths.append(depth.astype(np.float32))
        d = to_log(depth.squeeze())
        d = cv2.GaussianBlur(d, (3, 3), sigmaX=1, sigmaY=1)
        dx = cv2.Sobel(src=d, ddepth=cv2.CV_64F, dx=1, dy=0, ksize=5)
        dy = cv2.Sobel(src=d, ddepth=cv2.CV_64F, dx=0, dy=1, ksize=5)
        mag = np.sqrt(dx**2 + dy**2)[..., None]
        gt_edges.append(mag > mag.mean())
    # which="val" writes the *_val.npz sidecars evaluation/syns.py reads for
    # the online SYNS validation (file_name='val_files.txt' -> suffix '_val')
    suffix = _suffix(split_dir, which)
    np.savez_compressed(os.path.join(split_dir, f"gt_depths{suffix}.npz"),
                        data=np.array(gt_depths, dtype=object))
    np.savez_compressed(os.path.join(split_dir, f"gt_edges{suffix}.npz"),
                        data=np.array(gt_edges, dtype=object))
    print(f"wrote SYNS gt_depths{suffix}.npz / gt_edges{suffix}.npz "
          f"({len(lines)} samples)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", required=True,
                    choices=["eigen", "eigen_zhou", "eigen_full", "eigen_benchmark", "SYNS"])
    ap.add_argument("--kt_path", default="kitti_data")
    ap.add_argument("--syns_path", default="syns_data")
    ap.add_argument("--splits_dir", default="splits")
    ap.add_argument("--val", action="store_true", help="export val_files instead of test_files")
    args = ap.parse_args(argv)

    which = "val" if args.val else "test"
    if args.split == "SYNS":
        export_syns_edges(args.syns_path, args.splits_dir, which)
    else:
        export_kitti(args.split, args.kt_path, args.splits_dir, which)


if __name__ == "__main__":
    main(sys.argv[1:])
