"""KITTI raw and odometry dataset indexing and intrinsics, a copy of
`baseboostdepth_tpu/data/kitti.py`.

Path scheme and intrinsics follow the reference
(datasets/kitti_dataset.py:14-23 normalized K scaled by output dims;
:50-56 image path folder/image_0{2,3}/data/{:010d}.jpg). Indexing is plain
python; all pixel work happens in loader.py / on the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

SIDE_MAP = {"l": 2, "r": 3}
OTHER_SIDE = {"l": "r", "r": "l"}

# Normalized KITTI intrinsics (reference datasets/kitti_dataset.py:16-20).
K_NORM = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)


def intrinsics(width: int, height: int) -> Tuple[np.ndarray, np.ndarray]:
    """K and K^-1 at the given output resolution."""
    K = K_NORM.copy()
    K[0] *= width
    K[1] *= height
    return K, np.linalg.pinv(K)


def readlines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


@dataclass
class KittiSample:
    folder: str
    frame_index: int
    side: str
    baseline: float = 0.0  # per-sample motion magnitude (5th split column)


def parse_split_line(line: str) -> KittiSample:
    """Parse 'folder frame side [tag] [baseline]' split lines
    (eigen_zhou/train_files_baselines.txt carries the baseline column)."""
    parts = line.split()
    folder = parts[0]
    frame_index = int(parts[1]) if len(parts) >= 2 else 0
    side = parts[2] if len(parts) >= 3 else "l"
    baseline = float(parts[-1]) if len(parts) >= 4 else 0.0
    return KittiSample(folder, frame_index, side, baseline)


class KittiRawIndex:
    """Index over a KITTI-raw split file."""

    def __init__(self, data_path: str, split_file: str, img_ext: str = ".jpg"):
        self.data_path = data_path
        self.img_ext = img_ext
        self.samples = [parse_split_line(ln) for ln in readlines(split_file)]

    def __len__(self) -> int:
        return len(self.samples)

    def image_path(self, folder: str, frame_index: int, side: str) -> str:
        fname = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(
            self.data_path, folder, f"image_0{SIDE_MAP[side]}", "data", fname
        )

    def exists(self, folder: str, frame_index: int, side: str) -> bool:
        return os.path.isfile(self.image_path(folder, frame_index, side))


class KittiOdomIndex:
    """Index over KITTI odometry sequences (datasets/kitti_dataset.py:62-93);
    the pose evaluator reads windows of consecutive frames."""

    def __init__(self, data_path: str, split_file: str, img_ext: str = ".png"):
        self.data_path = data_path
        self.img_ext = img_ext
        self.samples = [parse_split_line(ln) for ln in readlines(split_file)]

    def __len__(self) -> int:
        return len(self.samples)

    def image_path(self, sequence: str, frame_index: int, side: str = "l") -> str:
        fname = f"{frame_index:06d}{self.img_ext}"
        return os.path.join(
            self.data_path,
            "sequences",
            f"{int(sequence):02d}",
            f"image_{SIDE_MAP[side]}",
            fname,
        )
