"""Misc helpers, a copy of `baseboostdepth_tpu/utils/misc.py`: file lists,
time formatting, image normalization, the disparity colormap (reference
utils.py:9-43, trainer.py:1102-1140)."""

from __future__ import annotations

import os

import numpy as np


def readlines(path: str):
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def resolve_splits_dir(path: str) -> str:
    """Resolve a splits directory: as given if it exists, else the copy
    shipped at the repo root (so the default `splits` works from any cwd)."""
    if os.path.isdir(path) or os.path.isabs(path):
        return path
    shipped = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), path
    )
    return shipped if os.path.isdir(shipped) else path


def sec_to_hm_str(t: float) -> str:
    """10239 -> '02h50m39s'."""
    t = int(t)
    s = t % 60
    m = (t // 60) % 60
    h = t // 3600
    return f"{h:02d}h{m:02d}m{s:02d}s"


def normalize_image(x: np.ndarray) -> np.ndarray:
    """Rescale to [0, 1] for visualization."""
    ma, mi = float(np.max(x)), float(np.min(x))
    d = ma - mi if ma != mi else 1e5
    return (x - mi) / d


def colormap(x: np.ndarray, cmap: str = "plasma", normalize: bool = True) -> np.ndarray:
    """[H, W] -> [H, W, 3] float colormap in [0, 1]; matplotlib is imported
    here, so paths that draw no image never need it."""
    import matplotlib

    cm = matplotlib.colormaps.get_cmap(cmap)
    v = normalize_image(x) if normalize else x
    return cm(v)[..., :3]
