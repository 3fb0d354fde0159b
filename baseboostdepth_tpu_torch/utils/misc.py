"""Misc helpers, a copy of `baseboostdepth_tpu/utils/misc.py`: file lists,
time formatting, image normalization, the disparity colormap (reference
utils.py:9-43, trainer.py:1102-1140)."""

from __future__ import annotations

import os

import numpy as np

from baseboostdepth_tpu_torch.utils import colormaps


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


def _lut(cmap: str) -> np.ndarray:
    """[259, 3] float64: the 256 entries, then the under (first entry), over
    (last entry) and bad (black) colours, as ListedColormap._init lays them."""
    table = {"plasma": colormaps.PLASMA, "magma": colormaps.MAGMA}.get(cmap)
    if table is None:
        raise ValueError(f"colormap {cmap!r} is not carried (plasma, magma)")
    lut = np.array(table, dtype=np.float64)
    return np.concatenate([lut, lut[:1], lut[-1:], np.zeros((1, 3))])


def colormap(x: np.ndarray, cmap: str = "plasma", normalize: bool = True) -> np.ndarray:
    """[H, W] -> [H, W, 3] float colormap in [0, 1], equal to
    `matplotlib.colormaps[cmap](v)[..., :3]` without matplotlib: the lookup of
    ListedColormap.__call__ (float v -> int(v * 256), v == 1 -> the last
    entry, v < 0 -> under, v >= 1 -> over, NaN -> bad)."""
    v = normalize_image(x) if normalize else x
    xa = np.array(v, copy=True)
    if xa.dtype.kind == "f":
        xa *= 256
        xa[xa == 256] = 255
    under, over, bad = xa < 0, xa >= 256, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 256
    idx[over] = 257
    idx[bad] = 258
    return _lut(cmap).take(idx, axis=0, mode="clip")
