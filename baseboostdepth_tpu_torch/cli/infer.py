"""Single-image / folder depth inference demo (reference test_simple.py), the
counterpart of `baseboostdepth_tpu/cli/infer.py`: load a checkpoint, predict
disparity, save `<name>_disp.npy` and a colormapped `<name>_disp.jpeg`.

Usage:
  python -m baseboostdepth_tpu_torch.cli.infer --config cfg.json \
      --checkpoint logs/bbd/checkpoints --image_path assets/test.jpg

Runs on the GPU; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.depth import eval_static, make_disp_forward, restore_state
from baseboostdepth_tpu_torch.utils import colormap


def upsample_for_display(disp: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[h, w] -> [height, width] linear resize, as jax.image.resize(...,
    "linear") computes it: half-pixel centres, antialiased where it
    shrinks."""
    h, w = disp.shape
    out = F.interpolate(disp[None, None], size=(height, width), mode="bilinear",
                        align_corners=False, antialias=height < h or width < w)
    return out[0, 0]


def main(argv=None, device="cuda") -> list:
    """Predict every image; return the paths written."""
    device = require_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--image_path", required=True, help="image file or folder")
    ap.add_argument("--ext", default="jpg")
    ap.add_argument("--out_dir", default=None)
    args = ap.parse_args(argv)

    cfg = Config.load(args.config)
    st = eval_static(cfg)
    state = restore_state(cfg, args.checkpoint, device)
    fwd = make_disp_forward(st, device)

    if os.path.isdir(args.image_path):
        paths = sorted(glob.glob(os.path.join(args.image_path, f"*.{args.ext}")))
        out_dir = args.out_dir or args.image_path
    else:
        paths = [args.image_path]
        out_dir = args.out_dir or os.path.dirname(args.image_path)
    os.makedirs(out_dir, exist_ok=True)
    print(f"predicting on {len(paths)} image(s)")

    written = []
    for p in paths:
        with Image.open(p) as im:
            im = im.convert("RGB")
            ow, oh = im.size
            x = np.asarray(im.resize((st.width, st.height), Image.LANCZOS), np.float32) / 255.0
        disp = fwd(state.depth_net, x[None])[0]
        # upsample to the original resolution for display
        disp_big = upsample_for_display(disp, oh, ow).cpu().numpy()
        base = os.path.splitext(os.path.basename(p))[0]
        npy = os.path.join(out_dir, f"{base}_disp.npy")
        np.save(npy, disp.cpu().numpy())
        # percentile-normalized magma visualization (test_simple.py:141-155)
        vmax = np.percentile(disp_big, 95)
        vis = np.clip(disp_big / max(vmax, 1e-9), 0, 1)
        rgb = (colormap(vis, cmap="magma", normalize=False) * 255).astype(np.uint8)
        jpeg = os.path.join(out_dir, f"{base}_disp.jpeg")
        Image.fromarray(rgb).save(jpeg)
        written += [npy, jpeg]
        print(f"  {base} -> {base}_disp.jpeg")
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
