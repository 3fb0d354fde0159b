"""Comparison visualization (reference validation.py), the counterpart of
`baseboostdepth_tpu/cli/visualize.py`: run one or more checkpoints over an
image sequence, render input | colormapped disparity panels, and write a
stitched video (cv2.VideoWriter, MJPG). With --gt_npz (a gt_depths.npz
aligned with the frame list, as export_gt produces), each panel is stamped
with that model's per-frame abs_rel (reference validation.py:179, 228-273:
median scaling + Garg crop, depth range [0.1, 80]).

Usage:
  python -m baseboostdepth_tpu_torch.cli.visualize \
      --image_dir /data/seq --out video.avi \
      --model cfgA.json:ckptA --model cfgB.json:ckptB [--fps 10] \
      [--gt_npz gt_depths.npz]

Runs on the GPU; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
from PIL import Image

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.depth import eval_static, make_disp_forward, restore_state
from baseboostdepth_tpu_torch.evaluation.metrics import single_image_errors
from baseboostdepth_tpu_torch.utils import colormap


def _load_model(spec: str, device):
    cfg_path, ckpt = spec.split(":", 1)
    cfg = Config.load(cfg_path)
    st = eval_static(cfg)
    state = restore_state(cfg, ckpt, device)
    return cfg.log.model_name, st, state, make_disp_forward(st, device)


def main(argv=None, device="cuda") -> str:
    """Write the video; return its path."""
    import cv2

    device = require_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--ext", default="jpg")
    ap.add_argument("--out", default="comparison.avi")
    ap.add_argument("--model", action="append", required=True,
                    help="config.json:checkpoint_dir (repeatable)")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--gt_npz", default=None,
                    help="gt_depths.npz aligned with the sorted frame list; "
                    "stamps per-frame abs_rel on each model panel "
                    "(reference validation.py:179)")
    args = ap.parse_args(argv)

    models = [_load_model(spec, device) for spec in args.model]
    paths = sorted(glob.glob(os.path.join(args.image_dir, f"*.{args.ext}")))
    print(f"{len(models)} model(s), {len(paths)} frames")

    gt_depths = None
    if args.gt_npz:
        gt_depths = np.load(args.gt_npz, allow_pickle=True)["data"]
        if len(gt_depths) < len(paths):
            raise ValueError(f"{len(gt_depths)} GT depths for {len(paths)} frames")

    writer = None
    for fi, p in enumerate(paths):
        with Image.open(p) as im:
            im = im.convert("RGB")
            panels = []
            for name, st, state, fwd in models:
                x = np.asarray(
                    im.resize((st.width, st.height), Image.LANCZOS), np.float32
                ) / 255.0
                disp = fwd(state.depth_net, x[None])[0].cpu().numpy()
                label = name
                if gt_depths is not None:
                    gt = gt_depths[fi]
                    # validation.py:233-273 protocol: disp resized to GT res,
                    # depth = 1/disp, median scale under Garg crop, [0.1, 80]
                    dfull = cv2.resize(disp, (gt.shape[1], gt.shape[0]))
                    abs_rel = single_image_errors(
                        1.0 / np.maximum(dfull, 1e-9), gt,
                        min_depth=0.1, max_depth=80.0,
                    )[0]
                    label = f"{name} abs_rel={abs_rel:.3f}"
                vmax = np.percentile(disp, 95)
                vis = (colormap(np.clip(disp / max(vmax, 1e-9), 0, 1), normalize=False)
                       * 255).astype(np.uint8)
                cv2.putText(vis, label, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1)
                panels.append(vis)
            inp = np.asarray(im.resize((models[0][1].width, models[0][1].height)), np.uint8)
            frame = np.ascontiguousarray(np.concatenate([inp] + panels, axis=0)[:, :, ::-1])  # BGR
        if writer is None:
            writer = cv2.VideoWriter(
                args.out, cv2.VideoWriter_fourcc(*"MJPG"), args.fps,
                (frame.shape[1], frame.shape[0]),
            )
            if not writer.isOpened():
                raise RuntimeError(f"cv2.VideoWriter could not open {args.out} (MJPG)")
        writer.write(frame)
    if writer is not None:
        writer.release()
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
