"""Batch KITTI/SYNS depth evaluation (the reference's evaluate_depth.py as a
library + CLI), the counterpart of `baseboostdepth_tpu/evaluation/depth.py`.

Pipeline parity (evaluate_depth.py:104-317): run encoder+decoder over the
test split at checkpoint resolution, collect scaled disparities (or metric
depth for SQL), cv2-resize each to GT resolution, invert, Garg-crop +
range-mask, median-scale (mono) or x5.4 (stereo), average the 7 metrics.
Batched device inference replaces the reference's bs=1 loop. The functions
take the port's depth network (an nn.Module) where the JAX ones take
(params, stats).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from baseboostdepth_tpu_torch import geometry
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.data.loader import EvalLoader
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation import metrics as M
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import StepStatic, TrainState, _autocast, init_state
from baseboostdepth_tpu_torch.utils import resolve_splits_dir


def eval_static(cfg: Config) -> StepStatic:
    """The StepStatic the evaluators build from a config."""
    return StepStatic(
        zoo=cfg.model.zoo, num_layers=cfg.model.num_layers,
        height=cfg.data.height, width=cfg.data.width,
        min_depth=cfg.method.min_depth, max_depth=cfg.method.max_depth,
        dtype=cfg.model.dtype,
    )


def restore_state(cfg: Config, checkpoint: str, device="cuda") -> TrainState:
    """A TrainState from init_state on `device`, restored from the latest
    checkpoint under `checkpoint` (what the evaluation CLIs score)."""
    state = init_state(eval_static(cfg), seed=0, device=device)
    state, _ = CheckpointManager(checkpoint).restore(state)
    return state


def make_disp_forward(st: StepStatic, device="cuda"):
    """Build fwd(depth_net, images float [B, H, W, 3] in [0, 1]) -> [B, H, W]
    float32 scaled disparity (non-SQL) or metric depth (SQL) on `device`.
    The network runs in eval mode without gradients, under the bf16
    autocast of st.dtype as the training step applies it."""
    device = require_device(device)

    @torch.no_grad()
    def fwd(depth_net: nn.Module, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(device, torch.float32)
        depth_net.eval()
        with _autocast(st, device):
            disps = depth_net(x)
        d0 = disps[0].float()[..., 0]
        if st.metric_depth:
            return d0
        scaled, _ = geometry.disp_to_depth(d0, st.min_depth, st.max_depth)
        return scaled

    return fwd


def predict_disparities(
    st: StepStatic,
    depth_net: nn.Module,
    paths: List[str],
    batch_size: int = 16,
    post_process: bool = False,
    device="cuda",
) -> np.ndarray:
    """Run the depth network over a list of image paths -> [N, H, W] disps.

    post_process: flip-averaging from the original monodepth paper
    (reference exposes it via --post_process)."""
    fwd = make_disp_forward(st, device)
    loader = EvalLoader(paths, st.height, st.width, batch_size=batch_size)
    out = []
    for imgs, start, n in loader:
        x = imgs.astype(np.float32) / 255.0
        d = fwd(depth_net, x).cpu().numpy()
        if post_process:
            x_f = np.ascontiguousarray(x[:, :, ::-1])
            d_f = fwd(depth_net, x_f).cpu().numpy()[:, :, ::-1]
            d = _batch_post_process(d, d_f)
        out.append(d[:n])
    return np.concatenate(out, axis=0)


def _batch_post_process(disp: np.ndarray, disp_flipped: np.ndarray) -> np.ndarray:
    """Monodepth v1 flip post-processing: blend the prediction and the
    flipped prediction with a left/right ramp."""
    _, h, w = disp.shape
    mean = 0.5 * (disp + disp_flipped)
    xs = np.linspace(0, 1, w, dtype=np.float32)[None, None, :]
    mask = np.clip(20 * (xs - 0.05), 0, 1)
    mask_f = mask[:, :, ::-1]
    return mask_f * disp + mask * disp_flipped + (1.0 - mask - mask_f) * mean


def load_gt(path: str) -> np.ndarray:
    """The `data` array of a gt_depths/gt_edges .npz (object array of maps)."""
    return np.load(path, fix_imports=True, encoding="latin1", allow_pickle=True)["data"]


def score_disparities(disps: np.ndarray, gt_depths, stereo: bool, disp_input: bool) -> dict:
    """The eigen metrics of a disparity stack against its GT, with the
    median-scaling ratio's median and spread under the mono protocol."""
    protocol = M.EvalProtocol.stereo() if stereo else M.EvalProtocol.mono()
    protocol.disp_input = disp_input
    mean_errors, ratios = M.evaluate_disparities(disps, list(gt_depths), protocol)
    result = dict(zip(M.METRIC_NAMES, mean_errors.tolist()))
    if len(ratios):
        med = np.median(ratios)
        result["median_ratio"] = float(med)
        result["ratio_std"] = float(np.std(ratios / med))
    return result


def evaluate_kitti(
    cfg: Config,
    depth_net: nn.Module,
    eval_split: str = "eigen",
    stereo: bool = False,
    post_process: bool = False,
    save_pred_disps: Optional[str] = None,
    device="cuda",
) -> dict:
    """End-to-end KITTI eval: test_files.txt -> metrics dict."""
    st = eval_static(cfg)
    split_dir = os.path.join(resolve_splits_dir(cfg.data.splits_dir), eval_split)
    index = kitti.KittiRawIndex(
        cfg.data.kt_path, os.path.join(split_dir, "test_files.txt"), ".jpg"
    )
    paths = [index.image_path(s.folder, s.frame_index, s.side) for s in index.samples]

    disps = predict_disparities(st, depth_net, paths, post_process=post_process, device=device)
    if save_pred_disps:
        np.save(save_pred_disps, disps)

    gt = load_gt(os.path.join(split_dir, "gt_depths.npz"))
    return score_disparities(disps, gt, stereo, disp_input=not st.metric_depth)


def print_metrics(result: dict) -> None:
    names = [n for n in M.METRIC_NAMES if n in result]
    print("\n  " + ("{:>9} | " * len(names)).format(*names))
    print(("&{: 9.3f}  " * len(names)).format(*[result[n] for n in names]) + "\\\\")
