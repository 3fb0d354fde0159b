"""Checkpoint-parity protocol, the counterpart of the JAX package's
`tools/verify_reference_parity.py`: import a published reference
checkpoint and reproduce its KITTI eigen metrics through the port's
evaluation path.

It needs the reference's weights folder (encoder.pth / depth.pth /
pose_encoder.pth / pose.pth) and KITTI raw with gt_depths.npz:

    python -m baseboostdepth_tpu_torch.tools.verify_reference_parity \\
        --weights /path/to/weights_folder --kt_path /data/KITTI_RAW \\
        --splits_dir splits [--zoo md2] [--expected_abs_rel 0.106]

Pretrained-start validation (no KITTI needed): the raw ImageNet encoder
file the reference loads -- mpvit_small.pth (networksvit/mpvit.py:809-821),
the hrnetv2_w18 ImageNet weights (networksDIFF/test_hr_encoder.py:500-547)
or a torchvision resnet .pth -- goes through the port's importer:

    python -m baseboostdepth_tpu_torch.tools.verify_reference_parity --zoo monovit \\
        --pretrained_start ckpt/mpvit_small.pth [--pose_weights resnet18.pth]

Every zoo gets a finite forward; monovit and diffnet also key coverage
against the torch replicas of the reference encoders in the repository's
tests/ (tests/torch_mpvit_ref.py, tests/torch_zoo_refs.py, loaded from the
checkout this package sits in), and monovit the port's MPViT against the
replica on the same bytes, each feature to 1e-3 of its largest entry.
Runs on the GPU; `main(argv, device="cpu")` runs on the CPU. A FAIL exits
1.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import sys

import numpy as np
import torch

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.depth import evaluate_kitti, print_metrics
from baseboostdepth_tpu_torch.models.torch_import import (
    IMPORTERS,
    load_pretrained_encoder,
    load_torch_state_dict,
)
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state

PARITY_TOL = 1e-3
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _replica_module(name: str):
    """tests/<name>.py of the repository this package is checked out in,
    loaded by its path: a `tests` package installed on the machine would
    shadow the repository's tests/ directory (which is not a package)."""
    path = os.path.join(REPO_ROOT, "tests", f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"{path} not found: the replicas ship in the repository's tests/; "
                         "run the tool from a checkout of the repository")
    spec = importlib.util.spec_from_file_location(f"bbd_replica_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def replica(zoo: str):
    """The torch replica of the reference's encoder for monovit (MPViT-small)
    and diffnet (HRNet-18), from the repository's tests/; None for the
    ResNet-backed zoos."""
    if zoo == "monovit":
        return _replica_module("torch_mpvit_ref").mpvit_small()
    if zoo == "diffnet":
        return _replica_module("torch_zoo_refs").make_hrnet18()
    return None


@contextlib.contextmanager
def full_float32():
    """TF32 off for convolutions and matmuls inside the block (the parity
    check compares float32 forwards), the settings restored after it."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def verify_pretrained_start(args, device) -> dict:
    st = StepStatic(zoo=args.zoo, num_layers=args.num_layers,
                    height=args.height, width=args.width, dtype="float32")
    state = init_state(st, seed=0, device=device)
    sd = load_torch_state_dict(args.pretrained_start)
    print(f"{args.pretrained_start}: {len(sd)} tensors")

    resnet_backed = args.zoo in ("md2", "sql", "sql_large", "cadepth")
    pose_path = args.pose_weights or (args.pretrained_start if resnet_backed else None)
    load_pretrained_encoder(state.depth_net, state.pose_net, args.pretrained_start, args.zoo,
                            pose_path=pose_path)
    print("importer: encoder loaded into the depth network (keys and shapes checked)"
          + ("" if pose_path else "; pose encoder SKIPPED (pass a resnet18 "
             ".pth via --pose_weights to cover it)"))

    # key coverage against the reference-faithful replica layout
    ref = replica(args.zoo)
    if ref is not None:
        res = ref.load_state_dict(sd, strict=False)
        missing = [k for k in res.missing_keys if "num_batches" not in k]
        print(f"replica coverage: {len(sd) - len(res.unexpected_keys)}/{len(sd)} "
              f"file tensors consumed; {len(missing)} replica keys missing "
              f"(left at random init)")
        if missing:
            print("  missing:", missing[:10], "..." if len(missing) > 10 else "")
        if len(missing) > 0.05 * len(sd):
            print("FAIL: >5% of the architecture has no weights in this file")
            raise SystemExit(1)

    # finite forward of the whole depth network (the decoder is at its
    # random init: only finiteness is asserted)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, args.height, args.width, 3)).astype(np.float32))
    state.depth_net.eval()
    with torch.no_grad():
        disps = state.depth_net(x.to(device))
    for i, d in enumerate(disps):
        if not torch.isfinite(d).all():
            print(f"FAIL: non-finite disp at scale {i}")
            raise SystemExit(1)
    print("forward: finite disparities at all scales")
    out = {"tensors": len(sd)}

    # monovit: the port's MPViT against the replica on the same bytes
    if args.zoo == "monovit":
        ref.to(device).eval()
        x_nchw = x.permute(0, 3, 1, 2).contiguous().to(device)
        with torch.no_grad(), full_float32():
            t_outs = ref(x_nchw)
            p_outs = state.depth_net.encoder(x_nchw)
        worst = 0.0
        for i, (t, p) in enumerate(zip(t_outs, p_outs)):
            err = float((t - p).abs().max() / (t.abs().max() + 1e-6))
            worst = max(worst, err)
            print(f"  feature {i}: rel err {err:.2e}")
        status = "PASS" if worst < PARITY_TOL else "FAIL"
        print(f"{status}: monovit encoder forward parity on real bytes "
              f"(worst rel err {worst:.2e}, tol {PARITY_TOL:g})")
        if worst >= PARITY_TOL:
            raise SystemExit(1)
        out["worst_rel_err"] = worst
        return out
    print("PASS")
    return out


def main(argv=None, device="cuda") -> dict:
    device = require_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", help="reference weights_* folder")
    ap.add_argument("--pretrained_start", default=None,
                    help="raw encoder init .pth (mpvit_small / hrnetv2_w18 / "
                    "torchvision resnet): validate the importer on real "
                    "bytes without KITTI")
    ap.add_argument("--pose_weights", default=None,
                    help="resnet18 .pth for the pose encoder (defaults to "
                    "--pretrained_start for resnet-backed zoos)")
    ap.add_argument("--kt_path", default=None)
    ap.add_argument("--splits_dir", default="splits")
    ap.add_argument("--split", default="eigen")
    ap.add_argument(
        "--zoo", default="md2",
        choices=["md2", "monovit", "sql", "sql_large", "cadepth", "diffnet"],
    )
    ap.add_argument("--num_layers", type=int, default=18)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--expected_abs_rel", type=float, default=None)
    ap.add_argument("--tolerance", type=float, default=0.002)
    args = ap.parse_args(argv)

    if args.pretrained_start:
        return verify_pretrained_start(args, device)
    if not args.weights or not args.kt_path:
        ap.error("--weights and --kt_path are required (or use --pretrained_start)")

    cfg = Config()
    cfg.data.kt_path = args.kt_path
    cfg.data.splits_dir = args.splits_dir
    cfg.data.height = args.height
    cfg.data.width = args.width
    cfg.model.zoo = args.zoo
    cfg.model.num_layers = args.num_layers
    cfg.model.dtype = "float32"  # bit-parity evaluation

    st = StepStatic(zoo=args.zoo, num_layers=args.num_layers,
                    height=args.height, width=args.width, dtype="float32")
    state = init_state(st, seed=0, device=device)
    print(f"importing reference checkpoint from {args.weights}")
    IMPORTERS[args.zoo](args.weights, state.depth_net, state.pose_net)

    result = evaluate_kitti(cfg, state.depth_net, eval_split=args.split, device=device)
    print_metrics(result)

    if args.expected_abs_rel is not None:
        diff = abs(result["abs_rel"] - args.expected_abs_rel)
        status = "PASS" if diff <= args.tolerance else "FAIL"
        print(f"{status}: abs_rel {result['abs_rel']:.4f} vs expected "
              f"{args.expected_abs_rel:.4f} (|diff| {diff:.4f}, tol {args.tolerance})")
        if diff > args.tolerance:
            raise SystemExit(1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
