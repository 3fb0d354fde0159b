"""Where the port's training step spends its time on the GPU.

    python -m baseboostdepth_tpu_torch.profile_step [--stage late_F7|early_F2|both] [--steps 2]
        [--photo_impl xla|fused] [--warp_impl auto|corner|pallas] [--float_frames]
        [--zoo md2|monovit|cadepth|diffnet|sql|sql_large] [--num_layers 18]
        [--merged_warp auto|true|false]
        [--pose_input_scale 1.0]

Builds the main path as chip_smoke.py does (md2 ResNet-18, 640x192, batch
12, bf16 networks, random weights from seed 0, synthetic uint8 frames, pose
head biased to KITTI-scale motion), or another zoo or option of the step
(`--zoo`, md2's `--num_layers`, the warp schedule `--merged_warp`, auto as
ModelConfig resolves it: two calls for cadepth, merged otherwise; sql runs
scale 0 only, as its trainer does), runs two warm-up steps, then traces
`--steps` steps with torch.profiler and prints, per stage, one JSON line:
wall ms/step (synchronized host clock), device busy ms/step (the sum of
kernel times), the idle share, device time by kernel class, the top
kernels and the kernel launches per step. Kernel classes are read from
kernel names, so they are approximate. `--photo_impl` and `--warp_impl` set
the step's kernel options (StepStatic's defaults: xla, auto);
`--float_frames` feeds the frames as float32 in [0, 1] (the synthetic uint8
frames / 255), which the step warps with the float-planes kernels whatever
`--warp_impl` says. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from baseboostdepth_tpu_torch.config import ModelConfig
from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
from baseboostdepth_tpu_torch.training.batch import synthetic_batch
from baseboostdepth_tpu_torch.training.step import (
    MAIN_PATH_STAGES,
    init_state,
    main_path_static,
    make_train_step,
)

B = 12

# first matching substring wins
_CLASSES = (
    ("corner_sweep", ("corner_sweep",)),
    ("ssim_fused_fwd", ("ssim_fused_fwd",)),
    ("ssim_fused_bwd", ("ssim_fused_bwd",)),
    ("warp_packed_fwd", ("warp_packed_fwd",)),
    ("warp_packed_bwd", ("warp_packed_bwd",)),
    ("warp_planes_fwd", ("warp_planes_fwd",)),
    ("warp_planes_bwd", ("warp_planes_bwd",)),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop", "nhwc")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("gemm", ("gemm", "cutlass")),
    ("pool / pad / resize", ("pool", "reflection", "upsample", "pad")),
    ("gather / index / scatter", ("gather", "index", "scatter")),
    ("reduce", ("reduce",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("copy / fill / cat", ("copy", "memcpy", "memset", "fill", "cat", "catarray")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in _CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_stage(stage: str, steps: int, float_frames: bool = False, **options) -> dict:
    if options.get("zoo") in ("sql", "sql_large"):
        options["scales"] = (0,)
    st = main_path_static(stage, **options)
    state = init_state(st, seed=0, device="cuda", steps_per_epoch=3317)
    realistic_pose_bias_(state.pose_net)
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in synthetic_batch(st.F, B, st.height, st.width, seed=st.F).items()}
    if float_frames:
        batch["frames"] = batch["frames"].float() / 255.0
    step = make_train_step(st, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(2):
        step(state, batch, generator=gen)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    kernels, launches = {}, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            launches += evt.count
    busy_ms = sum(kernels.values()) / 1e3 / steps
    classes = {}
    for name, us in kernels.items():
        cls = _kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + us / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "stage": stage, "zoo": st.zoo, "num_layers": st.num_layers,
        "merged_warp": st.merged_warp, "pose_input_scale": st.pose_input_scale,
        "F": st.F, "scales": list(st.scales), "steps_traced": steps,
        "photo_impl": st.photo_impl, "warp_impl": st.warp_impl, "float_frames": float_frames,
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "ms_per_step_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [[name[:90], us / 1e3 / steps] for name, us in top],
        "distinct_kernels": len(kernels),
        "kernel_launches_per_step": launches / steps,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=[*MAIN_PATH_STAGES, "both"], default="both")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--photo_impl", choices=["xla", "fused"], default="xla")
    ap.add_argument("--warp_impl", choices=["auto", "corner", "pallas"], default="auto")
    ap.add_argument("--float_frames", action="store_true",
                    help="feed float32 frames (uint8 / 255): the float-planes warp")
    ap.add_argument("--zoo", choices=["md2", "monovit", "cadepth", "diffnet", "sql", "sql_large"],
                    default="md2")
    ap.add_argument("--num_layers", type=int, default=18, help="md2's ResNet depth")
    ap.add_argument("--merged_warp", choices=["auto", "true", "false"], default="auto")
    ap.add_argument("--pose_input_scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    merged = ModelConfig(zoo=args.zoo, merged_warp=None if args.merged_warp == "auto"
                         else args.merged_warp == "true").resolved_merged_warp()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    stages = list(MAIN_PATH_STAGES) if args.stage == "both" else [args.stage]
    for stage in stages:
        out = profile_stage(stage, args.steps, float_frames=args.float_frames,
                            photo_impl=args.photo_impl, warp_impl=args.warp_impl, zoo=args.zoo,
                            num_layers=args.num_layers, merged_warp=merged,
                            pose_input_scale=args.pose_input_scale)
        out["card"] = card
        print(json.dumps(out))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
