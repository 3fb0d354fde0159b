"""Where the port's training step spends its time on the GPU.

    python -m baseboostdepth_tpu_torch.profile_step [--stage late_F7|early_F2|both] [--steps 2]
        [--photo_impl xla|fused] [--warp_impl auto|corner|pallas] [--float_frames]
        [--zoo md2|monovit|cadepth|diffnet|sql|sql_large] [--num_layers 18]
        [--merged_warp auto|true|false]
        [--pose_input_scale 1.0] [--batch 12]

    python -m torch.distributed.run --nproc_per_node 4 \
        -m baseboostdepth_tpu_torch.profile_step --dist [--batch 12] [--check] [...]

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
`--warp_impl` says. `--batch` is the global batch. Needs a CUDA device.

With `--dist`, under torch.distributed.run (one process per GPU, NCCL),
every rank runs the step on its rows of the global batch, and rank 0 prints
one JSON line per stage with each rank's figures: ms/step, device busy and
idle, and the NCCL kernels a step, split into the gradient all-reduce (the
last `gradient buckets` NCCL kernels of each step, after the backward) and
the BatchNorm all-reduces (one in the forward and one in the backward of
each train-mode BN call), each with its count and device ms. `--check`
first holds a float32 step (TF32 off) of the W ranks against the
one-process step on the global batch, which rank 0 computes before it
joins the group: the global loss, every averaged gradient, the BN
statistics, and the ranks' parameters bit-equal.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from baseboostdepth_tpu_torch.config import ModelConfig
from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
from baseboostdepth_tpu_torch.parallel import sharding
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
    ("nccl (all-reduce, wait for the other ranks included)", ("nccl",)),
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


def main_path_state(st, device, batch: int, float_frames: bool = False):
    """The state (seed 0, pose head biased to KITTI-scale motion; rank 0's
    on every rank) and this process's rows of the synthetic global batch of
    `batch` samples, on `device`."""
    state = init_state(st, seed=0, device=device, steps_per_epoch=3317)
    realistic_pose_bias_(state.pose_net)
    sharding.broadcast_state_([state.depth_net, state.pose_net])
    rows = {k: sharding.local_rows(torch.as_tensor(v)).to(device)
            for k, v in synthetic_batch(st.F, batch, st.height, st.width, seed=st.F).items()}
    if float_frames:
        rows["frames"] = rows["frames"].float() / 255.0
    return state, rows


def _is_annotation(name: str) -> bool:
    """A device-side range the profiler records beside each NCCL kernel
    (`nccl:all_reduce`, as long as the kernel): not a kernel of its own."""
    return name.startswith("nccl:")


def _nccl_split(prof, steps: int, n_buckets: int) -> dict:
    """NCCL kernels a step from a trace of `steps` steps, in time order; the
    last n_buckets of each step are the gradient all-reduce (it follows the
    backward), the others BatchNorm's. A kernel's time includes its wait
    for the slowest rank."""
    nccl = sorted((e for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                   and "nccl" in e.name.lower() and not _is_annotation(e.name)),
                  key=lambda e: e.time_range.start)
    out = {"nccl_kernels_per_step": len(nccl) / steps,
           "nccl_ms_per_step": sum(e.time_range.elapsed_us() for e in nccl) / 1e3 / steps}
    if not nccl or len(nccl) % steps:
        return out
    per = len(nccl) // steps
    grad_ms = bn_ms = 0.0
    for i in range(steps):
        chunk = nccl[i * per:(i + 1) * per]
        grad_ms += sum(e.time_range.elapsed_us() for e in chunk[per - n_buckets:]) / 1e3
        bn_ms += sum(e.time_range.elapsed_us() for e in chunk[:per - n_buckets]) / 1e3
    out.update(grad_all_reduce_ms_per_step=grad_ms / steps,
               bn_all_reduce_kernels_per_step=per - n_buckets,
               bn_all_reduce_ms_per_step=bn_ms / steps)
    return out


def profile_stage(stage: str, steps: int, float_frames: bool = False, batch: int = B,
                  **options) -> dict:
    if options.get("zoo") in ("sql", "sql_large"):
        options["scales"] = (0,)
    st = main_path_static(stage, **options)
    device = torch.device("cuda", torch.cuda.current_device())
    state, rows = main_path_state(st, device, batch, float_frames)
    step = make_train_step(st, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(2):
        step(state, rows, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the same steps without the profiler
    for _ in range(steps):
        step(state, rows, generator=gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    bn_calls = sharding.all_reduce_sum.calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, rows, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    bn_calls = (sharding.all_reduce_sum.calls - bn_calls) / steps

    kernels, launches = {}, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if (us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not _is_annotation(evt.key)):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
            launches += evt.count
    busy_ms = sum(kernels.values()) / 1e3 / steps
    classes = {}
    for name, us in kernels.items():
        cls = _kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + us / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    world = {}
    if sharding.world_size() > 1:
        params = [*state.depth_net.parameters(), *state.pose_net.parameters()]
        n_buckets = len(sharding.gradient_buckets(params))
        world = {"rank": sharding.rank(), "world_size": sharding.world_size(),
                 "local_batch": rows["frames"].shape[0], "gradient_buckets": n_buckets,
                 "gradient_mb": sum(p.grad.numel() * 4 for p in params
                                    if p.grad is not None) / 2**20,
                 "bn_all_reduce_calls_per_step": {"forward": bn_calls, "backward": bn_calls},
                 **_nccl_split(prof, steps, n_buckets)}
        # NCCL kernels spin while they wait for the other ranks
        world["idle_share_excluding_nccl"] = max(
            0.0, 1.0 - (busy_ms - world["nccl_ms_per_step"]) / wall_ms)
    return {
        "stage": stage, "zoo": st.zoo, "num_layers": st.num_layers, "global_batch": batch,
        "ms_per_step": step_ms, "images_per_s": batch / step_ms * 1e3, **world,
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


def float32_step(stage: str, batch: int) -> dict:
    """One float32 step (TF32 off) of a main-path stage on this process's
    rows of the global batch, on the current GPU: the global loss, the
    averaged gradients, and the parameters and BN statistics after it,
    named."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = main_path_static(stage, dtype="float32")
    device = torch.device("cuda", torch.cuda.current_device())
    state, rows = main_path_state(st, device, batch)
    metrics = make_train_step(st, device=device)(
        state, rows, generator=torch.Generator(device=device).manual_seed(1))
    nets = (("depth", state.depth_net), ("pose", state.pose_net))
    return {
        "loss": float(sharding.all_reduce_mean([metrics["loss"]])[0]),
        "grads": {f"{k}.{n}": p.grad for k, m in nets for n, p in m.named_parameters()
                  if p.grad is not None},
        "params": {f"{k}.{n}": p.detach() for k, m in nets for n, p in m.named_parameters()},
        "stats": {f"{k}.{n}": b for k, m in nets for n, b in m.named_buffers()
                  if "running_" in n},
    }


def replicas_equal(tensors) -> bool:
    """Whether every rank holds rank 0's tensors bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    lead = flat.clone()
    dist.broadcast(lead, 0)
    differs = torch.tensor([float(not torch.equal(lead, flat))], device=flat.device)
    return float(sharding.all_reduce_mean([differs])[0]) == 0.0


def hold_to_reference(got: dict, ref: dict) -> dict:
    """The W-rank float32 step against the one-process one: the loss to 1e-5
    relative; the whole gradient to 5e-2 relative L2 and each gradient
    tensor to 1.5e-1 relative L2 + 1e-7 RMS; BN statistics to 1e-4
    relative + 1e-5 of the tensor's largest entry. The gradient bounds are
    wide because the step's gradient on the synthetic white-noise frames
    is sensitive to rounding: the batch statistics and gradient sums run
    in another order, which moves the min over candidates and the warp's
    floor at a few of the 1.5 M pixels, each a jump of a random texel
    difference (on one H100, changing only BN's variance formula in one
    process moved the whole gradient by 1.7% and a tensor by 2.3%; chip_smoke.py
    prints that baseline). A missing all-reduce moves it by tens of
    percent. Returns the measured figures, the six tensors furthest off,
    and whether all held."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    ok = loss_rel <= 1e-5 and got["grads"].keys() == ref["grads"].keys()
    leaves, stats, diff2, norm2 = [], 0.0, 0.0, 0.0
    for n, r in ref["grads"].items():
        d = (got["grads"][n].double() - r.double()).abs()
        err, norm = float(d.norm()), float(r.double().norm())
        diff2, norm2 = diff2 + err**2, norm2 + norm**2
        ok &= err <= 1.5e-1 * norm + 1e-7 * r.numel() ** 0.5
        leaves.append((err / max(norm, 1e-30), n, err, norm, float(d.max()),
                       float(r.abs().max()), r.numel()))
    whole = (diff2 / norm2) ** 0.5
    ok &= whole <= 5e-2
    for n, r in ref["stats"].items():
        d = (got["stats"][n] - r).abs()
        ok &= bool((d <= 1e-4 * r.abs() + 1e-5 * r.abs().max()).all())
        stats = max(stats, float(d.max() / r.abs().max()))
    worst = sorted(leaves, reverse=True)[:6]
    return {"loss": got["loss"], "loss_reference": ref["loss"], "loss_rel": loss_rel,
            "grad_rel_l2": whole,
            "grad_worst_tensors": [dict(zip(("rel_l2", "name", "diff_l2", "l2", "diff_max",
                                             "max", "size"), w)) for w in worst],
            "stats_max_over_tensor_max": stats, "ok": bool(ok)}


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main_dist(args, stages, options) -> int:
    """--dist: one process per GPU under torch.distributed.run."""
    ref = None
    if args.check and int(os.environ.get("RANK", "0")) == 0:
        ref = float32_step("late_F7", args.batch)  # one process, before the group exists
    sharding.initialize_distributed(device="cuda")
    try:
        ok = True
        card = card_name()
        cards = [None] * sharding.world_size()
        dist.all_gather_object(cards, card)
        if args.check:
            got = float32_step("late_F7", args.batch)
            same = replicas_equal([*got["params"].values(), *got["stats"].values(),
                                   *got["grads"].values()])
            if sharding.is_lead():
                check = {"check": "late_F7 float32, TF32 off, W ranks vs one process",
                         "global_batch": args.batch, "world_size": sharding.world_size(),
                         "replicas_bit_equal": same, **hold_to_reference(got, ref)}
                check["ok"] &= same
                ok &= check["ok"]
                print(json.dumps(check))
            del got, ref
            torch.cuda.empty_cache()
        for stage in stages:
            out = profile_stage(stage, args.steps, float_frames=args.float_frames,
                                batch=args.batch, **options)
            out["card"] = card
            outs = [None] * sharding.world_size()
            dist.all_gather_object(outs, out)
            if sharding.is_lead():
                v = torch.cuda.nccl.version()
                print(json.dumps({"stage": stage, "backend": dist.get_backend(),
                                  "nccl_version": v if isinstance(v, int) else
                                  ".".join(map(str, v)),
                                  "cards": cards, "ranks": outs}))
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


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
    ap.add_argument("--batch", type=int, default=B, help="the global batch")
    ap.add_argument("--dist", action="store_true",
                    help="one process per GPU, under torch.distributed.run")
    ap.add_argument("--check", action="store_true",
                    help="with --dist: first hold a float32 step to the one-process step")
    args = ap.parse_args(argv)
    merged = ModelConfig(zoo=args.zoo, merged_warp=None if args.merged_warp == "auto"
                         else args.merged_warp == "true").resolved_merged_warp()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    stages = list(MAIN_PATH_STAGES) if args.stage == "both" else [args.stage]
    options = dict(photo_impl=args.photo_impl, warp_impl=args.warp_impl, zoo=args.zoo,
                   num_layers=args.num_layers, merged_warp=merged,
                   pose_input_scale=args.pose_input_scale)
    if args.dist:
        return main_dist(args, stages, options)
    card = card_name()
    print(card)
    for stage in stages:
        out = profile_stage(stage, args.steps, float_frames=args.float_frames,
                            batch=args.batch, **options)
        out["card"] = card
        print(json.dumps(out))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
