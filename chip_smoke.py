"""Smoke run of the PyTorch port (baseboostdepth_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from ops/csrc/ (first use; the four libraries
     in parallel), prints ptxas' register report and lists the kernels
     built; holds each kernel whose grid puts the images on its z axis
     (corner sweep, packed warp, float-planes warp, fused SSIM) against its
     plain version at 65,537 tiny images, two launches each;
  3. holds the corner-sweep kernel against its plain PyTorch version at the
     main path's full shape (156 warps of 192x640 frames): corner planes
     exactly equal, the blended warp and its grid gradient against the plain
     float warp;
  4. holds the fused SSIM forward and backward kernels against their plain
     versions (forward exactly equal) at the main path's photometric shapes
     (84, 72, 60 and 48 images of 192x640), at ragged shapes and on inputs
     whose data pointers are not 16-byte aligned, each with a region where
     prediction and target are tied; times both at N=84 and N=60; the packed
     warp's forward and backward kernels against theirs and against the
     corner-plane warp at the shape of step 3; then the three uint8 warp
     kernels (corner sweep, packed forward and backward) against their
     plain versions at ragged shapes (odd W, W=1, H=1, Ho/Wo other than
     H/W), on frames 1-3 bytes and coordinates 4 bytes off 16-byte
     alignment, with exact-border points, and timed on the white-noise grid
     of step 3 and on the grids one late (N=156) and one early (N=108) step
     hand to them, captured from the step's own forward pass, each beside
     its bound from the distinct texels that grid names;
  5. holds the float-planes warp's forward and backward kernels against
     their plain versions on the same frames as float32 (/ 255) and grid,
     and on a small two-channel case; the forward against the packed warp,
     the grid gradient against F.grid_sample's; then exactly at ragged
     shapes (C = 1-4, W = 1, Ho = 1, W and Wo not multiples of 4), on
     sources, coordinates and cotangents off 16-byte alignment, with the
     last texel of the tensor named, and timed on the same three grids as
     the uint8 warps, each beside its distinct-texel bound;
  6. runs the capability-probe tool (the seven probes of
     tools/pallas_probe.py) through its entry point, counting the four probe
     kernels' launches, then holds each kernel against its plain version and
     the JAX tool's numpy references exactly, on wrapped and out-of-range
     indices and clamped slice starts too, and times each (launch-bound at
     these shapes);
  7. checks the step on a small input against the same step on the CPU,
     with the default options, with photo_impl="fused", warp_impl="pallas",
     with float frames, with md2 ResNet-50, with CADepth (the two-call warp
     schedule), with SQLdepth (128x512, dropout off), with MonoViT
     (drop-path off) and with DIFFNet; then MonoViT's drop-path on the card:
     the same generator seed gives the same train-mode output, another seed
     another;
  8. trains the md2 main path at full width (640x192, batch 12, bf16
     networks): 3 steps of the late stage (F=7, scale 0, tri-min +
     incremental + partial + decomp, merged warp) and 2 of the early stage
     (F=2, scales 0-3, direct poses), with the default options, with
     photo_impl="fused", warp_impl="pallas", and with float frames (the
     float-planes warp); then the same two stages with md2 ResNet-50, with
     CADepth at its default two-call warp schedule (two corner_sweep
     launches a scale; the late stage also with the fused and packed
     kernels) and with SQLdepth (scale 0 only), the late stage with
     pose_input_scale=0.5, then the same two stages with MonoViT (its
     two-group AdamW; the late stage also with the fused and packed
     kernels) and with DIFFNet, both merged; finite losses, moving
     parameters and BN statistics, and every kernel's launches counted in
     each run and held to the counts the step's structure implies;
  9. writes KITTI-raw, SYNS and KITTI-odometry trees of random images at
     their published sizes under build/, exports the SYNS GT (cli.export_gt,
     test and val), and runs the training entry point (cli.train): one
     epoch at the default configuration, ending in a checkpoint, then again
     with two epochs, which must resume from it, then a third epoch with
     SYNS validation and image panels on; one epoch each of
     --model.zoo cadepth, sql, monovit (whose checkpoint must hold the
     depth encoder's AdamW group at optim.vit_encoder_lr) and diffnet;
     prints which JPEG decoder the
     loader took (the native one where g++ and libjpeg build it, else PIL),
     times the loader alone with each decoder available, and holds every
     batch of an epoch that the trainer's device prefetcher sends to the
     card against its host batch byte for byte;
 10. runs the evaluation and inference entry points on that checkpoint:
     cli.evaluate_depth (eigen mono with --save_pred_disps, then
     --ext_disp_to_eval on the saved stack, which must reproduce it
     exactly; the same on the sql checkpoint, whose stack is metric depth
     at H/2; eigen mono on the monovit checkpoint; --post_process;
     --stereo; SYNS with --chamfer at full SYNS
     size), cli.evaluate_pose, cli.infer on a folder and cli.visualize;
     times predict_disparities and the chamfer search, and holds the card's
     chamfer distances against the CPU's;
 11. data parallelism (--dist.enabled): two ranks on the one card in a
     gloo group with CUDA tensors (NCCL refuses two ranks on one device),
     each started as `chip_smoke.py --dist-child ...` at the main path's
     full width (global batch 12, 6 a rank): a float32 late step held to
     the one-process step on the global batch (loss, every averaged
     gradient, BN statistics) and the ranks' parameters, statistics and
     gradients bit-equal, then bf16 late and early steps timed, each rank's
     kernel launches held to the step's counts; then cli.train
     --dist.enabled under torch.distributed.run with one process (NCCL):
     one epoch and a resumed second, checkpoints from the lead; prints the
     NCCL version;
 12. prints timings (CUDA events, after warm-up) beside the card's name and
     power limit, a JSON line describing each kernel, and last
     {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
Without a GPU, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
H, W, B = 192, 640, 12
PROBE_KERNELS = ("probe_scale", "probe_gather_rows", "probe_gather_cols", "probe_row_slice")
KERNELS = ("corner_sweep", "ssim_fused_fwd", "ssim_fused_bwd", "warp_packed_fwd",
           "warp_packed_bwd", "warp_planes_fwd", "warp_planes_bwd", *PROBE_KERNELS)
FUSED = dict(photo_impl="fused", warp_impl="pallas")
# the zoos and options beside md2 ResNet-18's defaults, as StepStatic fields:
# cadepth at its default, the two-call warp schedule; sql at scale 0 only,
# as its trainer runs it
RN50 = dict(num_layers=50)
CADEPTH = dict(zoo="cadepth", merged_warp=False)
SQL = dict(zoo="sql", scales=(0,))
POSE_HALF = dict(pose_input_scale=0.5)
MONOVIT = dict(zoo="monovit")
DIFFNET = dict(zoo="diffnet")

# float32 operations per pixel, counted in the kernels' source (adds,
# multiplies, divides, compares; an FMA counts 2; index arithmetic not
# counted). SSIM forward, per channel: 19 for the row sums of x, y, x^2,
# y^2, xy (once per row: they slide down the strip), 5 to carry them, 10 for
# the window means, 6 for the variances, 13 for SSIM's numerator and
# denominator, 5 for the divide and clip, 7 for L1 and the weighted sum.
# SSIM backward, per channel: the same 40 up to the variances and 13 for
# the numerator and denominator, 23 for the mask and M, S1, S2, 24 for the
# separable adjoint (3 + 3 weighted three-tap sums, as FMAs), 10 for the
# final combination. Packed warp: per channel 16 to unpack four texels and
# 9 to blend (forward) or 14 for the two coordinate derivatives and their
# sums (backward), plus 4 for the weights. Corner sweep: the two floors.
# Float-planes warp: per channel 9 to blend (forward) or 14 (backward), plus
# 4 for the weights.
OPS_PER_PIXEL = {"corner_sweep": 2, "ssim_fused_fwd": 3 * 65, "ssim_fused_bwd": 3 * 110,
                 "warp_packed_fwd": 3 * 25 + 4, "warp_packed_bwd": 3 * 30 + 4,
                 "warp_planes_fwd": 3 * 9 + 4, "warp_planes_bwd": 3 * 14 + 4}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean milliseconds of fn() over `iters` runs, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(name, bytes_moved, pixels):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the kernel's float32 operations over the float32 peak."""
    ms_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    ms_ops = OPS_PER_PIXEL[name] * pixels / FP32_OPS_PER_S * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def kernel_wrappers():
    from baseboostdepth_tpu_torch.ops import probe_cuda as pc
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops import warp_planes as wp

    return {"corner_sweep": wc.corner_sweep, "ssim_fused_fwd": sc.ssim_fused_fwd,
            "ssim_fused_bwd": sc.ssim_fused_bwd, "warp_packed_fwd": wc.warp_packed_fwd,
            "warp_packed_bwd": wc.warp_packed_bwd, "warp_planes_fwd": wp.warp_planes_fwd,
            "warp_planes_bwd": wp.warp_planes_bwd,
            **{name: getattr(pc, name) for name in PROBE_KERNELS}}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {n: fn.launches for n, fn in kernel_wrappers().items()}


def build():
    """Build the kernel libraries at once, one nvcc each; print ptxas'
    report of each."""
    from baseboostdepth_tpu_torch.ops import cuda_build
    from baseboostdepth_tpu_torch.ops import probe_cuda as pc
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops import warp_planes as wp

    mods = (wc, sc, wp, pc)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        for f in [pool.submit(mod._lib) for mod in mods]:
            f.result()
    build_s = time.perf_counter() - t0
    for mod in mods:
        for line in cuda_build.build_log(mod.LIB_NAME, mod.SOURCES).splitlines():
            if ("ptxas info" in line and ("registers" in line or "Compiling" in line)
                    or "spill" in line):
                print("build:", line.strip())
    print(f"built kernels: {json.dumps(list(KERNELS))} ({build_s:.1f} s incl. load, "
          f"{len(mods)} libraries built in parallel)")


def noise_grid(torch) -> dict:
    """The white-noise grid at the main path's warp shape (156 uint8 frames
    of 192x640, 12 samples x 13 merged slots): random frames, KITTI-scale
    displacement around the identity grid (plus or minus 40 x 10 px); ~10%
    of points land outside the image, and some exactly on its borders. Its
    normalized grid, clamped pixel coordinates x, y and a cotangent ct."""
    from baseboostdepth_tpu_torch.ops import clip

    dev = torch.device("cuda", 0)
    N = B * 13  # late stage: 2S-1 = 13 merged slots per sample
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (N, H, W, 3), dtype=torch.uint8, device=dev, generator=gen)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    px = xx + (torch.rand((N, H, W), device=dev, generator=gen) - 0.5) * 80.0
    py = yy + (torch.rand((N, H, W), device=dev, generator=gen) - 0.5) * 20.0
    grid = torch.stack([2.0 * px / (W - 1) - 1.0, 2.0 * py / (H - 1) - 1.0], dim=-1)
    pick = torch.rand((N, H, W, 2), device=dev, generator=gen)
    grid = torch.where(pick < 0.02, -1.0, torch.where(pick > 0.98, 1.0, grid)).contiguous()
    x = clip((grid[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1).contiguous()
    y = clip((grid[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1).contiguous()
    check(bool((x == 0).any() and (x == W - 1).any() and (y == 0).any() and (y == H - 1).any()),
          "grid lacks exact-border points")
    ct = torch.rand((N, H, W, 3), device=dev, generator=gen)
    return dict(frames=frames, grid=grid, x=x, y=y, ct=ct)


def kernel_phase(torch, card):
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops.sampling import bilinear_sample

    inp = noise_grid(torch)
    frames, grid, x, y, ct = (inp[n] for n in ("frames", "grid", "x", "y", "ct"))
    N = frames.shape[0]

    # corner planes: kernel vs plain version, exactly
    c_kernel = wc.corner_sweep(frames, x, y)
    c_plain = wc.corner_sweep_reference(frames, x, y)
    torch.cuda.synchronize()
    check(c_kernel.shape == (N, 4, H, W) and c_kernel.dtype == torch.int32, "corner plane shape")
    max_err = int((c_kernel.long() - c_plain.long()).abs().max())
    check(torch.equal(c_kernel, c_plain), f"corner planes differ from the plain version ({max_err})")
    print(f"kernel check: corner planes exactly equal to the plain version at N={N} {H}x{W}")

    # blend + grid gradient: kernel path vs the plain float warp
    g1 = grid.clone().requires_grad_(True)
    g2 = grid.clone().requires_grad_(True)
    out_k = wc.bilinear_sample_corner_u8(frames, g1)
    out_p = bilinear_sample(frames.float() / 255.0, g2)
    (out_k * ct).sum().backward()
    (out_p * ct).sum().backward()
    blend_err = float((out_k - out_p).detach().abs().max())
    grad_err = float((g1.grad - g2.grad).abs().max() / g2.grad.abs().max())
    check(blend_err <= 1e-6, f"blended warp differs from the plain warp by {blend_err}")
    check(grad_err <= 1e-6, f"grid gradient differs from the plain warp by {grad_err} (relative)")
    print(f"kernel check: blend max abs err {blend_err:.3e}, grid grad max err {grad_err:.3e} "
          "relative to its largest value")

    # timings at the main path's shape (the kernel's own: warp_grid_phase)
    ms_plain = time_ms(torch, lambda: wc.corner_sweep_reference(frames, x, y))

    def corner_fwd_bwd():
        g = grid.detach().requires_grad_(True)
        (wc.bilinear_sample_corner_u8(frames, g) * ct).sum().backward()

    ms_corner_fb = time_ms(torch, corner_fwd_bwd)
    frames_f = frames.permute(0, 3, 1, 2).float().div(255.0).contiguous()
    ct_nchw = ct.permute(0, 3, 1, 2)

    def grid_sample_fwd():
        torch.nn.functional.grid_sample(frames_f, grid, mode="bilinear", padding_mode="border",
                                        align_corners=True)

    def grid_sample_fwd_bwd():
        g = grid.detach().requires_grad_(True)
        out = torch.nn.functional.grid_sample(frames_f, g, mode="bilinear",
                                              padding_mode="border", align_corners=True)
        (out * ct_nchw).sum().backward()

    def grid_sample_grid_grad():  # the grid gradient alone (bilinear 0, border 1)
        torch.ops.aten.grid_sampler_2d_backward(ct_nchw, frames_f, grid, 0, 1, True,
                                                [False, True])

    ms_gs = time_ms(torch, grid_sample_fwd)
    ms_gs_fb = time_ms(torch, grid_sample_fwd_bwd)
    ms_gs_bwd = time_ms(torch, grid_sample_grid_grad)
    del frames_f
    print(f"timing corner_sweep plain version: {ms_plain:.4f} ms [{card}]")
    print(f"timing corner warp fwd+bwd (kernel + blend + autodiff): {ms_corner_fb:.4f} ms [{card}]")
    print(f"timing F.grid_sample fwd: {ms_gs:.4f} ms, fwd+bwd: {ms_gs_fb:.4f} ms, "
          f"grid gradient alone (grid_sampler_2d_backward): {ms_gs_bwd:.4f} ms [{card}]")
    stats = {
        "max_abs_err": max_err, "plain_ms": ms_plain, "library_ms": ms_gs,
        "library_call": "F.grid_sample(bilinear, border, align_corners=True) forward, float32 "
                        "frames, same grid (the blended warp, not the corner planes)",
        "blend_max_abs_err": blend_err, "grid_grad_max_rel_err": grad_err,
        "corner_fwd_bwd_ms": ms_corner_fb, "grid_sample_fwd_bwd_ms": ms_gs_fb,
        "grid_sample_grid_grad_ms": ms_gs_bwd,
    }
    return stats, inp


# (N, H, W) of the SSIM checks: the main path's late (12 samples x 7 and x 6
# slots) and early (x 5, x 4) shapes, then ragged ones: W % 4 != 0, the
# minimum image, H and W one past a multiple of the tiles, H not a multiple
# of the strip height, several strips and tiles
SSIM_SHAPES = ((B * 7, H, W), (B * 6, H, W), (B * 5, H, W), (B * 4, H, W), (3, 17, 29),
               (1, 2, 2), (2, 193, 641), (4, 75, 300))
# shapes whose pred, target, g start 1, 2, 3 floats into a larger buffer:
# data pointers off 16-byte alignment
SSIM_MISALIGNED = ((6, H, W), (3, 40, 101))
SSIM_TIMED = (B * 7, B * 5)  # the late and early main-slot calls


def ssim_inputs(torch, shape, seed, offsets=(0, 0, 0)):
    """(pred, target, g) at shape (N, H, W) and the tied block's size:
    a textured target (3x3-smoothed noise) and a warped-like prediction, the
    target shifted by one pixel plus noise, equal to it on the top-left
    quarter (a static region: q = 0 over whole windows) that meets the
    image's corner, where the reflect fold acts. Each tensor is a contiguous
    view `offset` floats into a buffer of its own."""
    dev = torch.device("cuda", 0)
    n, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.rand((n, 3, h, w), device=dev, generator=gen)
    tgt = torch.nn.functional.avg_pool2d(noise, 3, 1, 1, count_include_pad=False)
    tgt = tgt.permute(0, 2, 3, 1)
    pred = torch.roll(tgt, 1, dims=2) + 0.05 * torch.randn(tgt.shape, device=dev, generator=gen)
    pred = pred.clamp(0.0, 1.0)
    tie = (h // 4, w // 4)
    pred[:, :tie[0], :tie[1]] = tgt[:, :tie[0], :tie[1]]
    g = torch.rand((n, h, w, 1), device=dev, generator=gen)

    def placed(x, offset):
        buf = torch.empty(x.numel() + offset, device=dev)
        return buf[offset:].view(x.shape).copy_(x)

    return tuple(placed(x, o) for x, o in zip((pred, tgt, g), offsets)), tie


def ssim_checks(torch):
    """Both SSIM kernels against their plain versions at SSIM_SHAPES and
    SSIM_MISALIGNED: the forward exactly equal, the backward within 1e-4 of
    its largest entry and exactly 0 inside the tied block."""
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc

    cases = [(s, (0, 0, 0)) for s in SSIM_SHAPES] + [(s, (1, 2, 3)) for s in SSIM_MISALIGNED]
    results = []
    for seed, (shape, offsets) in enumerate(cases):
        (pred, tgt, g), (th, tw) = ssim_inputs(torch, shape, seed, offsets)
        label = f"{shape}" + (f" at float offsets {offsets}" if any(offsets) else "")
        if any(offsets):
            check(all(t.data_ptr() % 16 for t in (pred, tgt, g)), f"{label}: aligned inputs")
        out_k = sc.ssim_fused_fwd(pred, tgt)
        out_p = sc.ssim_fused_fwd_reference(pred, tgt)
        gx_k = sc.ssim_fused_bwd(pred, tgt, g)
        gx_p = sc.ssim_fused_bwd_reference(pred, tgt, g)
        torch.cuda.synchronize()
        check(out_k.shape == (*shape, 1) and gx_k.shape == (*shape, 3), f"{label}: SSIM shapes")
        check(bool(torch.isfinite(out_k).all() and torch.isfinite(gx_k).all()),
              f"{label}: SSIM non-finite")
        fwd_err = float((out_k - out_p).abs().max())
        check(torch.equal(out_k, out_p), f"{label}: SSIM forward differs from its plain "
                                         f"version by {fwd_err}")
        diff = (gx_k - gx_p).abs()
        bwd_err = float(diff.max())
        bwd_rel = bwd_err / float(gx_p.abs().max())
        if bwd_rel > 1e-4:
            at = [int(v) for v in torch.nonzero(diff == diff.max())[0]]
            check(False, f"{label}: SSIM backward differs from its plain version by {bwd_rel} "
                         f"(relative) at {at}")
        # inside the tied block every window has q = 0 (inactive) and x = y
        tied = None
        if th >= 5 and tw >= 5:
            tied = float(gx_k[:, 2:th - 2, 2:tw - 2].abs().max())
            check(tied == 0.0, f"{label}: SSIM backward inside the tied block: {tied}, "
                               "expected 0")
        results.append({"shape": list(shape), "offsets": list(offsets), "fwd_equal": True,
                        "bwd_max_abs_err": bwd_err, "bwd_max_rel_err": bwd_rel,
                        "tied_block_zero": tied is not None})
        print(f"kernel check: ssim_fused_fwd equal to its plain version, ssim_fused_bwd max abs "
              f"err {bwd_err:.3e} ({bwd_rel:.3e} of its largest value)"
              f"{', tied block gradient 0' if tied is not None else ''}, at {label}")
        del pred, tgt, g, out_k, out_p, gx_k, gx_p, diff
    torch.cuda.empty_cache()
    return results


def ssim_phase(torch, card):
    """The fused SSIM kernels against their plain versions (ssim_checks),
    then timed at the late and early main-slot shapes (N = 84 and 60 images
    of 192x640)."""
    from baseboostdepth_tpu_torch.ops import ssim as ts
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc

    checks = ssim_checks(torch)
    late = checks[0]
    by_n = {}
    for n in SSIM_TIMED:
        (pred, tgt, g), _ = ssim_inputs(torch, (n, H, W), 0)
        pixels = n * H * W
        row = {}
        for name, fn, nbytes in (
                ("ssim_fused_fwd", lambda: sc.ssim_fused_fwd(pred, tgt), pixels * (12 + 12 + 4)),
                ("ssim_fused_bwd", lambda: sc.ssim_fused_bwd(pred, tgt, g),
                 pixels * (12 + 12 + 4 + 12))):
            ms = time_ms(torch, fn)
            b = bound(name, nbytes, pixels)
            row[name] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1], "bytes": nbytes,
                         "gb_per_s": nbytes / ms / 1e6, "share_of_bound": b[0] / ms}
            print(f"timing {name} kernel at N={n} {H}x{W}: {ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.0f} GB/s, {b[0] / ms:.1%} of its {b[1]} bound "
                  f"{b[0]:.4f} ms [{card}]")
        by_n[n] = row
        if n != SSIM_TIMED[0]:
            del pred, tgt, g
            continue
        ms_fwd_plain = time_ms(torch, lambda: sc.ssim_fused_fwd_reference(pred, tgt), iters=5)
        ms_bwd_plain = time_ms(torch, lambda: sc.ssim_fused_bwd_reference(pred, tgt, g), iters=5)

        def fwd_bwd(fn):
            def run():
                p = pred.detach().requires_grad_(True)
                (fn(p, tgt) * g).sum().backward()
            return run

        ms_fused_fb = time_ms(torch, fwd_bwd(sc.reprojection_loss_fused))
        ms_xla = time_ms(torch, lambda: ts.reprojection_loss(pred, tgt), iters=5)
        ms_xla_fb = time_ms(torch, fwd_bwd(ts.reprojection_loss), iters=5)
        print(f"timing plain versions at N={n}: ssim_fused_fwd_reference {ms_fwd_plain:.4f} ms, "
              f"ssim_fused_bwd_reference {ms_bwd_plain:.4f} ms [{card}]")
        print(f"timing fused photometric loss fwd+bwd: {ms_fused_fb:.4f} ms; ops/ssim.py "
              f"reprojection_loss fwd: {ms_xla:.4f} ms, fwd+bwd: {ms_xla_fb:.4f} ms [{card}]")
        del pred, tgt, g
    torch.cuda.empty_cache()
    late_n, early_n = SSIM_TIMED
    common = {"xla_fwd_ms": ms_xla, "xla_fwd_bwd_ms": ms_xla_fb, "fused_fwd_bwd_ms": ms_fused_fb,
              "library_call": "none: no single PyTorch call computes SSIM",
              "timed_shape": [late_n, H, W], "checks": checks}
    stats = {}
    for name, plain_ms in (("ssim_fused_fwd", ms_fwd_plain), ("ssim_fused_bwd", ms_bwd_plain)):
        t_late, t_early = by_n[late_n][name], by_n[early_n][name]
        stats[name] = {
            "max_abs_err": 0.0 if name == "ssim_fused_fwd" else late["bwd_max_abs_err"],
            "ms": t_late["ms"], "plain_ms": plain_ms, "bound_ms": t_late["bound_ms"],
            "bound_by": t_late["bound_by"], "library_ms": None,
            "share_of_bound": t_late["share_of_bound"], "gb_per_s": t_late["gb_per_s"],
            f"ms_n{early_n}": t_early["ms"], f"bound_ms_n{early_n}": t_early["bound_ms"],
            f"share_of_bound_n{early_n}": t_early["share_of_bound"], **common}
        if name == "ssim_fused_bwd":
            stats[name]["max_rel_err"] = late["bwd_max_rel_err"]
    return stats


def packed_phase(torch, card, k, inp):
    """The packed warp kernels against their plain versions and against the
    corner-plane warp, on the corner phase's frames and grid."""
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc

    frames, grid, x, y, ct = (inp[n] for n in ("frames", "grid", "x", "y", "ct"))
    N = frames.shape[0]
    out_k = wc.warp_packed_fwd(frames, x, y)
    out_p = wc.warp_packed_fwd_reference(frames, x, y)
    out_c = wc.bilinear_sample_corner_u8(frames, grid)
    gpx_k, gpy_k = wc.warp_packed_bwd(frames, x, y, ct)
    gpx_p, gpy_p = wc.warp_packed_bwd_reference(frames, x, y, ct)
    torch.cuda.synchronize()
    fwd_err = float((out_k - out_p).abs().max())
    corner_err = float((out_k - out_c).abs().max())
    bwd_err = max(float((gpx_k - gpx_p).abs().max()), float((gpy_k - gpy_p).abs().max()))
    bwd_rel = max(float((gpx_k - gpx_p).abs().max() / gpx_p.abs().max()),
                  float((gpy_k - gpy_p).abs().max() / gpy_p.abs().max()))
    check(torch.equal(out_k, out_p), f"packed warp forward differs from its plain version by "
                                     f"{fwd_err}")
    check(corner_err <= 1e-6, f"packed warp differs from the corner-plane warp by {corner_err}")
    check(bwd_rel <= 1e-6, f"packed warp backward differs from its plain version by {bwd_rel}")

    # the whole Function: grid gradient against the corner-plane warp's autodiff
    g1 = grid.clone().requires_grad_(True)
    g2 = grid.clone().requires_grad_(True)
    (wc.bilinear_sample_packed_u8(frames, g1) * ct).sum().backward()
    (wc.bilinear_sample_corner_u8(frames, g2) * ct).sum().backward()
    grid_rel = float((g1.grad - g2.grad).abs().max() / g2.grad.abs().max())
    check(grid_rel <= 1e-6, f"packed warp grid gradient vs the corner-plane warp: {grid_rel}")
    print(f"kernel check: warp_packed_fwd max abs err {fwd_err:.3e} (vs corner-plane warp "
          f"{corner_err:.3e}), warp_packed_bwd max abs err {bwd_err:.3e} ({bwd_rel:.3e} of its "
          f"largest value), grid gradient vs corner-plane warp {grid_rel:.3e} relative, "
          f"at N={N} {H}x{W}")

    ms_fwd_plain = time_ms(torch, lambda: wc.warp_packed_fwd_reference(frames, x, y), iters=5)
    ms_bwd_plain = time_ms(torch, lambda: wc.warp_packed_bwd_reference(frames, x, y, ct),
                           iters=5)

    def packed_fwd_bwd():
        g = grid.detach().requires_grad_(True)
        (wc.bilinear_sample_packed_u8(frames, g) * ct).sum().backward()

    ms_fb = time_ms(torch, packed_fwd_bwd)
    print(f"timing plain versions: warp_packed_fwd_reference {ms_fwd_plain:.4f} ms, "
          f"warp_packed_bwd_reference {ms_bwd_plain:.4f} ms [{card}]")
    print(f"timing packed warp fwd+bwd (two kernels + clip): {ms_fb:.4f} ms; corner warp "
          f"fwd+bwd {k['corner_fwd_bwd_ms']:.4f} ms [{card}]")
    common = {"packed_fwd_bwd_ms": ms_fb, "corner_fwd_bwd_ms": k["corner_fwd_bwd_ms"],
              "grid_grad_vs_corner_max_rel_err": grid_rel}
    return {
        "warp_packed_fwd": {
            "max_abs_err": fwd_err, "corner_max_abs_err": corner_err,
            "plain_ms": ms_fwd_plain, "library_ms": k["library_ms"],
            "library_call": "F.grid_sample(bilinear, border, align_corners=True) forward, "
                            "float32 frames, same grid", **common},
        "warp_packed_bwd": {
            "max_abs_err": bwd_err, "max_rel_err": bwd_rel,
            "plain_ms": ms_bwd_plain, "library_ms": k["grid_sample_grid_grad_ms"],
            "library_call": "aten.grid_sampler_2d_backward(bilinear, border, "
                            "align_corners=True, output_mask=[False, True]): the grid "
                            "gradient alone, float32 frames, same grid and cotangent",
            "grid_sample_fwd_bwd_ms": k["grid_sample_fwd_bwd_ms"], **common},
    }


# uint8 warp checks off the main path's shape: (N, H, W, Ho, Wo, byte offset
# of the frames, float offset of px and py) -- odd W, W = 1, H = 1, Ho / Wo
# other than H / W, frames 1-3 bytes off 16-byte alignment (one at the full
# width), coordinates 4 bytes off it
WARP_U8_CASES = ((3, 17, 29, 17, 29, 0, 0), (2, 9, 1, 9, 1, 0, 0), (2, 1, 37, 1, 37, 0, 0),
                 (3, 20, 33, 11, 50, 0, 0), (4, 48, 160, 48, 160, 1, 0),
                 (2, 31, 63, 33, 61, 2, 0), (2, H, W, H, W, 3, 0), (3, 30, 64, 30, 64, 0, 1),
                 (2, 25, 40, 26, 43, 1, 1))


def warp_u8_inputs(torch, case, seed):
    """Frames, clamped coordinates and a cotangent for one WARP_U8_CASES
    entry: coordinates spread 10% past each border and clamped into the
    image, some exactly on the borders, some on whole texels; each tensor a
    contiguous view `offset` elements into a buffer of its own."""
    n, h, w, ho, wo, f_off, c_off = case
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def placed(x, offset):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        return buf[offset:].view(x.shape).copy_(x)

    frames = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device=dev, generator=gen)
    coords = []
    for size in (w, h):
        c = (torch.rand((n, ho, wo), device=dev, generator=gen) * 1.2 - 0.1) * (size - 1)
        pick = torch.rand((n, ho, wo), device=dev, generator=gen)
        c = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.95, float(size - 1), c))
        c = torch.where((pick > 0.45) & (pick < 0.5), torch.floor(c), c)
        coords.append(c.clamp(0.0, size - 1))
    ct = torch.rand((n, ho, wo, 3), device=dev, generator=gen)
    return placed(frames, f_off), placed(coords[0], c_off), placed(coords[1], c_off), ct


def warp_u8_checks(torch):
    """corner_sweep, warp_packed_fwd and warp_packed_bwd against their plain
    versions at WARP_U8_CASES: corner planes and the forward exactly equal,
    the backward within 1e-6 of its largest entry."""
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc

    results = []
    for seed, case in enumerate(WARP_U8_CASES):
        frames, x, y, ct = warp_u8_inputs(torch, case, seed)
        n, h, w, ho, wo, f_off, c_off = case
        label = f"frames {(n, h, w)} -> {(ho, wo)}" + (
            f", frames {f_off} B and coordinates {4 * c_off} B off 16-byte alignment"
            if f_off or c_off else "")
        check(frames.data_ptr() % 16 == f_off and x.data_ptr() % 16 == 4 * c_off
              and y.data_ptr() % 16 == 4 * c_off, f"{label}: alignment of the inputs")
        check(bool((x == 0).any() and (x == w - 1).any() and (y == 0).any()
                   and (y == h - 1).any()), f"{label}: no exact-border points")
        c_k, c_p = wc.corner_sweep(frames, x, y), wc.corner_sweep_reference(frames, x, y)
        f_k, f_p = wc.warp_packed_fwd(frames, x, y), wc.warp_packed_fwd_reference(frames, x, y)
        b_k = wc.warp_packed_bwd(frames, x, y, ct)
        b_p = wc.warp_packed_bwd_reference(frames, x, y, ct)
        torch.cuda.synchronize()
        check(torch.equal(c_k, c_p), f"{label}: corner planes differ from the plain version")
        fwd_err = float((f_k - f_p).abs().max())
        check(torch.equal(f_k, f_p), f"{label}: warp_packed_fwd differs from its plain version "
                                     f"by {fwd_err}")
        bwd_rel = 0.0
        for k, p in zip(b_k, b_p):
            err = float((k - p).abs().max())
            scale = float(p.abs().max())
            check(err <= 1e-6 * scale, f"{label}: warp_packed_bwd differs from its plain "
                                       f"version by {err} (largest entry {scale})")
            bwd_rel = max(bwd_rel, err / scale if scale else 0.0)
        results.append({"case": list(case), "corner_equal": True, "fwd_equal": True,
                        "bwd_max_rel_err": bwd_rel})
        print(f"kernel check: corner_sweep and warp_packed_fwd equal to their plain versions, "
              f"warp_packed_bwd within {bwd_rel:.3e} of its largest entry, at {label}")
    return results


def capture_step_grids(torch):
    """The frames and clamped coordinates that loss_forward hands to the
    uint8 warp kernels at scale 0, in one late step (N = 156: F=7, tri-min,
    incremental + partial + decomp, the error-induced poses at pose_error
    5.5 merged with the main slots, stereo) and one early step (N = 108),
    at full width, from the step phases' own batches and initial weights
    (realistic_pose_bias_ poses). A recording wrapper stands in for
    ops/warp_cuda.py's corner_sweep during one forward pass; the packed warp
    (warp_impl="pallas") is handed the same coordinates."""
    from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.training.batch import synthetic_batch
    from baseboostdepth_tpu_torch.training.step import init_state, loss_forward, main_path_static

    real = wc.corner_sweep
    grids = {}
    for stage, n in (("late_F7", B * 13), ("early_F2", B * 9)):
        st = main_path_static(stage)
        state = init_state(st, seed=0, device="cuda", steps_per_epoch=3317)
        realistic_pose_bias_(state.pose_net)
        batch = {k: torch.as_tensor(v).to("cuda")
                 for k, v in synthetic_batch(st.F, B, st.height, st.width, seed=st.F).items()}
        calls = []

        def recording(frames, px, py):
            if not calls:
                calls.append({"frames": frames.clone(), "x": px.clone(), "y": py.clone()})
            return real(frames, px, py)

        # the wrapper counts its launch on the module's name, the recorder
        recording.launches = 0
        wc.corner_sweep = recording
        try:
            with torch.no_grad():
                loss_forward(state.depth_net, state.pose_net, batch, st,
                             generator=torch.Generator(device="cuda").manual_seed(1))
        finally:
            wc.corner_sweep = real
        grid = calls[0]
        check(grid["frames"].shape == (n, H, W, 3) and grid["x"].shape == (n, H, W),
              f"{stage}: captured warp of {tuple(grid['frames'].shape)}")
        grids[stage] = grid
        del state, batch, calls
    torch.cuda.empty_cache()
    return grids


def distinct_texels(torch, frames, x, y) -> int:
    """The number of distinct source texels the four bilinear corners of
    the clamped coordinates x, y name."""
    N, h, w, _ = frames.shape
    x0 = torch.floor(x).long().clamp(0, w - 1)
    y0 = torch.floor(y).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    base = torch.arange(N, device=x.device).view(N, 1, 1) * (h * w)
    named = torch.zeros(N * h * w, dtype=torch.bool, device=x.device)
    for yy in (y0, y1):
        for xx in (x0, x1):
            named[(base + yy * w + xx).flatten()] = True
    return int(named.sum())


# the warp kernels timed on the three grids: name -> (module under ops/,
# whether it takes the frames as float32 (/ 255), its tolerance against its
# plain version (None: exactly equal; else relative to the plain version's
# largest entry), the bytes a distinct source texel and a pixel's
# coordinates (8 B) and outputs (and cotangent) add to its bound)
GRID_KERNELS = {
    "corner_sweep": ("warp_cuda", False, None, 3, 8 + 16),
    "warp_packed_fwd": ("warp_cuda", False, None, 3, 8 + 12),
    "warp_packed_bwd": ("warp_cuda", False, 1e-6, 3, 8 + 12 + 8),
    "warp_planes_fwd": ("warp_planes", True, None, 12, 8 + 12),
    "warp_planes_bwd": ("warp_planes", True, None, 12, 8 + 12 + 8),
}


def warp_grid_phase(torch, card, grids):
    """Each GRID_KERNELS kernel on each grid (the white-noise grid of
    kernel_phase, the captured late and early step grids): held against its
    plain version, then timed. Each bound counts the distinct source texels
    the grid names, the coordinates and the outputs (a backward reads a
    cotangent, 3 floats a pixel, and writes two gradients)."""
    import importlib

    out = {}
    for label, g in grids.items():
        x, y = g["x"], g["y"]
        N, ho, wo = x.shape
        ct = torch.rand((N, ho, wo, 3), device=x.device,
                        generator=torch.Generator(device=x.device).manual_seed(9))
        sources = {False: g["frames"], True: g["frames"].float().div(255.0)}
        texels = distinct_texels(torch, g["frames"], x, y)
        pixels = N * ho * wo
        row = {"n": N, "distinct_texels": texels}
        for name, (module, as_float, tol, texel_bytes, pixel_bytes) in GRID_KERNELS.items():
            mod = importlib.import_module(f"baseboostdepth_tpu_torch.ops.{module}")
            src = sources[as_float]
            args = (src, x, y, ct) if name.endswith("_bwd") else (src, x, y)
            fn = getattr(mod, name)
            got, want = fn(*args), getattr(mod, f"{name}_reference")(*args)
            for k, p in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want))):
                if tol is None:
                    check(torch.equal(k, p), f"{label} grid: {name} differs from its plain "
                                             f"version by {float((k - p).abs().max())}")
                else:
                    rel = float((k - p).abs().max() / p.abs().max())
                    check(rel <= tol, f"{label} grid: {name} differs from its plain version "
                                      f"by {rel} (relative)")
            del got, want
            nbytes = texel_bytes * texels + pixels * pixel_bytes
            ms = time_ms(torch, lambda: fn(*args))
            b = bound(name, nbytes, pixels)
            row[name] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                         "share_of_bound": b[0] / ms}
            print(f"timing {name} kernel on the {label} grid (N={N} {ho}x{wo}, {texels} "
                  f"distinct texels, {src.dtype}): {ms:.4f} ms, {b[0] / ms:.1%} of its "
                  f"{b[1]} bound {b[0]:.4f} ms [{card}]")
        print(f"kernel check: {', '.join(GRID_KERNELS)} against their plain versions at the "
              f"{label} grid (exactly, warp_packed_bwd within 1e-6 of its largest entry)")
        out[label] = row
        del ct, sources
    torch.cuda.empty_cache()
    return out


def grid_stats(by_grid, name) -> dict:
    """A warp kernel's entry fields from its times on the three grids: `ms`
    and `bound_ms` on the noise grid beside `noise_grid_*`, `step_grid_*`
    (the late step, N = 156) and `step_grid_early_*` (N = 108)."""
    on = {label: row[name] for label, row in by_grid.items()}
    return dict(
        ms=on["noise"]["ms"], bound_ms=on["noise"]["bound_ms"], bound_by=on["noise"]["bound_by"],
        noise_grid_ms=on["noise"]["ms"], noise_grid_bound_ms=on["noise"]["bound_ms"],
        step_grid_ms=on["late_F7"]["ms"], step_grid_bound_ms=on["late_F7"]["bound_ms"],
        step_grid_early_ms=on["early_F2"]["ms"],
        step_grid_early_bound_ms=on["early_F2"]["bound_ms"],
        distinct_texels={label: row["distinct_texels"] for label, row in by_grid.items()})


# float-planes warp checks off the main path's shape: (N, H, W, C, Ho, Wo,
# float offsets of the source, of px and py, of the cotangent)
WARP_PLANES_CASES = (
    (3, 17, 29, 3, 17, 29, 0, 0, 0),  # W, Wo not multiples of 4: scalar path
    (3, 20, 33, 3, 21, 50, 0, 0, 0),  # Wo % 4 == 2: scalar path
    (2, 9, 1, 3, 9, 4, 0, 0, 0),  # W = 1: every x0 is the last column
    (2, 1, 37, 3, 1, 36, 0, 0, 0),  # H = 1, Ho = 1
    (3, 16, 64, 3, 1, 64, 0, 0, 0),  # Ho = 1, W % 4 == 0
    (3, 20, 33, 1, 11, 52, 0, 0, 0),  # C = 1
    (2, 31, 63, 2, 33, 64, 0, 0, 0),  # C = 2
    (2, 25, 40, 4, 26, 40, 0, 0, 0),  # C = 4
    (4, 48, 160, 3, 48, 160, 1, 0, 0),  # source 4 B off 16-byte alignment
    (2, H, W, 3, H, W, 3, 0, 0),  # full width, source 12 B off
    (2, 30, 64, 3, 30, 64, 0, 1, 0),  # coordinates 4 B off: scalar path
    (2, 30, 64, 3, 30, 64, 2, 0, 2),  # source and cotangent 8 B off: scalar backward
    (2, 30, 64, 2, 30, 64, 0, 3, 1),  # C = 2, everything off alignment
)


def warp_planes_inputs(torch, case, seed):
    """Float images, clamped coordinates and a cotangent for one
    WARP_PLANES_CASES entry: coordinates spread 10% past each border and
    clamped into the image, some exactly on the borders, some on whole
    texels, and the last pixel of the last image at (W-1, H-1), the last
    texel of the tensor (where an aligned word would leave it); each tensor
    a contiguous view `offset` floats into a buffer of its own."""
    n, h, w, c, ho, wo, s_off, c_off, g_off = case
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def placed(x, offset):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        return buf[offset:].view(x.shape).copy_(x)

    src = torch.rand((n, h, w, c), device=dev, generator=gen)
    coords = []
    for size in (w, h):
        v = (torch.rand((n, ho, wo), device=dev, generator=gen) * 1.2 - 0.1) * (size - 1)
        pick = torch.rand((n, ho, wo), device=dev, generator=gen)
        v = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.95, float(size - 1), v))
        v = torch.where((pick > 0.45) & (pick < 0.5), torch.floor(v), v)
        v = v.clamp(0.0, size - 1)
        v[-1, -1, -1] = size - 1
        coords.append(v)
    ct = torch.rand((n, ho, wo, c), device=dev, generator=gen)
    return (placed(src, s_off), placed(coords[0], c_off), placed(coords[1], c_off),
            placed(ct, g_off))


def warp_planes_checks(torch):
    """warp_planes_fwd and warp_planes_bwd against their plain versions at
    WARP_PLANES_CASES, both exactly equal."""
    from baseboostdepth_tpu_torch.ops import warp_planes as wp

    results = []
    for seed, case in enumerate(WARP_PLANES_CASES):
        src, x, y, ct = warp_planes_inputs(torch, case, seed)
        n, h, w, c, ho, wo, s_off, c_off, g_off = case
        label = (f"images {(n, h, w, c)} -> {(ho, wo)}, source / coordinates / cotangent "
                 f"{4 * s_off} / {4 * c_off} / {4 * g_off} B off 16-byte alignment")
        check(src.data_ptr() % 16 == 4 * s_off and x.data_ptr() % 16 == 4 * c_off
              and ct.data_ptr() % 16 == 4 * g_off, f"{label}: alignment of the inputs")
        check(bool((x == 0).any() and (x == w - 1).any() and (y == 0).any()
                   and (y == h - 1).any()), f"{label}: no exact-border points")
        f_k, f_p = wp.warp_planes_fwd(src, x, y), wp.warp_planes_fwd_reference(src, x, y)
        b_k = wp.warp_planes_bwd(src, x, y, ct)
        b_p = wp.warp_planes_bwd_reference(src, x, y, ct)
        torch.cuda.synchronize()
        fwd_err = float((f_k - f_p).abs().max())
        check(torch.equal(f_k, f_p), f"{label}: warp_planes_fwd differs from its plain version "
                                     f"by {fwd_err}")
        for name, k, p in zip(("gpx", "gpy"), b_k, b_p):
            err = float((k - p).abs().max())
            check(torch.equal(k, p), f"{label}: warp_planes_bwd's {name} differs from its plain "
                                     f"version by {err}")
        results.append({"case": list(case), "fwd_equal": True, "bwd_equal": True})
        print(f"kernel check: warp_planes_fwd and warp_planes_bwd exactly equal to their plain "
              f"versions at {label}")
    return results


N_MANY = 65537  # two launches of the 3-D-grid kernels: 65,535 images, then 2


def image_count_checks(torch):
    """Each 3-D-grid kernel at N_MANY tiny images, held against its plain
    version: corner_sweep, warp_packed_fwd (and warp_packed_bwd, on the same
    inputs) on uint8 frames of 2x7 warped to 2x8 (a chunk of frames or float
    images then starts off 16-byte alignment, and the outputs take the
    16-byte paths); warp_planes_fwd / _bwd on the same frames as float32;
    the SSIM pair on 2x2 images. Exact, but the backward of the packed warp
    (1e-6 of its largest entry) and of SSIM (1e-4, as ssim_checks)."""
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops import warp_planes as wp

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    n, h, w, ho, wo = N_MANY, 2, 7, 2, 8
    frames = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, device=dev, generator=gen)
    x = (torch.rand((n, ho, wo), device=dev, generator=gen) * (w - 1)).contiguous()
    y = (torch.rand((n, ho, wo), device=dev, generator=gen) * (h - 1)).contiguous()
    x[-1, -1, -1], y[-1, -1, -1] = w - 1, h - 1
    ct = torch.rand((n, ho, wo, 3), device=dev, generator=gen)
    src = frames.float().div(255.0)

    def rel(k, p):
        return float((k - p).abs().max() / p.abs().max())

    check(torch.equal(wc.corner_sweep(frames, x, y), wc.corner_sweep_reference(frames, x, y)),
          f"N={n}: corner planes differ from the plain version")
    check(torch.equal(wc.warp_packed_fwd(frames, x, y), wc.warp_packed_fwd_reference(frames, x, y)),
          f"N={n}: warp_packed_fwd differs from its plain version")
    packed_bwd = max(rel(k, p) for k, p in zip(wc.warp_packed_bwd(frames, x, y, ct),
                                               wc.warp_packed_bwd_reference(frames, x, y, ct)))
    check(packed_bwd <= 1e-6, f"N={n}: warp_packed_bwd differs from its plain version by "
                              f"{packed_bwd} (relative)")
    check(torch.equal(wp.warp_planes_fwd(src, x, y), wp.warp_planes_fwd_reference(src, x, y)),
          f"N={n}: warp_planes_fwd differs from its plain version")
    check(all(torch.equal(k, p) for k, p in zip(wp.warp_planes_bwd(src, x, y, ct),
                                                wp.warp_planes_bwd_reference(src, x, y, ct))),
          f"N={n}: warp_planes_bwd differs from its plain version")
    del frames, x, y, ct, src
    pred = torch.rand((n, 2, 2, 3), device=dev, generator=gen)
    tgt = torch.rand((n, 2, 2, 3), device=dev, generator=gen)
    g = torch.rand((n, 2, 2, 1), device=dev, generator=gen)
    check(torch.equal(sc.ssim_fused_fwd(pred, tgt), sc.ssim_fused_fwd_reference(pred, tgt)),
          f"N={n}: ssim_fused_fwd differs from its plain version")
    ssim_bwd = rel(sc.ssim_fused_bwd(pred, tgt, g), sc.ssim_fused_bwd_reference(pred, tgt, g))
    check(ssim_bwd <= 1e-4, f"N={n}: ssim_fused_bwd differs from its plain version by "
                            f"{ssim_bwd} (relative)")
    torch.cuda.synchronize()
    print(f"kernel check: at N={n} images (two launches each) corner_sweep, warp_packed_fwd, "
          f"warp_planes_fwd / _bwd and ssim_fused_fwd exactly equal to their plain versions, "
          f"warp_packed_bwd within {packed_bwd:.3e} and ssim_fused_bwd within {ssim_bwd:.3e} "
          f"of their largest entries")
    return {"n": n, "warp_packed_bwd_max_rel_err": packed_bwd,
            "ssim_fused_bwd_max_rel_err": ssim_bwd}


def planes_phase(torch, card, k, inp):
    """The float-planes warp kernels against their plain versions, on the
    corner phase's frames as float32 (/ 255) and its grid, and on a small
    two-channel case; the forward against the packed warp of the uint8
    frames, the grid gradient against F.grid_sample's."""
    import torch.nn.functional as F

    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops import warp_planes as wp

    frames, grid, x, y, ct = (inp[n] for n in ("frames", "grid", "x", "y", "ct"))
    N = frames.shape[0]
    src = frames.float().div(255.0).contiguous()  # [N, H, W, 3] float32
    out_k = wp.warp_planes_fwd(src, x, y)
    out_p = wp.warp_planes_fwd_reference(src, x, y)
    out_u8 = wc.warp_packed_fwd(frames, x, y)
    gpx_k, gpy_k = wp.warp_planes_bwd(src, x, y, ct)
    gpx_p, gpy_p = wp.warp_planes_bwd_reference(src, x, y, ct)
    torch.cuda.synchronize()
    fwd_err = float((out_k - out_p).abs().max())
    bwd_err = max(float((gpx_k - gpx_p).abs().max()), float((gpy_k - gpy_p).abs().max()))
    u8_gap = float((out_k - out_u8).abs().max())
    check(fwd_err == 0.0, f"planes warp forward differs from its plain version by {fwd_err}")
    check(bwd_err == 0.0, f"planes warp backward differs from its plain version by {bwd_err}")
    # u8 / 255 against u8 * (1 / 255): one rounding apart before the blend,
    # a few units in the last place of 1.0 after it
    check(u8_gap <= 1e-6, f"planes warp of frames / 255 vs the packed warp: {u8_gap}")

    # a second shape: two channels, odd sizes, extra leading axes
    gen = torch.Generator(device=src.device).manual_seed(4)
    small = torch.rand((2, 3, 30, 100, 2), device=src.device, generator=gen)
    sgrid = (torch.rand((2, 3, 30, 100, 2), device=src.device, generator=gen) * 2 - 1) * 1.15
    sct = torch.rand((2, 3, 30, 100, 2), device=src.device, generator=gen)
    sx, sy = wc.pixel_coords(sgrid, 6, 30, 100)
    s_src = small.reshape(6, 30, 100, 2)
    small_err = max(
        float((wp.warp_planes_fwd(s_src, sx, sy) - wp.warp_planes_fwd_reference(s_src, sx, sy))
              .abs().max()),
        *(float((a - b).abs().max()) for a, b in zip(
            wp.warp_planes_bwd(s_src, sx, sy, sct.reshape(6, 30, 100, 2)),
            wp.warp_planes_bwd_reference(s_src, sx, sy, sct.reshape(6, 30, 100, 2)))))
    check(small_err == 0.0, f"planes warp, C=2: kernel vs plain version {small_err}")

    # the whole Function against F.grid_sample's autograd, away from the
    # image's border (there jnp.clip's subgradient is 0.5, grid_sample's 0)
    src_nchw = src.permute(0, 3, 1, 2)
    g1 = grid.clone().requires_grad_(True)
    g2 = grid.clone().requires_grad_(True)
    o1 = wp.bilinear_sample_planes(src, g1)
    o2 = F.grid_sample(src_nchw, g2, mode="bilinear", padding_mode="border", align_corners=True)
    (o1 * ct).sum().backward()
    (o2 * ct.permute(0, 3, 1, 2)).sum().backward()
    gs_val = float((o1.detach() - o2.detach().permute(0, 2, 3, 1)).abs().max())
    inside = ((x > 0) & (x < W - 1) & (y > 0) & (y < H - 1))[..., None].expand_as(g1)
    gs_grad = float((g1.grad - g2.grad)[inside].abs().max() / g2.grad[inside].abs().max())
    check(gs_val <= 1e-5, f"planes warp vs F.grid_sample values: {gs_val}")
    check(gs_grad <= 1e-4, f"planes warp grid gradient vs F.grid_sample's: {gs_grad}")
    print(f"kernel check: warp_planes_fwd and warp_planes_bwd exactly equal to their plain "
          f"versions at N={N} {H}x{W} C=3 and N=6 30x100 C=2; forward vs the packed warp "
          f"{u8_gap:.3e}, vs F.grid_sample {gs_val:.3e}; grid gradient vs F.grid_sample "
          f"{gs_grad:.3e} of its largest value (off the border)")

    ms_fwd_plain = time_ms(torch, lambda: wp.warp_planes_fwd_reference(src, x, y), iters=5)
    ms_bwd_plain = time_ms(torch, lambda: wp.warp_planes_bwd_reference(src, x, y, ct), iters=5)

    def planes_fwd_bwd():
        g = grid.detach().requires_grad_(True)
        (wp.bilinear_sample_planes(src, g) * ct).sum().backward()

    ms_fb = time_ms(torch, planes_fwd_bwd)
    print(f"timing plain versions: warp_planes_fwd_reference {ms_fwd_plain:.4f} ms, "
          f"warp_planes_bwd_reference {ms_bwd_plain:.4f} ms [{card}]")
    print(f"timing planes warp fwd+bwd (two kernels + clip): {ms_fb:.4f} ms; F.grid_sample "
          f"fwd+bwd {k['grid_sample_fwd_bwd_ms']:.4f} ms [{card}]")
    common = {"planes_fwd_bwd_ms": ms_fb, "grid_sample_fwd_bwd_ms": k["grid_sample_fwd_bwd_ms"],
              "packed_u8_max_abs_gap": u8_gap, "grid_sample_max_abs_err": gs_val,
              "grid_grad_vs_grid_sample_max_rel_err": gs_grad, "c2_max_abs_err": small_err}
    return {
        "warp_planes_fwd": {
            "max_abs_err": fwd_err, "plain_ms": ms_fwd_plain, "library_ms": k["library_ms"],
            "library_call": "F.grid_sample(bilinear, border, align_corners=True) forward, "
                            "the same float32 frames (NCHW) and grid", **common},
        "warp_planes_bwd": {
            "max_abs_err": bwd_err, "plain_ms": ms_bwd_plain,
            "library_ms": k["grid_sample_grid_grad_ms"],
            "library_call": "aten.grid_sampler_2d_backward(bilinear, border, "
                            "align_corners=True, output_mask=[False, True]): the grid "
                            "gradient alone, the same float32 frames, grid and cotangent",
            **common},
    }


def same_values(torch, a, b) -> bool:
    """Equal shapes, NaN at the same places and equal values elsewhere."""
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def graph_ms(torch, fn, n=100) -> float:
    """Device milliseconds per fn() call: n calls captured in a CUDA graph,
    the graph replayed (no host launch cost between them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(torch, graph.replay, iters=10, warmup=2) / n


def probe_bytes(case, out_numel) -> int:
    """Bytes the probe's function must move on this run's data: the scale
    reads and writes every element; a gather reads its indices, the distinct
    valid source elements they name, and writes its output; the slice reads
    its start and the rows it copies, and writes them."""
    if case.op == "scale":
        return 2 * case.args[0].nbytes
    if case.op == "row_slice":
        return 4 + 2 * out_numel * 4
    src, idx = case.args
    n = src.shape[0] if case.op == "gather_rows" else src.shape[1]
    wrapped = np.where(idx < 0, idx.astype(np.int64) + n, idx)
    valid = (wrapped >= 0) & (wrapped < n)
    if case.op == "gather_rows":
        flat = wrapped * src.shape[1] + np.arange(idx.shape[1])[None, :]
    else:
        flat = wrapped + np.arange(idx.shape[0])[:, None] * (src.shape[1] if src.shape[0] > 1 else 0)
    distinct = np.unique(flat[valid]).size
    return idx.nbytes + distinct * 4 + out_numel * 4


def probe_phase(torch, card):
    """The capability-probe tool on the card: its entry point (the seven
    probes of tools/pallas_probe.py at the JAX tool's shapes and inputs)
    with the launch counters set to 0 just before and read just after; then
    each probe's kernel against its plain version and the JAX tool's numpy
    reference exactly, again on wrapped and out-of-range indices and on
    slice starts beyond both ends, and timed beside the library call for the
    same function."""
    import contextlib
    import io

    from baseboostdepth_tpu_torch.ops import probe_cuda as pc
    from baseboostdepth_tpu_torch.tools import pallas_probe as tool

    report = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(report):
        failed = tool.main(device="cuda")
    launches = read_launches()
    print(report.getvalue(), end="")
    check(failed == 0, f"probe tool: {failed} probe(s) failed")
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(probe_scale=1, probe_gather_rows=2, probe_gather_cols=3, probe_row_slice=1)
    check(launches == expect, f"probe tool: kernel launches {launches}, expected {expect}")

    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(11)
    library = {
        "scale": lambda x: x * 2,
        "gather_rows": lambda src, idx: torch.take_along_dim(src, idx, dim=0),
        "gather_cols": lambda src, idx: torch.take_along_dim(src, idx, dim=1),
        "row_slice": lambda src, start: src.narrow(0, 17, 8).clone(),
    }
    by_probe, checked = {}, 0
    for case in tool.probe_cases():
        kernel = getattr(pc, f"probe_{case.op}")
        plain = getattr(pc, f"probe_{case.op}_reference")
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in case.args]
        out_k, out_p = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        check(same_values(torch, out_k, out_p), f"probe {case.name}: kernel vs plain version")
        check(np.array_equal(out_k.cpu().numpy(), case.expected),
              f"probe {case.name}: kernel vs the JAX tool's numpy reference")
        # wrapped and out-of-range indices, clamped starts: against the plain version
        if case.op == "row_slice":
            extra = [[args[0], torch.tensor([s], dtype=torch.int32, device=dev)]
                     for s in (-1000, -65, -64, -9, -1, 0, 56, 57, 2**31 - 1)]
        elif case.op != "scale":
            src = args[0]
            n = src.shape[0] if case.op == "gather_rows" else src.shape[1]
            idx = gen.integers(-n - n // 4, n + n // 4, tuple(args[1].shape)).astype(np.int32)
            idx.flat[:4] = (-n, -n - 1, n - 1, n)
            extra = [[src, torch.from_numpy(idx).to(dev)]]
        else:
            extra = []
        for xargs in extra:
            check(same_values(torch, kernel(*xargs), plain(*xargs)),
                  f"probe {case.name}: kernel vs plain version off the tool's inputs")
            checked += 1

        lib_args = [a.long() if a.dtype == torch.int32 else a for a in args]
        ms = time_ms(torch, lambda: kernel(*args), iters=1000, warmup=20)
        device_ms = graph_ms(torch, lambda: kernel(*args))
        plain_ms = time_ms(torch, lambda: plain(*args), iters=200, warmup=5)
        lib_ms = time_ms(torch, lambda: library[case.op](*lib_args), iters=1000, warmup=20)
        lib_device_ms = graph_ms(torch, lambda: library[case.op](*lib_args))
        nbytes = probe_bytes(case, out_k.numel())
        by_probe[case.name] = {
            "kernel": f"probe_{case.op}", "shape": [list(a.shape) for a in case.args],
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_device_ms, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        print(f"timing probe {case.name} (probe_{case.op}, {case.args[0].shape}): "
              f"{ms * 1e3:.2f} us per call, {device_ms * 1e3:.2f} us on the device (graph), "
              f"bound {nbytes / HBM_BYTES_PER_S * 1e6:.5f} us ({nbytes} B): launch-bound; "
              f"plain {plain_ms * 1e3:.2f} us; library {lib_ms * 1e3:.2f} us per call, "
              f"{lib_device_ms * 1e3:.2f} us on the device [{card}]")
    print(f"kernel check: the four probe kernels equal their plain versions and the JAX "
          f"tool's references exactly on its seven probes, and their plain versions on "
          f"{checked} further cases (wrapped / out-of-range indices, clamped starts)")

    library_calls = {"scale": "x * 2", "gather_rows": "torch.take_along_dim(src, idx, dim=0)",
                     "gather_cols": "torch.take_along_dim(src, idx, dim=1)",
                     "row_slice": "src.narrow(0, 17, 8).clone()"}
    stats = {}
    for case in tool.probe_cases():
        name = f"probe_{case.op}"
        mine = {k: v for k, v in by_probe.items() if v["kernel"] == name}
        head = max(mine.values(), key=lambda v: v["bytes"])  # the largest of its probes
        stats[name] = {
            "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes", "library_ms": head["library_ms"],
            "library_call": library_calls[case.op] + " (int64 indices; no wrap or NaN fill)",
            "device_ms": head["device_ms"], "library_device_ms": head["library_device_ms"],
            "timed_probe": next(k for k, v in mine.items() if v is head),
            "by_probe": mine, "launch_bound": True}
    return {"launches": launches}, stats


def as_float_frames(torch, batch):
    """The batch with its uint8 frames as float32 in [0, 1] (frames / 255)."""
    return dict(batch, frames=batch["frames"].to(torch.float32) / 255.0)


def parity_phase(torch, float_frames=False, height=64, width=128, **options):
    """The step on a small input, on the card (kernels) and on the CPU (plain
    versions), fp32 with TF32 off: the losses must agree. `options` set
    StepStatic fields (a zoo, md2's num_layers, merged_warp, the kernel
    options); SQLdepth's dropout and MonoViT's drop-path are off, since the
    card's and the CPU's generators draw different masks."""
    from baseboostdepth_tpu_torch.training.batch import synthetic_batch
    from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, loss_forward

    fields = dict(height=height, width=width, F=2, scales=(0, 1, 2, 3), dtype="float32")
    st = StepStatic(**{**fields, **options})
    batch = synthetic_batch(2, batch=2, height=height, width=width, seed=5)
    noise = torch.randn((2, 1, height, width), generator=torch.Generator().manual_seed(5)) * 1e-5
    losses = {}
    for dev in ("cuda", "cpu"):
        state = init_state(st, seed=3, device=dev)
        for m in state.depth_net.modules():
            for rate in ("dropout_rate", "drop_rate"):
                if hasattr(m, rate):
                    setattr(m, rate, 0.0)
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if float_frames:
            tb = as_float_frames(torch, tb)
        loss, _ = loss_forward(state.depth_net, state.pose_net, tb, st, noise=noise.to(dev))
        loss.backward()
        grads = [p.grad for p in state.depth_net.parameters() if p.grad is not None]
        check(all(bool(torch.isfinite(g).all()) for g in grads), f"non-finite gradient on {dev}")
        losses[dev] = float(loss.detach())
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    label = ("float frames, " if float_frames else "") + (str(options) if options else
                                                           "default options")
    check(rel <= 1e-4, f"small-input loss {label} on the card {losses['cuda']} vs CPU "
                       f"{losses['cpu']}")
    print(f"parity check {label}: {height}x{width} step loss card "
          f"{losses['cuda']:.7f} vs CPU {losses['cpu']:.7f} (rel {rel:.2e})")


def drop_path_phase(torch):
    """MonoViT (MPViT-small, drop-path 0.2) in train mode on the card, at
    2 x 192x640: two forwards with a generator of the same seed give the
    same disparities, one with another seed gives others; in eval mode the
    generator changes nothing."""
    from baseboostdepth_tpu_torch.models import build_depth_net

    net = build_depth_net("monovit", generator=torch.Generator().manual_seed(0)).cuda()
    x = torch.rand(2, H, W, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(1))

    def disp(seed, train=True):
        net.train(train)
        with torch.no_grad():
            return net(x, generator=torch.Generator("cuda").manual_seed(seed))[0]

    a, b, c = disp(7), disp(7), disp(8)
    check(torch.equal(a, b), "drop-path: the same generator seed gave other outputs")
    check(not torch.equal(a, c), "drop-path: another generator seed gave the same outputs")
    check(torch.equal(disp(7, False), disp(8, False)), "drop-path drew masks in eval mode")
    print(f"drop-path check: MonoViT train-mode disparities equal for one generator seed, "
          f"max |difference| {float((a - c).abs().max()):.3e} for another; eval mode draws "
          "nothing")
    del net
    torch.cuda.empty_cache()


def expected_launches(st, float_frames=False) -> dict:
    """Kernel launches per step that the step's structure implies. Per loss
    scale the main slots and the error poses (decomp under tri-min) are one
    merged warp call, or two under the two-call schedule
    (merged_warp=False), and the main-slot and error-pose photometric
    losses are one call each; the identity candidates' loss is one call per
    step. Gradients reach the warped images only (the identity candidates
    are raw frames), so each warp and each loss call but the identity one
    runs its backward once. Float frames take the float-planes warp
    whatever warp_impl says."""
    S = len(st.scales)
    per_scale = 2 if st.decomp and st.trimin else 1  # candidate sets: main (+ error)
    warps = S * (1 if st.merged_warp else per_scale)
    counts = dict.fromkeys(KERNELS, 0)
    if float_frames:
        counts.update(warp_planes_fwd=warps, warp_planes_bwd=warps)
    elif st.warp_impl == "pallas":
        counts.update(warp_packed_fwd=warps, warp_packed_bwd=warps)
    else:
        counts.update(corner_sweep=warps)
    if st.photo_impl == "fused" and st.use_ssim:
        counts.update(ssim_fused_fwd=1 + per_scale * S, ssim_fused_bwd=per_scale * S)
    return counts


def step_phase(torch, card, name, steps, float_frames=False, **options):
    """Train `steps` steps of one main-path stage at full width, with the
    launch counters set to 0 just before and read just after. With
    float_frames the batch's frames are the synthetic uint8 frames / 255 as
    float32, and the loss at the initial weights is first held against the
    uint8 batch's at the same noise."""
    from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
    from baseboostdepth_tpu_torch.training.batch import synthetic_batch
    from baseboostdepth_tpu_torch.training.step import (
        init_state,
        loss_forward,
        main_path_static,
        make_train_step,
    )

    st = main_path_static(name, **options)
    label = name + ("_float" if float_frames else "") + (f" {options}" if options else "")
    state = init_state(st, seed=0, device="cuda", steps_per_epoch=3317)
    realistic_pose_bias_(state.pose_net)
    batch = {k: torch.as_tensor(v).to("cuda")
             for k, v in synthetic_batch(st.F, B, st.height, st.width, seed=st.F).items()}
    loss_vs_u8 = None
    if float_frames:
        batch_u8, batch = batch, as_float_frames(torch, batch)
        noise = torch.randn((B, 1, st.height, st.width), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2)) * 1e-5
        with torch.no_grad():
            l_f = float(loss_forward(state.depth_net, state.pose_net, batch, st, noise=noise)[0])
            l_u = float(loss_forward(state.depth_net, state.pose_net, batch_u8, st,
                                     noise=noise)[0])
        loss_vs_u8 = abs(l_f - l_u) / abs(l_u)
        # the warps differ by u8 / 255 against u8 * (1 / 255), one rounding
        check(loss_vs_u8 <= 1e-5, f"{label}: loss {l_f} vs the uint8 batch's {l_u}")
        print(f"step {label}: loss at the initial weights {l_f:.7f} vs the uint8 batch's "
              f"{l_u:.7f} (rel {loss_vs_u8:.2e})")
        del batch_u8
    params0 = [p.detach().clone() for p in state.depth_net.parameters()]
    stats0 = [b.detach().clone() for n, b in state.pose_net.named_buffers() if "running_" in n]
    step = make_train_step(st, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    times, losses = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, batch, generator=gen)
        end.record()
        losses.append(float(metrics["loss"]))
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = read_launches()

    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    expect = {n: steps * c for n, c in expected_launches(st, float_frames).items()}
    check(launches == expect, f"{label}: kernel launches {launches}, expected {expect}")
    moved = any(not torch.equal(a, b) for a, b in zip(params0, state.depth_net.parameters()))
    check(moved, f"{label}: parameters did not change")
    stats1 = [b for n, b in state.pose_net.named_buffers() if "running_" in n]
    check(any(not torch.equal(a, b) for a, b in zip(stats0, stats1)),
          f"{label}: BN statistics did not change")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = times[1:]  # the first step is the warm-up
    ms = sum(timed) / len(timed)
    print(f"step {label}: losses {[round(v, 6) for v in losses]}, kernel launches "
          f"{ {n: c for n, c in launches.items() if c} }, peak memory {peak_gb:.2f} GB")
    print(f"timing {label} ms/step (CUDA events, mean of the {len(timed)} step(s) after one "
          f"warm-up step): {ms:.2f} (all steps {[round(t, 2) for t in times]}; "
          f"{B / ms * 1e3:.2f} imgs/s) [{card}]")
    del state, batch
    torch.cuda.empty_cache()
    out = {"launches": launches, "ms_per_step": ms, "peak_gb": peak_gb}
    if loss_vs_u8 is not None:
        out["loss_rel_vs_uint8"] = loss_vs_u8
    return out


KITTI_FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"
N_EVAL = 32  # eigen test images (two batches of 16)
N_ODOM = 18  # odometry frames


def smooth_image(rng, height, width) -> np.ndarray:
    """A smooth random uint8 RGB image: a 12x40 random texture upsampled."""
    from PIL import Image

    base = rng.integers(30, 220, (12, 40, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(base).resize((width, height), Image.BILINEAR))


def smooth_depth(rng, height, width, lo, hi) -> np.ndarray:
    """A smooth random float32 depth map in [lo, hi]: a 6x20 random field
    upsampled bilinearly, plus a near-to-far ramp down the rows."""
    import cv2

    field = cv2.resize(rng.random((6, 20)).astype(np.float32), (width, height),
                       interpolation=cv2.INTER_LINEAR)
    ramp = np.linspace(1.0, 0.0, height, dtype=np.float32)[:, None]
    return (lo + (hi - lo) * (0.3 * field + 0.7 * ramp)).astype(np.float32)


def write_trees(root: str, n_frames: int = 56, n_samples: int = 48) -> None:
    """Trees at the datasets' published sizes, random images:
    - KITTI raw (1242x375 JPEGs): one drive, both cameras;
      splits/eigen_zhou/train_files_baselines.txt whose baselines give
      windows of 2, 1 and 0 (stereo only) frames at the first epochs'
      cutoff (no eigen_zhou val GT: no eigen validation in training);
      splits/eigen/test_files.txt over N_EVAL left frames with smooth
      synthetic GT at 375x1242 (gt_depths.npz);
    - SYNS (1242x376 PNGs and .npy depths in (1, 115) m): one test and one
      val scene, splits/SYNS/{test,val}_files.txt;
    - KITTI odometry sequence 09 (1242x375 PNGs, N_ODOM frames),
      splits/odom/test_files_09.txt and GT poses (1 m forward per frame)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for cam in (2, 3):
        d = os.path.join(root, "raw", KITTI_FOLDER, f"image_0{cam}", "data")
        os.makedirs(d)
        for i in range(n_frames):
            Image.fromarray(smooth_image(rng, 375, 1242)).save(
                os.path.join(d, f"{i:010d}.jpg"), quality=90)
    first = (n_frames - n_samples) // 2
    baselines = (0.05, 0.1, 0.0, 0.05, 0.2, 0.03)
    lines = [f"{KITTI_FOLDER} {i} {'lr'[i % 2]} kt {baselines[i % len(baselines)]}"
             for i in range(first, first + n_samples)]
    splits = os.path.join(root, "splits")
    os.makedirs(os.path.join(splits, "eigen_zhou"))
    with open(os.path.join(splits, "eigen_zhou", "train_files_baselines.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    os.makedirs(os.path.join(splits, "eigen"))
    with open(os.path.join(splits, "eigen", "test_files.txt"), "w") as f:
        f.write("\n".join(f"{KITTI_FOLDER} {i} l" for i in range(N_EVAL)) + "\n")
    gt = np.empty(N_EVAL, dtype=object)
    for i in range(N_EVAL):
        gt[i] = smooth_depth(rng, 375, 1242, 2.0, 75.0)
    np.savez_compressed(os.path.join(splits, "eigen", "gt_depths.npz"), data=gt)

    os.makedirs(os.path.join(splits, "SYNS"))
    syns_lines = []
    for i in range(2):
        folder = f"{i + 1:02d}"
        os.makedirs(os.path.join(root, "syns", "images", folder))
        os.makedirs(os.path.join(root, "syns", "depths", folder))
        Image.fromarray(smooth_image(rng, 376, 1242)).save(
            os.path.join(root, "syns", "images", folder, f"{i:02d}.png"))
        np.save(os.path.join(root, "syns", "depths", folder, f"{i:02d}.npy"),
                smooth_depth(rng, 376, 1242, 1.0, 115.0))
        syns_lines.append(f"{folder} {i:02d}")
    for name, line in zip(("test_files.txt", "val_files.txt"), syns_lines):
        with open(os.path.join(splits, "SYNS", name), "w") as f:
            f.write(line + "\n")

    seq = os.path.join(root, "odom", "sequences", "09", "image_2")
    os.makedirs(seq)
    for i in range(N_ODOM):
        Image.fromarray(smooth_image(rng, 375, 1242)).save(os.path.join(seq, f"{i:06d}.png"))
    os.makedirs(os.path.join(splits, "odom"))
    with open(os.path.join(splits, "odom", "test_files_09.txt"), "w") as f:
        f.write("\n".join(f"09 {i} l" for i in range(N_ODOM)) + "\n")
    poses = [np.c_[np.eye(3), [0.0, 0.0, float(i)]].reshape(-1) for i in range(N_ODOM)]
    np.savetxt(os.path.join(root, "poses09.txt"), np.array(poses))


def trainer_phase(torch, card, step_ms, root):
    """The training entry point at the default configuration (md2 RN18,
    640x192, batch 12, bf16, the full method with the curriculum, bucket_fs
    at its default) on the trees under `root`: cli.train.main for one epoch
    (4 steps, a metrics line at batch 2, ending in a checkpoint), then the
    CLI's trainer with two epochs, which must resume from that checkpoint at
    epoch 1 with the saved weights, and trains one more epoch; then the
    loader alone over that epoch's batches. Those two runs draw no panels
    and run no validation, so their times compare with earlier runs. A
    third run trains epoch 2 with SYNS validation and image panels on: its
    metrics.jsonl must hold syns/* metrics and panels/ a PNG."""
    from baseboostdepth_tpu_torch.cli import train as cli
    from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
    from baseboostdepth_tpu_torch.data.loader import KittiTrainLoader
    from baseboostdepth_tpu_torch.native import native_available
    from baseboostdepth_tpu_torch.training.trainer import prefetch_to_device

    argv = ["--data.kt_path", os.path.join(root, "raw"),
            "--data.splits_dir", os.path.join(root, "splits"),
            "--data.syns_path", os.path.join(root, "syns"),
            "--log.log_dir", os.path.join(root, "logs"), "--log.model_name", "smoke",
            "--log.log_frequency", "2", "--log.image_panels", "False",
            "--optim.num_epochs", "1"]
    reset_launches()
    t0 = time.perf_counter()
    tr1 = cli.main(argv, device="cuda")
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    steps1 = tr1.state.step
    check(steps1 == tr1.steps_per_epoch == 4, f"trainer: {steps1} steps in the first epoch")
    check(tr1.ckpt.latest_step() == steps1, "trainer: no checkpoint at the epoch's end")
    saved = {f"{net}.{k}": v.detach().clone()
             for net, m in (("depth", tr1.state.depth_net), ("pose", tr1.state.pose_net))
             for k, v in m.state_dict().items()}
    del tr1

    tr2 = cli.build_trainer(argv + ["--optim.num_epochs", "2"], device="cuda")
    check((tr2.start_epoch, tr2.start_batch, tr2.state.step) == (1, 0, steps1),
          f"trainer: resumed at epoch {tr2.start_epoch} batch {tr2.start_batch} step "
          f"{tr2.state.step}, expected epoch 1 batch 0 step {steps1}")
    restored = {f"{net}.{k}": v
                for net, m in (("depth", tr2.state.depth_net), ("pose", tr2.state.pose_net))
                for k, v in m.state_dict().items()}
    check(restored.keys() == saved.keys()
          and all(torch.equal(saved[k], restored[k]) for k in saved),
          "trainer: restored parameters differ from the saved ones")
    t0 = time.perf_counter()
    tr2.train()
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches = read_launches()
    steps = tr2.state.step
    check(steps == 2 * steps1, f"trainer: {steps} steps after the second epoch")
    expect = dict.fromkeys(KERNELS, 0)
    expect["corner_sweep"] = 4 * steps  # default options, 4 loss scales at epochs 0-2
    check(launches == expect, f"trainer: kernel launches {launches}, expected {expect}")
    metrics_file = os.path.join(root, "logs", "smoke", "metrics.jsonl")
    with open(metrics_file) as f:
        logged = [json.loads(ln) for ln in f]
    check(len(logged) == 2 and all(np.isfinite(m["loss"]) for m in logged),
          f"trainer: metrics lines {logged}")
    ckpts = tr2.ckpt.all_steps()
    check(ckpts == [steps1, steps], f"trainer: checkpoints {ckpts}")

    # the loader alone over epoch 1's batches (its share of the epoch), with
    # each decoder this machine builds; then the device prefetcher over the
    # same epoch, each device batch against its host batch byte for byte
    cfg = tr2.cfg

    def epoch1_loader(use_native=None):
        return KittiTrainLoader(
            tr2.train_index, stage_for_epoch(1, cfg.method.trimin), cfg.optim.batch_size,
            cfg.data.height, cfg.data.width, trimin=cfg.method.trimin,
            num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
            seed=cfg.seed * 1000 + 1, use_native=use_native)

    decoder = "native" if epoch1_loader().use_native else "PIL"
    loader_s = {}
    for name in (("native", "PIL") if native_available() else ("PIL",)):
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in epoch1_loader(name == "native"))
        loader_s[name] = time.perf_counter() - t0
        check(n_loaded == steps1, f"trainer: the {name} loader gave {n_loaded} batches")
    n_prefetched = 0
    for host, dev in prefetch_to_device(epoch1_loader(), torch.device("cuda")):
        check(host.keys() == dev.keys() and all(
            dev[k].is_cuda and torch.equal(dev[k].cpu(), torch.as_tensor(v))
            for k, v in host.items()), f"trainer: prefetched batch {n_prefetched} differs from "
                                       "its host batch")
        n_prefetched += 1
    check(n_prefetched == steps1, f"trainer: the prefetcher gave {n_prefetched} batches")
    del tr2

    # epoch 2 with SYNS validation and image panels at batch 2
    reset_launches()
    tr3 = cli.build_trainer(argv + ["--optim.num_epochs", "3", "--log.syns_val", "True",
                                    "--log.image_panels", "True"], device="cuda")
    t0 = time.perf_counter()
    tr3.train()
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    launches3 = read_launches()
    check(tr3.state.step == 3 * steps1, f"trainer: {tr3.state.step} steps after the third epoch")
    expect["corner_sweep"] = 4 * steps1
    check(launches3 == expect, f"trainer, syns-val run: kernel launches {launches3}")
    with open(metrics_file) as f:
        syns_logged = [m for m in map(json.loads, f) if "syns/abs_rel" in m]
    check(len(syns_logged) == 1 and all(np.isfinite(v) for v in syns_logged[0].values()),
          f"trainer: syns-val lines {syns_logged}")
    panels = os.listdir(os.path.join(root, "logs", "smoke", "panels"))
    check(len(panels) == 1 and os.path.getsize(
        os.path.join(root, "logs", "smoke", "panels", panels[0])) > 0,
        f"trainer: panels {panels}")
    del tr3

    logged_rate = [m["imgs_per_sec"] for m in logged]
    epoch_rate = steps1 * B / wall2
    syns_metrics = {k: v for k, v in syns_logged[0].items() if k.startswith("syns/")}
    print(f"trainer: three runs of cli.train (epoch 0, then resumed at epoch 1 from step "
          f"{steps1}, then epoch 2 with SYNS validation and panels), {3 * steps1} steps, "
          f"launches {launches['corner_sweep'] + launches3['corner_sweep']} corner_sweep; "
          f"syns-val {json.dumps(syns_metrics)}; panel {panels[0]}")
    loader_rates = {name: steps1 * B / sec for name, sec in loader_s.items()}
    print(f"trainer: decoder {decoder} (native decoder available: {native_available()}); "
          f"{n_prefetched} prefetched device batches equal to their host batches byte for byte")
    print(f"timing trainer: logged imgs/s (wall clock since the epoch's start, loader "
          f"included) {[round(r, 2) for r in logged_rate]}; run 1 {wall1:.2f} s "
          f"(networks' init, {steps1} steps, checkpoint), run 2 train() {wall2:.2f} s "
          f"({epoch_rate:.2f} imgs/s over the epoch); the loader alone over that epoch "
          + ", ".join(f"{name} {loader_s[name]:.2f} s ({rate:.2f} imgs/s)"
                      for name, rate in loader_rates.items())
          + f"; the step alone (early_F2 phase) {step_ms:.2f} ms/step = "
          f"{B / step_ms * 1e3:.2f} imgs/s; run 3 train() with a panel and SYNS validation "
          f"{wall3:.2f} s [{card}]")
    return {"launches": {n: launches[n] + launches3[n] for n in KERNELS},
            "logged_imgs_per_s": logged_rate, "epoch_imgs_per_s": epoch_rate, "run1_s": wall1,
            "run2_train_s": wall2, "run3_syns_val_panels_s": wall3, "decoder": decoder,
            "loader_epoch_s": loader_s, "loader_imgs_per_s": loader_rates,
            "prefetched_batches_equal": n_prefetched}


def zoo_trainer_phase(torch, card, root):
    """One short epoch (epoch 0: F=2, 4 steps, a metrics line at batch 2,
    ending in a checkpoint) of cli.train with --model.zoo cadepth (its
    default two-call warp schedule, 4 loss scales: 8 corner_sweep launches
    a step), --model.zoo sql (scale 0 only: 1 a step), --model.zoo monovit
    and --model.zoo diffnet (merged, 4 scales: 4 a step), at the trainer
    phase's configuration and trees. The monovit checkpoint must hold its
    two AdamW groups: the depth encoder's parameters at
    optim.vit_encoder_lr, the rest at optim.learning_rate. The sql and
    monovit checkpoints are scored by the eval phase."""
    from baseboostdepth_tpu_torch.cli import train as cli
    from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager

    per_step = {"cadepth": 8, "sql": 1, "monovit": 4, "diffnet": 4}
    launches, walls = dict.fromkeys(KERNELS, 0), {}
    for zoo, n in per_step.items():
        argv = ["--data.kt_path", os.path.join(root, "raw"),
                "--data.splits_dir", os.path.join(root, "splits"),
                "--log.log_dir", os.path.join(root, "logs"), "--log.model_name", f"smoke_{zoo}",
                "--log.log_frequency", "2", "--log.image_panels", "False",
                "--optim.num_epochs", "1", "--model.zoo", zoo]
        reset_launches()
        t0 = time.perf_counter()
        tr = cli.main(argv, device="cuda")
        torch.cuda.synchronize()
        walls[zoo] = time.perf_counter() - t0
        got = read_launches()
        steps = tr.state.step
        check(steps == tr.steps_per_epoch == 4, f"trainer {zoo}: {steps} steps")
        check(tr.ckpt.latest_step() == steps, f"trainer {zoo}: no checkpoint at the epoch's end")
        expect = dict.fromkeys(KERNELS, 0)
        expect["corner_sweep"] = n * steps
        check(got == expect, f"trainer {zoo}: kernel launches {got}, expected {expect}")
        with open(os.path.join(root, "logs", f"smoke_{zoo}", "metrics.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        check(len(logged) == 1 and np.isfinite(logged[0]["loss"]),
              f"trainer {zoo}: metrics lines {logged}")
        for k in KERNELS:
            launches[k] += got[k]
        if zoo == "monovit":
            saved, _ = CheckpointManager(tr.ckpt.directory).restore(None)
            groups = saved["optimizer"]["param_groups"]
            n_enc = len(list(tr.state.depth_net.encoder.parameters()))
            check([g["lr"] for g in groups] == [tr.cfg.optim.vit_encoder_lr,
                                                tr.cfg.optim.learning_rate]
                  and len(groups[0]["params"]) == n_enc
                  and all(g["weight_decay"] == 1e-4 for g in groups),
                  f"trainer monovit: checkpointed optimizer groups "
                  f"{[(g['lr'], len(g['params'])) for g in groups]}")
            print(f"trainer monovit: the checkpoint's AdamW groups: {n_enc} encoder "
                  f"parameters at {groups[0]['lr']}, {len(groups[1]['params'])} others at "
                  f"{groups[1]['lr']}, weight decay 1e-4")
        print(f"trainer {zoo}: one epoch of cli.train, {steps} steps, loss at batch 2 "
              f"{logged[0]['loss']:.6f}, {got['corner_sweep']} corner_sweep launches; "
              f"wall clock {walls[zoo]:.2f} s (networks' init, loader, checkpoint) [{card}]")
        del tr
        torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": walls}


DIST_RANKS = 2  # dist_phase (a): two ranks on the one card
DIST_TIMEOUT_S = 600


def one_process_fast_variance_step():
    """The one-process float32 late step with BatchNorm2d's global-batch
    formula (E[x^2] - E[x]^2 of summed statistics, the path a W-rank run
    takes) in place of F.batch_norm: the rounding baseline that the W-rank
    check's bounds stand on."""
    from baseboostdepth_tpu_torch import profile_step as ps
    from baseboostdepth_tpu_torch.models import resnet

    saved = resnet.world_size, resnet.all_reduce_sum
    resnet.world_size, resnet.all_reduce_sum = (lambda: 2), (lambda x: x)
    try:
        return ps.float32_step("late_F7", B)
    finally:
        resnet.world_size, resnet.all_reduce_sum = saved


def dist_child(rank: int, init: str, out: str) -> None:
    """One rank of dist_phase (a), started by it as
    `chip_smoke.py --dist-child RANK INIT OUT`: both ranks on cuda:0 in a
    gloo group (NCCL refuses two ranks on one device). Rank 0 first
    computes the one-process float32 step (TF32 off) of the late stage on
    the global batch of B, then both run it on their rows: the global loss,
    the averaged gradients and the BN statistics against the one-process
    step, the replicas bit-equal. Then 3 bf16 steps of the late and 2 of
    the early stage, timed, with the kernel launch counters set to 0 just
    before each and read just after. Writes its results to OUT (JSON)."""
    import torch
    import torch.distributed as dist

    from baseboostdepth_tpu_torch import profile_step as ps
    from baseboostdepth_tpu_torch.parallel import sharding
    from baseboostdepth_tpu_torch.training.step import main_path_static, make_train_step

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    ref = fast = None
    if rank == 0:
        ref, fast = ps.float32_step("late_F7", B), one_process_fast_variance_step()
    dist.init_process_group("gloo", init_method=init, world_size=DIST_RANKS, rank=rank)
    try:
        got = ps.float32_step("late_F7", B)
        result = {"rank": rank, "local_batch": B // DIST_RANKS,
                  "replicas_bit_equal": ps.replicas_equal(
                      [*got["params"].values(), *got["stats"].values(),
                       *got["grads"].values()])}
        if rank == 0:
            result["float32_vs_one_process"] = ps.hold_to_reference(got, ref)
            result["baseline_fast_variance_vs_one_process"] = ps.hold_to_reference(fast, ref)
            result["float32_vs_one_process_fast_variance"] = ps.hold_to_reference(got, fast)
        del got, ref, fast
        torch.cuda.empty_cache()
        for name, steps in (("late_F7", 3), ("early_F2", 2)):
            st = main_path_static(name)
            state, rows = ps.main_path_state(st, dev, B)
            step = make_train_step(st, device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            calls = sharding.all_reduce_sum.calls
            reset_launches()
            times, losses = [], []
            for _ in range(steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                metrics = step(state, rows, generator=gen)
                end.record()
                losses.append(float(sharding.all_reduce_mean([metrics["loss"]])[0]))
                end.synchronize()
                times.append(start.elapsed_time(end))
            result[name] = {"launches": read_launches(), "ms": times, "losses": losses,
                            "expected": {n: steps * c
                                         for n, c in expected_launches(st).items()},
                            "bn_all_reduce_calls_per_step":
                                (sharding.all_reduce_sum.calls - calls) / steps,
                            "replicas_bit_equal": ps.replicas_equal(
                                [*state.depth_net.state_dict().values(),
                                 *state.pose_net.state_dict().values()])}
            del state, rows
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)


def dist_phase(torch, card, root):
    """Data parallelism (--dist.enabled):
    (a) two ranks on the one card, gloo with CUDA tensors (NCCL refuses two
        ranks on one device): `dist_child` in two processes at the main
        path's full width (640x192, global batch 12, 6 a rank), the float32
        step held to the one-process step and the ranks' replicas
        bit-equal, then bf16 steps timed (over gloo, which copies every
        collective through the host: not a figure of NCCL), each rank's
        kernel launches held to expected_launches;
    (b) cli.train --dist.enabled under `python -m torch.distributed.run
        --standalone --nproc_per_node 1` (NCCL): one epoch on the trees
        under `root`, then a resumed second; the lead (process 0 of 1)
        writes the checkpoints."""
    from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    outs = [os.path.join(root, f"dist_rank{r}.json") for r in range(DIST_RANKS)]
    init = f"file://{os.path.join(root, 'dist_rdv')}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-child",
                               str(r), init, outs[r]], cwd=here, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DIST_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    gloo_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"dist rank {r} exited {p.returncode}:\n{log[-3000:]}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    parity = ranks[0]["float32_vs_one_process"]
    check(parity["ok"] and all(r["replicas_bit_equal"] for r in ranks),
          f"dist (a): {DIST_RANKS} gloo ranks vs one process: {parity}, replicas "
          f"{[r['replicas_bit_equal'] for r in ranks]}")
    runs = {}
    for r in ranks:
        for name in ("late_F7", "early_F2"):
            got = r[name]
            check(got["launches"] == got["expected"] and got["replicas_bit_equal"]
                  and all(np.isfinite(got["losses"])),
                  f"dist (a) rank {r['rank']} {name}: launches {got['launches']}, expected "
                  f"{got['expected']}, replicas equal {got['replicas_bit_equal']}, losses "
                  f"{got['losses']}")
            runs[f"dist_gloo_rank{r['rank']}_{name}"] = {"launches": got["launches"]}
    print(f"dist (a), gloo with CUDA tensors, {DIST_RANKS} ranks on one card, global batch "
          f"{B}: float32 late_F7 step vs one process {json.dumps(parity)}; replicas bit-equal")
    for key in ("baseline_fast_variance_vs_one_process", "float32_vs_one_process_fast_variance"):
        print(f"dist (a) {key}: {json.dumps(ranks[0][key])}")
    for r in ranks:
        for name in ("late_F7", "early_F2"):
            got = r[name]
            print(f"timing dist (a) gloo rank {r['rank']} {name} ms/step (CUDA events, "
                  f"{B // DIST_RANKS} images a rank): {[round(t, 2) for t in got['ms']]}, "
                  f"losses {[round(v, 6) for v in got['losses']]}, "
                  f"{got['bn_all_reduce_calls_per_step']:.0f} BN all-reduce calls a step "
                  f"(forward; as many backward), launches "
                  f"{ {n: c for n, c in got['launches'].items() if c} } [{card}; gloo]")

    # (b) the CLI under torch.distributed.run, NCCL
    argv = ["--data.kt_path", os.path.join(root, "raw"),
            "--data.splits_dir", os.path.join(root, "splits"),
            "--log.log_dir", os.path.join(root, "logs"), "--log.model_name", "smoke_dist",
            "--log.log_frequency", "2", "--log.image_panels", "False", "--dist.enabled", "True"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "baseboostdepth_tpu_torch.cli.train", *argv]
    walls, texts = [], []
    for epochs in (1, 2):
        t0 = time.perf_counter()
        out = subprocess.run(cmd + ["--optim.num_epochs", str(epochs)], cwd=here, env=env,
                             capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
        walls.append(time.perf_counter() - t0)
        check(out.returncode == 0, f"dist (b) epoch {epochs - 1}: exit {out.returncode}\n"
                                   f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        texts.append(out.stdout)
    check("process 0 of 1" in texts[0] and "resumed from step 4" in texts[1],
          f"dist (b): runs printed {texts}")
    ckpt = CheckpointManager(os.path.join(root, "logs", "smoke_dist", "checkpoints"))
    check(ckpt.all_steps() == [4, 8], f"dist (b): checkpoints {ckpt.all_steps()}")
    saved, extra = ckpt.restore(None)
    check(saved["step"] == 8 and extra.get("epoch") == 1,
          f"dist (b): last checkpoint step {saved['step']}, metadata {extra}")
    with open(os.path.join(root, "logs", "smoke_dist", "metrics.jsonl")) as f:
        logged = [json.loads(ln) for ln in f]
    check(len(logged) == 2 and all(np.isfinite(m["loss"]) for m in logged),
          f"dist (b): metrics lines {logged}")
    v = torch.cuda.nccl.version()
    nccl = v if isinstance(v, int) else ".".join(map(str, v))
    print(f"dist (b): cli.train --dist.enabled under torch.distributed.run --nproc_per_node 1, "
          f"NCCL {nccl}: epoch 0 then resumed epoch 1, checkpoints {ckpt.all_steps()} from "
          f"the lead, logged losses {[round(m['loss'], 6) for m in logged]}; wall clock "
          f"{[round(w, 2) for w in walls]} s (process start, networks' init, 4 steps, "
          f"checkpoint) [{card}]")
    return runs, {"gloo_float32_check": parity,
                  "baseline_fast_variance_vs_one_process":
                      ranks[0]["baseline_fast_variance_vs_one_process"],
                  "gloo_s": gloo_s, "nccl": nccl, "cli_nccl_s": walls}


def finite_metrics(what, result: dict) -> dict:
    check(result and all(np.isfinite(v) for v in result.values()), f"{what}: metrics {result}")
    return result


def non_empty(*paths) -> None:
    for path in paths:
        check(os.path.isfile(path) and os.path.getsize(path) > 0, f"missing or empty: {path}")


def eval_phase(torch, card, root):
    """The evaluation and inference entry points on the trainer phase's
    checkpoint (md2 RN18 at 640x192, bf16; the config cli.train saved):
    evaluate_depth on the eigen split (mono with --save_pred_disps, then
    --ext_disp_to_eval on the saved stack, which must reproduce the live
    metrics exactly; --post_process; --stereo), on SYNS with --chamfer at
    full SYNS size; evaluate_pose on the odometry sequence; infer on a
    folder; visualize into an .avi. Then timings: predict_disparities'
    images/s (loader included) and the network's alone, the chamfer search
    on one full-size SYNS pair, and the card's chamfer distances against the
    CPU's on a 3000/4500-point cloud."""
    from baseboostdepth_tpu_torch.cli import evaluate_depth, evaluate_pose, infer, visualize
    from baseboostdepth_tpu_torch.config import Config
    from baseboostdepth_tpu_torch.data import kitti
    from baseboostdepth_tpu_torch.evaluation.depth import (
        eval_static,
        make_disp_forward,
        predict_disparities,
        restore_state,
    )
    from baseboostdepth_tpu_torch.evaluation.syns import backproject_points, syns_intrinsics
    from baseboostdepth_tpu_torch.ops.chamfer import chamfer_nn_distances

    config = os.path.join(root, "logs", "smoke", "config.json")
    ckpt = os.path.join(root, "logs", "smoke", "checkpoints")
    base = ["--config", config, "--checkpoint", ckpt]
    saved = os.path.join(root, "disps.npy")
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    mono = finite_metrics("eigen mono", timed("eigen_mono", lambda: evaluate_depth.main(
        base + ["--save_pred_disps", saved])))
    non_empty(saved)
    check(np.load(saved).shape[0] == N_EVAL, "saved disparities' count")
    ext = timed("ext_disp", lambda: evaluate_depth.main(base + ["--ext_disp_to_eval", saved]))
    check(ext == mono, f"--ext_disp_to_eval {ext} differs from the live metrics {mono}")
    # the metric-depth path: the sql checkpoint of zoo_trainer_phase, whose
    # saved stack is metric depth at H/2, scored without inversion
    sql_base = ["--config", os.path.join(root, "logs", "smoke_sql", "config.json"),
                "--checkpoint", os.path.join(root, "logs", "smoke_sql", "checkpoints")]
    saved_sql = os.path.join(root, "depths_sql.npy")
    sql_mono = finite_metrics("eigen mono, sql", timed("eigen_mono_sql", lambda: evaluate_depth.main(
        sql_base + ["--save_pred_disps", saved_sql])))
    sql_depths = np.load(saved_sql)
    check(sql_depths.shape == (N_EVAL, H // 2, W // 2) and (sql_depths > 0).all(),
          f"sql saved depths {sql_depths.shape}")
    sql_ext = evaluate_depth.main(sql_base + ["--ext_disp_to_eval", saved_sql])
    check(sql_ext == sql_mono, f"sql --ext_disp_to_eval {sql_ext} differs from {sql_mono}")
    vit_base = ["--config", os.path.join(root, "logs", "smoke_monovit", "config.json"),
                "--checkpoint", os.path.join(root, "logs", "smoke_monovit", "checkpoints")]
    saved_vit = os.path.join(root, "disps_monovit.npy")
    finite_metrics("eigen mono, monovit", timed("eigen_mono_monovit", lambda: evaluate_depth.main(
        vit_base + ["--save_pred_disps", saved_vit])))
    check(np.load(saved_vit).shape == (N_EVAL, H, W), "monovit saved disparities' shape")
    pp = finite_metrics("eigen post_process", timed("eigen_pp", lambda: evaluate_depth.main(
        base + ["--post_process"])))
    stereo = finite_metrics("eigen stereo", timed("eigen_stereo", lambda: evaluate_depth.main(
        base + ["--stereo"])))
    check("median_ratio" not in stereo, "stereo protocol median-scaled")
    for name in ("gt_depths", "gt_edges", "gt_depths_val", "gt_edges_val"):
        non_empty(os.path.join(root, "splits", "SYNS", f"{name}.npz"))
    syns = finite_metrics("SYNS", timed("syns_chamfer", lambda: evaluate_depth.main(
        base + ["--split", "SYNS", "--chamfer"])))
    check({"f1", "iou", "edge_acc"} <= syns.keys(), f"SYNS metrics {syns}")

    odom_cfg = Config.load(config)
    odom_cfg.data.kt_path = os.path.join(root, "odom")
    odom_config = os.path.join(root, "odom.json")
    odom_cfg.save(odom_config)
    ates = finite_metrics("odometry", timed("pose", lambda: evaluate_pose.main(
        ["--config", odom_config, "--checkpoint", ckpt, "--sequence", "9",
         "--gt_poses", os.path.join(root, "poses09.txt")])))

    frames = os.path.join(root, "raw", KITTI_FOLDER, "image_02", "data")
    folder = os.path.join(root, "infer_in")
    os.makedirs(folder)
    for i in range(4):
        os.symlink(os.path.join(frames, f"{i:010d}.jpg"), os.path.join(folder, f"{i:010d}.jpg"))
    written = timed("infer", lambda: infer.main(base[:4] + [
        "--image_path", folder, "--out_dir", os.path.join(root, "infer_out")]))
    check(len(written) == 8, f"infer wrote {written}")
    non_empty(*written)
    gt = np.load(os.path.join(root, "splits", "eigen", "gt_depths.npz"), allow_pickle=True)["data"]
    np.savez_compressed(os.path.join(root, "gt4.npz"), data=gt[:4])
    video = timed("visualize", lambda: visualize.main([
        "--image_dir", folder, "--out", os.path.join(root, "compare.avi"),
        "--model", f"{config}:{ckpt}", "--gt_npz", os.path.join(root, "gt4.npz")]))
    non_empty(video)

    # predict_disparities alone (EvalLoader decode + LANCZOS included), and
    # the network alone on a batch of 16 (CUDA events)
    cfg = Config.load(config)
    st = eval_static(cfg)
    state = restore_state(cfg, ckpt)
    index = kitti.KittiRawIndex(cfg.data.kt_path,
                                os.path.join(root, "splits", "eigen", "test_files.txt"))
    paths = [index.image_path(s.folder, s.frame_index, s.side) for s in index.samples]
    predict_disparities(st, state.depth_net, paths[:16])  # warm-up
    disps = timed("predict", lambda: predict_disparities(st, state.depth_net, paths))
    check(disps.shape == (N_EVAL, st.height, st.width) and np.isfinite(disps).all(),
          "predict_disparities")
    fwd = make_disp_forward(st)
    x = torch.rand((16, st.height, st.width, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(3))
    net_ms = time_ms(torch, lambda: fwd(state.depth_net, x), iters=10)
    predict_rate = N_EVAL / times["predict"]
    net_rate = 16 / net_ms * 1e3

    # chamfer on one full-size SYNS pair: the GT cloud against a perturbed copy
    gt_syns = np.load(os.path.join(root, "splits", "SYNS", "gt_depths.npz"),
                      allow_pickle=True)["data"][0]
    rng = np.random.default_rng(1)
    pred_syns = gt_syns * rng.uniform(0.97, 1.03, gt_syns.shape).astype(np.float32)
    mask = (gt_syns > 1e-3) & (gt_syns < 125.0)
    inv_K3 = np.linalg.pinv(syns_intrinsics())
    p_pts = backproject_points(pred_syns, inv_K3, mask)
    g_pts = backproject_points(gt_syns, inv_K3, mask)
    chamfer_nn_distances(p_pts[:50000], g_pts[:50000])  # warm-up
    pnn, gnn = timed("chamfer_pair", lambda: chamfer_nn_distances(p_pts, g_pts))
    check(np.isfinite(pnn).all() and np.isfinite(gnn).all(), "chamfer distances")

    # the card's chamfer against the CPU's on a 3000/4500-point cloud at SYNS depths
    p = np.c_[rng.uniform(-60, 60, 3000), rng.uniform(-10, 10, 3000),
              rng.uniform(1, 125, 3000)].astype(np.float32)
    q = np.concatenate([p[:2000] + rng.normal(0, 0.05, (2000, 3)),
                        np.c_[rng.uniform(-60, 60, 2500), rng.uniform(-10, 10, 2500),
                              rng.uniform(1, 125, 2500)]]).astype(np.float32)
    card_nn = chamfer_nn_distances(p, q)
    cpu_nn = chamfer_nn_distances(p, q, device="cpu")
    cham_err = max(float(np.abs(a - b).max()) for a, b in zip(card_nn, cpu_nn))
    cham_d2_err = max(float(np.abs(a.astype(np.float64) ** 2 - b.astype(np.float64) ** 2).max())
                      for a, b in zip(card_nn, cpu_nn))
    # float32 rounding of |p|^2 + |q|^2 - 2 p.q: a few units in the last
    # place of the largest norm (~1.6e4 m^2, ulp ~2e-3)
    d2_bound = 16 * np.spacing(np.float32(max((p * p).sum(1).max(), (q * q).sum(1).max())))
    check(cham_d2_err <= d2_bound, f"chamfer card vs CPU: squared distances {cham_d2_err} apart "
                                   f"(bound {d2_bound})")

    print(f"eval: eigen mono {json.dumps(mono)}; sql (metric depth at {H // 2}x{W // 2}) eigen "
          f"mono {json.dumps(sql_mono)}, --ext_disp_to_eval equal; "
          f"post_process abs_rel {pp['abs_rel']:.4f}; "
          f"stereo abs_rel {stereo['abs_rel']:.4f}; --ext_disp_to_eval equal to the live run; "
          f"SYNS {json.dumps(syns)}; odometry {json.dumps(ates)}; infer wrote {len(written)} "
          f"files; visualize wrote {os.path.getsize(video)} B")
    print(f"timing eval: predict_disparities {predict_rate:.2f} images/s over {N_EVAL} KITTI "
          f"frames (batch 16, {cfg.model.dtype}, decode and LANCZOS resize of 1242x375 JPEGs "
          f"included); the network alone {net_ms:.3f} ms per batch of 16 = {net_rate:.1f} "
          f"images/s; CLI wall clock {json.dumps({k: round(v, 2) for k, v in times.items()})} "
          f"[{card}]")
    print(f"timing chamfer: {times['chamfer_pair'] * 1e3:.1f} ms for one full-size SYNS pair "
          f"({len(p_pts)} x {len(g_pts)} points, both directions); card vs CPU on 3000/4500 "
          f"points at SYNS depths: max |distance difference| {cham_err:.3e} m, squared "
          f"{cham_d2_err:.3e} m^2 (bound {d2_bound:.3e}) [{card}]")
    return {"predict_images_per_s": predict_rate, "net_ms_per_16": net_ms,
            "net_images_per_s": net_rate, "chamfer_pair_ms": times["chamfer_pair"] * 1e3,
            "chamfer_points": [len(p_pts), len(g_pts)], "chamfer_card_vs_cpu_max_abs": cham_err,
            "cli_s": times}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # fp32 convs of the parity phase in full fp32
    torch.cuda.set_device(0)
    card = card_line()
    print(card)

    build()
    many = image_count_checks(torch)
    corner, inputs = kernel_phase(torch, card)
    stats = {"corner_sweep": corner, **ssim_phase(torch, card),
             **packed_phase(torch, card, corner, inputs),
             **planes_phase(torch, card, corner, inputs)}
    grids = {"noise": inputs, **capture_step_grids(torch)}
    stats["corner_sweep"]["uint8_warp_checks"] = warp_u8_checks(torch)
    stats["warp_planes_fwd"]["warp_planes_checks"] = warp_planes_checks(torch)
    by_grid = warp_grid_phase(torch, card, grids)
    for name in GRID_KERNELS:
        stats[name].update(grid_stats(by_grid, name))
    del inputs, grids
    torch.cuda.empty_cache()
    for name in ("corner_sweep", "ssim_fused_fwd", "ssim_fused_bwd", "warp_packed_fwd",
                 "warp_packed_bwd", "warp_planes_fwd", "warp_planes_bwd"):
        stats[name]["image_count_check"] = many
    probe_run, probe_stats = probe_phase(torch, card)
    stats.update(probe_stats)
    parity_phase(torch)
    parity_phase(torch, **FUSED)
    parity_phase(torch, float_frames=True)
    parity_phase(torch, **RN50)
    parity_phase(torch, **CADEPTH)
    parity_phase(torch, height=128, width=512, **SQL)  # the SQL head needs 64 tokens
    parity_phase(torch, **MONOVIT)
    parity_phase(torch, **DIFFNET)
    drop_path_phase(torch)
    runs = {
        "probe_tool": probe_run,
        "late_F7": step_phase(torch, card, "late_F7", steps=3),
        "early_F2": step_phase(torch, card, "early_F2", steps=2),
        "late_F7_fused": step_phase(torch, card, "late_F7", steps=3, **FUSED),
        "early_F2_fused": step_phase(torch, card, "early_F2", steps=2, **FUSED),
        "late_F7_float": step_phase(torch, card, "late_F7", steps=3, float_frames=True),
        "early_F2_float": step_phase(torch, card, "early_F2", steps=2, float_frames=True),
        "late_F7_rn50": step_phase(torch, card, "late_F7", steps=3, **RN50),
        "early_F2_rn50": step_phase(torch, card, "early_F2", steps=2, **RN50),
        "late_F7_cadepth": step_phase(torch, card, "late_F7", steps=3, **CADEPTH),
        "early_F2_cadepth": step_phase(torch, card, "early_F2", steps=2, **CADEPTH),
        "late_F7_cadepth_fused": step_phase(torch, card, "late_F7", steps=3, **CADEPTH, **FUSED),
        "late_sql": step_phase(torch, card, "late_F7", steps=3, **SQL),
        "early_sql": step_phase(torch, card, "early_F2", steps=2, **SQL),
        "late_F7_pose_half": step_phase(torch, card, "late_F7", steps=3, **POSE_HALF),
        "late_F7_monovit": step_phase(torch, card, "late_F7", steps=3, **MONOVIT),
        "early_F2_monovit": step_phase(torch, card, "early_F2", steps=2, **MONOVIT),
        "late_F7_monovit_fused": step_phase(torch, card, "late_F7", steps=3, **MONOVIT, **FUSED),
        "late_F7_diffnet": step_phase(torch, card, "late_F7", steps=3, **DIFFNET),
        "early_F2_diffnet": step_phase(torch, card, "early_F2", steps=2, **DIFFNET),
    }
    steps = {name: {k: r[k] for k in ("ms_per_step", "peak_gb", "loss_rel_vs_uint8") if k in r}
             for name, r in runs.items() if name != "probe_tool"}
    print(f"steps (default options, {FUSED}, float frames, {RN50}, {CADEPTH}, {SQL}, "
          f"{POSE_HALF}, {MONOVIT}, {DIFFNET}): {json.dumps(steps)} [{card}]")

    from baseboostdepth_tpu_torch.cli import export_gt

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trees_", dir=build_dir) as root:
        t0 = time.perf_counter()
        write_trees(root)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gt_args = ["--split", "SYNS", "--syns_path", os.path.join(root, "syns"),
                   "--splits_dir", os.path.join(root, "splits")]
        export_gt.main(gt_args)
        export_gt.main(gt_args + ["--val"])
        export_s = time.perf_counter() - t0
        print(f"trees: KITTI raw, eigen test ({N_EVAL} frames), SYNS (1 test + 1 val scene), "
              f"odometry ({N_ODOM} frames) written in {write_s:.1f} s; SYNS GT exported "
              f"(test and val) in {export_s:.1f} s")
        runs["trainer"] = trainer_phase(torch, card, runs["early_F2"]["ms_per_step"], root)
        runs["trainer_zoos"] = zoo_trainer_phase(torch, card, root)
        evals = eval_phase(torch, card, root)
        torch.cuda.empty_cache()
        dist_runs, dist_stats = dist_phase(torch, card, root)
        runs.update(dist_runs)
    launches = {n: sum(r["launches"][n] for r in runs.values()) for n in KERNELS}
    check(all(launches.values()), f"a kernel of the path never launched: {launches}")

    probe = "tools/pallas_probe.py"
    sources = {"corner_sweep": "corner_sweep.cu", "ssim_fused_fwd": "ssim_fused.cu",
               "ssim_fused_bwd": "ssim_fused.cu", "warp_packed_fwd": "warp_packed.cu",
               "warp_packed_bwd": "warp_packed.cu", "warp_planes_fwd": "warp_planes.cu",
               "warp_planes_bwd": "warp_planes.cu", **dict.fromkeys(PROBE_KERNELS, "probe.cu")}
    replaces = {"corner_sweep": "baseboostdepth_tpu/ops/warp_pallas.py:525",
                "ssim_fused_fwd": "baseboostdepth_tpu/ops/ssim_pallas.py:59",
                "ssim_fused_bwd": "baseboostdepth_tpu/ops/ssim_pallas.py:109",
                "warp_packed_fwd": "baseboostdepth_tpu/ops/warp_pallas.py:236",
                "warp_packed_bwd": "baseboostdepth_tpu/ops/warp_pallas.py:254",
                "warp_planes_fwd": "baseboostdepth_tpu/ops/warp_pallas.py:276",
                "warp_planes_bwd": "baseboostdepth_tpu/ops/warp_pallas.py:289",
                "probe_scale": f"{probe}:36", "probe_gather_rows": f"{probe}:50",
                "probe_gather_cols": f"{probe}:80", "probe_row_slice": f"{probe}:132"}
    also_replaces = {"probe_gather_rows": [f"{probe}:65"],
                     "probe_gather_cols": [f"{probe}:95", f"{probe}:114"]}
    entries = []
    for name in KERNELS:
        entries.append({
            "name": name, "route": "cuda",
            "source": f"baseboostdepth_tpu_torch/ops/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name],
            **({"also_replaces": also_replaces[name]} if name in also_replaces else {}),
            **stats[name],
            "launches_by_run": {run: r["launches"][name] for run, r in runs.items()},
        })
    print(f"eval path: {json.dumps(evals)} [{card}]")
    print(f"dist: {json.dumps(dist_stats)} [{card}]")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start of main to the "
          "kernels' line")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        dist_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
