"""Smoke run of the PyTorch port (baseboostdepth_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from ops/csrc/ (first use; the two libraries
     in parallel), prints ptxas' register report and lists the kernels
     built;
  3. holds the corner-sweep kernel against its plain PyTorch version at the
     main path's full shape (156 warps of 192x640 frames): corner planes
     exactly equal, the blended warp and its grid gradient against the plain
     float warp;
  4. holds the fused SSIM forward and backward kernels against their plain
     versions at the late stage's photometric shape (84 images of 192x640,
     with a region where prediction and target are tied), and the packed
     warp's forward and backward kernels against theirs and against the
     corner-plane warp at the shape of step 3;
  5. holds the float-planes warp's forward and backward kernels against
     their plain versions on the same frames as float32 (/ 255) and grid,
     and on a small two-channel case; the forward against the packed warp,
     the grid gradient against F.grid_sample's;
  6. checks the step on a small input against the same step on the CPU,
     with the default options, with photo_impl="fused", warp_impl="pallas",
     and with float frames;
  7. trains the md2 main path at full width (640x192, batch 12, bf16
     networks): 3 steps of the late stage (F=7, scale 0, tri-min +
     incremental + partial + decomp, merged warp) and 2 of the early stage
     (F=2, scales 0-3, direct poses), with the default options, with
     photo_impl="fused", warp_impl="pallas", and with float frames (the
     float-planes warp); finite losses, moving parameters and BN
     statistics, and every kernel's launches counted in each run and held
     to the counts the step's structure implies;
  8. runs the training entry point (cli.train) on a KITTI-raw tree of
     random JPEGs it writes under build/: one epoch at the default
     configuration, ending in a checkpoint, then again with two epochs,
     which must resume from it;
  9. prints timings (CUDA events, after warm-up) beside the card's name and
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
KERNELS = ("corner_sweep", "ssim_fused_fwd", "ssim_fused_bwd", "warp_packed_fwd",
           "warp_packed_bwd", "warp_planes_fwd", "warp_planes_bwd")
FUSED = dict(photo_impl="fused", warp_impl="pallas")

# float32 operations per pixel, counted in the kernels' source (adds,
# multiplies, divides, compares; index arithmetic not counted). SSIM
# forward: per channel 57 for the row sums of x, y, x^2, y^2, xy, 15 for the
# window means, 6 for the variances, 14 for SSIM's numerator and
# denominator, 5 for the divide and clip, 7 for L1 and the weighted sum.
# SSIM backward: the forward's moments and quotient (97 per channel), 17
# for the chain through the clip and the quotient, 54 for the three 3x3
# adjoint sums, 12 for the final combination. Packed warp: per channel 16
# to unpack four texels and 9 to blend (forward) or 14 for the two
# coordinate derivatives and their sums (backward), plus 4 for the weights.
# Float-planes warp: per channel 9 to blend (forward) or 14 (backward), plus
# 4 for the weights.
OPS_PER_PIXEL = {"ssim_fused_fwd": 3 * 104, "ssim_fused_bwd": 3 * 180,
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
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops import warp_planes as wp

    return {"corner_sweep": wc.corner_sweep, "ssim_fused_fwd": sc.ssim_fused_fwd,
            "ssim_fused_bwd": sc.ssim_fused_bwd, "warp_packed_fwd": wc.warp_packed_fwd,
            "warp_packed_bwd": wc.warp_packed_bwd, "warp_planes_fwd": wp.warp_planes_fwd,
            "warp_planes_bwd": wp.warp_planes_bwd}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {n: fn.launches for n, fn in kernel_wrappers().items()}


def build():
    """Build the kernel libraries at once, one nvcc each; print ptxas'
    report of each."""
    from baseboostdepth_tpu_torch.ops import cuda_build
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops import warp_planes as wp

    mods = (wc, sc, wp)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        for f in [pool.submit(mod._lib) for mod in mods]:
            f.result()
    build_s = time.perf_counter() - t0
    for mod in mods:
        for line in cuda_build.build_log(mod.LIB_NAME, mod.SOURCES).splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                print("build:", line.strip())
    print(f"built kernels: {json.dumps(list(KERNELS))} ({build_s:.1f} s incl. load, "
          f"{len(mods)} libraries built in parallel)")


def kernel_phase(torch, card):
    from baseboostdepth_tpu_torch.ops import clip
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.ops.sampling import bilinear_sample

    dev = torch.device("cuda", 0)
    N = B * 13  # late stage: 2S-1 = 13 merged slots per sample
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (N, H, W, 3), dtype=torch.uint8, device=dev, generator=gen)
    # KITTI-scale displacement around the identity grid; ~10% of points land
    # outside the image, and some exactly on its borders
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

    # corner planes: kernel vs plain version, exactly
    c_kernel = wc.corner_sweep(frames, x, y)
    c_plain = wc.corner_sweep_reference(frames, x, y)
    torch.cuda.synchronize()
    check(c_kernel.shape == (N, 4, H, W) and c_kernel.dtype == torch.int32, "corner plane shape")
    max_err = int((c_kernel.long() - c_plain.long()).abs().max())
    check(torch.equal(c_kernel, c_plain), f"corner planes differ from the plain version ({max_err})")
    print(f"kernel check: corner planes exactly equal to the plain version at N={N} {H}x{W}")

    # blend + grid gradient: kernel path vs the plain float warp
    ct = torch.rand((N, H, W, 3), device=dev, generator=gen)
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

    # timings at the main path's shape
    ms_kernel = time_ms(torch, lambda: wc.corner_sweep(frames, x, y))
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
    bytes_moved = N * H * W * 3 + N * H * W * 8 + N * 4 * H * W * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"timing corner_sweep kernel: {ms_kernel:.4f} ms (bound {bound_ms:.4f} ms, "
          f"{bytes_moved / 1e9:.3f} GB) plain {ms_plain:.4f} ms [{card}]")
    print(f"timing corner warp fwd+bwd (kernel + blend + autodiff): {ms_corner_fb:.4f} ms [{card}]")
    print(f"timing F.grid_sample fwd: {ms_gs:.4f} ms, fwd+bwd: {ms_gs_fb:.4f} ms, "
          f"grid gradient alone (grid_sampler_2d_backward): {ms_gs_bwd:.4f} ms [{card}]")
    stats = {
        "max_abs_err": max_err, "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": ms_gs,
        "library_call": "F.grid_sample(bilinear, border, align_corners=True) forward, float32 "
                        "frames, same grid (the blended warp, not the corner planes)",
        "blend_max_abs_err": blend_err, "grid_grad_max_rel_err": grad_err,
        "corner_fwd_bwd_ms": ms_corner_fb, "grid_sample_fwd_bwd_ms": ms_gs_fb,
        "grid_sample_grid_grad_ms": ms_gs_bwd,
    }
    return stats, dict(frames=frames, grid=grid, x=x, y=y, ct=ct)


def ssim_phase(torch, card):
    """The fused SSIM kernels against their plain versions at the late
    stage's photometric shape: 84 images (12 samples x 7 warp slots)."""
    from baseboostdepth_tpu_torch.ops import ssim as ts
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc

    dev = torch.device("cuda", 0)
    N = B * 7
    gen = torch.Generator(device=dev).manual_seed(2)
    # a textured target (3x3-smoothed noise) and a warped-like prediction:
    # the target shifted by one pixel plus noise, equal to it on one block
    # (a static region: q = 0 over whole windows) that meets the image's
    # corner, where the reflect fold acts
    noise = torch.rand((N, 3, H, W), device=dev, generator=gen)
    tgt = torch.nn.functional.avg_pool2d(noise, 3, 1, 1, count_include_pad=False)
    tgt = tgt.permute(0, 2, 3, 1).contiguous()
    pred = torch.roll(tgt, 1, dims=2) + 0.05 * torch.randn(tgt.shape, device=dev, generator=gen)
    pred = pred.clamp(0.0, 1.0)
    pred[:, :48, :160] = tgt[:, :48, :160]
    pred = pred.contiguous()
    g = torch.rand((N, H, W, 1), device=dev, generator=gen)

    out_k = sc.ssim_fused_fwd(pred, tgt)
    out_p = sc.ssim_fused_fwd_reference(pred, tgt)
    gx_k = sc.ssim_fused_bwd(pred, tgt, g)
    gx_p = sc.ssim_fused_bwd_reference(pred, tgt, g)
    torch.cuda.synchronize()
    check(out_k.shape == (N, H, W, 1) and gx_k.shape == (N, H, W, 3), "SSIM kernel shapes")
    check(bool(torch.isfinite(out_k).all() and torch.isfinite(gx_k).all()), "SSIM non-finite")
    fwd_err = float((out_k - out_p).abs().max())
    bwd_err = float((gx_k - gx_p).abs().max())
    bwd_rel = bwd_err / float(gx_p.abs().max())
    check(fwd_err <= 1e-5, f"SSIM forward differs from its plain version by {fwd_err}")
    check(bwd_rel <= 1e-4, f"SSIM backward differs from its plain version by {bwd_rel} (relative)")
    # inside the tied block every window has q = 0 (inactive) and x = y
    tied = float(gx_k[:, 2:46, 2:158].abs().max())
    check(tied == 0.0, f"SSIM backward inside the tied block: {tied}, expected 0")
    print(f"kernel check: ssim_fused_fwd max abs err {fwd_err:.3e}, ssim_fused_bwd max abs err "
          f"{bwd_err:.3e} ({bwd_rel:.3e} of its largest value), tied block gradient 0, "
          f"at N={N} {H}x{W}")

    ms_fwd = time_ms(torch, lambda: sc.ssim_fused_fwd(pred, tgt))
    ms_bwd = time_ms(torch, lambda: sc.ssim_fused_bwd(pred, tgt, g))
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
    pixels = N * H * W
    b_fwd = bound("ssim_fused_fwd", pixels * (12 + 12 + 4), pixels)
    b_bwd = bound("ssim_fused_bwd", pixels * (12 + 12 + 4 + 12), pixels)
    print(f"timing ssim_fused_fwd kernel: {ms_fwd:.4f} ms (bound {b_fwd[0]:.4f} ms, {b_fwd[1]}) "
          f"plain {ms_fwd_plain:.4f} ms [{card}]")
    print(f"timing ssim_fused_bwd kernel: {ms_bwd:.4f} ms (bound {b_bwd[0]:.4f} ms, {b_bwd[1]}) "
          f"plain {ms_bwd_plain:.4f} ms [{card}]")
    print(f"timing fused photometric loss fwd+bwd: {ms_fused_fb:.4f} ms; ops/ssim.py "
          f"reprojection_loss fwd: {ms_xla:.4f} ms, fwd+bwd: {ms_xla_fb:.4f} ms [{card}]")
    reason = "none: no single PyTorch call computes SSIM"
    common = {"xla_fwd_ms": ms_xla, "xla_fwd_bwd_ms": ms_xla_fb, "fused_fwd_bwd_ms": ms_fused_fb,
              "library_call": reason}
    return {
        "ssim_fused_fwd": {"max_abs_err": fwd_err, "ms": ms_fwd, "plain_ms": ms_fwd_plain,
                           "bound_ms": b_fwd[0], "bound_by": b_fwd[1], "library_ms": None,
                           **common},
        "ssim_fused_bwd": {"max_abs_err": bwd_err, "max_rel_err": bwd_rel, "ms": ms_bwd,
                           "plain_ms": ms_bwd_plain, "bound_ms": b_bwd[0], "bound_by": b_bwd[1],
                           "library_ms": None, **common},
    }


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
    check(fwd_err <= 1e-6, f"packed warp forward differs from its plain version by {fwd_err}")
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

    ms_fwd = time_ms(torch, lambda: wc.warp_packed_fwd(frames, x, y))
    ms_bwd = time_ms(torch, lambda: wc.warp_packed_bwd(frames, x, y, ct))
    ms_fwd_plain = time_ms(torch, lambda: wc.warp_packed_fwd_reference(frames, x, y), iters=5)
    ms_bwd_plain = time_ms(torch, lambda: wc.warp_packed_bwd_reference(frames, x, y, ct),
                           iters=5)

    def packed_fwd_bwd():
        g = grid.detach().requires_grad_(True)
        (wc.bilinear_sample_packed_u8(frames, g) * ct).sum().backward()

    ms_fb = time_ms(torch, packed_fwd_bwd)
    pixels = N * H * W
    texels = frames.numel()
    b_fwd = bound("warp_packed_fwd", texels + pixels * (8 + 12), pixels)
    b_bwd = bound("warp_packed_bwd", texels + pixels * (8 + 12 + 8), pixels)
    print(f"timing warp_packed_fwd kernel: {ms_fwd:.4f} ms (bound {b_fwd[0]:.4f} ms, "
          f"{b_fwd[1]}) plain {ms_fwd_plain:.4f} ms [{card}]")
    print(f"timing warp_packed_bwd kernel: {ms_bwd:.4f} ms (bound {b_bwd[0]:.4f} ms, "
          f"{b_bwd[1]}) plain {ms_bwd_plain:.4f} ms [{card}]")
    print(f"timing packed warp fwd+bwd (two kernels + clip): {ms_fb:.4f} ms; corner warp "
          f"fwd+bwd {k['corner_fwd_bwd_ms']:.4f} ms [{card}]")
    common = {"packed_fwd_bwd_ms": ms_fb, "corner_fwd_bwd_ms": k["corner_fwd_bwd_ms"],
              "grid_grad_vs_corner_max_rel_err": grid_rel}
    return {
        "warp_packed_fwd": {
            "max_abs_err": fwd_err, "corner_max_abs_err": corner_err, "ms": ms_fwd,
            "plain_ms": ms_fwd_plain, "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
            "library_ms": k["library_ms"],
            "library_call": "F.grid_sample(bilinear, border, align_corners=True) forward, "
                            "float32 frames, same grid", **common},
        "warp_packed_bwd": {
            "max_abs_err": bwd_err, "max_rel_err": bwd_rel, "ms": ms_bwd,
            "plain_ms": ms_bwd_plain, "bound_ms": b_bwd[0], "bound_by": b_bwd[1],
            "library_ms": k["grid_sample_grid_grad_ms"],
            "library_call": "aten.grid_sampler_2d_backward(bilinear, border, "
                            "align_corners=True, output_mask=[False, True]): the grid "
                            "gradient alone, float32 frames, same grid and cotangent",
            "grid_sample_fwd_bwd_ms": k["grid_sample_fwd_bwd_ms"], **common},
    }


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

    ms_fwd = time_ms(torch, lambda: wp.warp_planes_fwd(src, x, y))
    ms_bwd = time_ms(torch, lambda: wp.warp_planes_bwd(src, x, y, ct))
    ms_fwd_plain = time_ms(torch, lambda: wp.warp_planes_fwd_reference(src, x, y), iters=5)
    ms_bwd_plain = time_ms(torch, lambda: wp.warp_planes_bwd_reference(src, x, y, ct), iters=5)

    def planes_fwd_bwd():
        g = grid.detach().requires_grad_(True)
        (wp.bilinear_sample_planes(src, g) * ct).sum().backward()

    ms_fb = time_ms(torch, planes_fwd_bwd)
    pixels = N * H * W
    b_fwd = bound("warp_planes_fwd", src.numel() * 4 + pixels * (8 + 12), pixels)
    b_bwd = bound("warp_planes_bwd", src.numel() * 4 + pixels * (8 + 12 + 8), pixels)
    print(f"timing warp_planes_fwd kernel: {ms_fwd:.4f} ms (bound {b_fwd[0]:.4f} ms, "
          f"{b_fwd[1]}) plain {ms_fwd_plain:.4f} ms [{card}]")
    print(f"timing warp_planes_bwd kernel: {ms_bwd:.4f} ms (bound {b_bwd[0]:.4f} ms, "
          f"{b_bwd[1]}) plain {ms_bwd_plain:.4f} ms [{card}]")
    print(f"timing planes warp fwd+bwd (two kernels + clip): {ms_fb:.4f} ms; F.grid_sample "
          f"fwd+bwd {k['grid_sample_fwd_bwd_ms']:.4f} ms [{card}]")
    common = {"planes_fwd_bwd_ms": ms_fb, "grid_sample_fwd_bwd_ms": k["grid_sample_fwd_bwd_ms"],
              "packed_u8_max_abs_gap": u8_gap, "grid_sample_max_abs_err": gs_val,
              "grid_grad_vs_grid_sample_max_rel_err": gs_grad, "c2_max_abs_err": small_err}
    return {
        "warp_planes_fwd": {
            "max_abs_err": fwd_err, "ms": ms_fwd, "plain_ms": ms_fwd_plain,
            "bound_ms": b_fwd[0], "bound_by": b_fwd[1], "library_ms": k["library_ms"],
            "library_call": "F.grid_sample(bilinear, border, align_corners=True) forward, "
                            "the same float32 frames (NCHW) and grid", **common},
        "warp_planes_bwd": {
            "max_abs_err": bwd_err, "ms": ms_bwd, "plain_ms": ms_bwd_plain,
            "bound_ms": b_bwd[0], "bound_by": b_bwd[1],
            "library_ms": k["grid_sample_grid_grad_ms"],
            "library_call": "aten.grid_sampler_2d_backward(bilinear, border, "
                            "align_corners=True, output_mask=[False, True]): the grid "
                            "gradient alone, the same float32 frames, grid and cotangent",
            **common},
    }


def as_float_frames(torch, batch):
    """The batch with its uint8 frames as float32 in [0, 1] (frames / 255)."""
    return dict(batch, frames=batch["frames"].to(torch.float32) / 255.0)


def parity_phase(torch, float_frames=False, **options):
    """The step on a small input, on the card (kernels) and on the CPU (plain
    versions), fp32 with TF32 off: the losses must agree."""
    from baseboostdepth_tpu_torch.training.batch import synthetic_batch
    from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, loss_forward

    st = StepStatic(height=64, width=128, F=2, scales=(0, 1, 2, 3), dtype="float32", **options)
    batch = synthetic_batch(2, batch=2, height=64, width=128, seed=5)
    noise = torch.randn((2, 1, 64, 128), generator=torch.Generator().manual_seed(5)) * 1e-5
    losses = {}
    for dev in ("cuda", "cpu"):
        state = init_state(st, seed=3, device=dev)
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
    print(f"parity check {label}: 64x128 step loss card "
          f"{losses['cuda']:.7f} vs CPU {losses['cpu']:.7f} (rel {rel:.2e})")


def expected_launches(st, float_frames=False) -> dict:
    """Kernel launches per step that the step's structure implies. Per loss
    scale the merged warp is one warp call, and the main-slot and
    error-pose photometric losses are one call each; the identity
    candidates' loss is one call per step. Gradients reach the warped
    images only (the identity candidates are raw frames), so each warp and
    each loss call but the identity one runs its backward once. Float
    frames take the float-planes warp whatever warp_impl says."""
    S = len(st.scales)
    counts = dict.fromkeys(KERNELS, 0)
    if float_frames:
        counts.update(warp_planes_fwd=S, warp_planes_bwd=S)
    elif st.warp_impl == "pallas":
        counts.update(warp_packed_fwd=S, warp_packed_bwd=S)
    else:
        counts.update(corner_sweep=S)
    if st.photo_impl == "fused" and st.use_ssim:
        counts.update(ssim_fused_fwd=1 + 2 * S, ssim_fused_bwd=2 * S)
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


def write_kitti_tree(root: str, n_frames: int = 56, n_samples: int = 48) -> None:
    """A KITTI-raw tree at the raw size (1242x375 JPEGs): one drive, both
    cameras, smooth random images (a low-resolution random texture
    upsampled), and splits/eigen_zhou/train_files_baselines.txt whose
    baselines give windows of 2, 1 and 0 (stereo only) frames at the first
    epochs' cutoff. No val_files.txt / gt_depths.npz: no validation."""
    from PIL import Image

    folder = "2011_09_26/2011_09_26_drive_0001_sync"
    rng = np.random.default_rng(0)
    for cam in (2, 3):
        d = os.path.join(root, "raw", folder, f"image_0{cam}", "data")
        os.makedirs(d)
        for i in range(n_frames):
            base = rng.integers(30, 220, (12, 40, 3), dtype=np.uint8)
            img = Image.fromarray(base).resize((1242, 375), Image.BILINEAR)
            img.save(os.path.join(d, f"{i:010d}.jpg"), quality=90)
    first = (n_frames - n_samples) // 2
    baselines = (0.05, 0.1, 0.0, 0.05, 0.2, 0.03)
    lines = [f"{folder} {i} {'lr'[i % 2]} kt {baselines[i % len(baselines)]}"
             for i in range(first, first + n_samples)]
    splits = os.path.join(root, "splits", "eigen_zhou")
    os.makedirs(splits)
    with open(os.path.join(splits, "train_files_baselines.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def trainer_phase(torch, card, step_ms):
    """The training entry point at the default configuration (md2 RN18,
    640x192, batch 12, bf16, the full method with the curriculum, bucket_fs
    at its default) on a KITTI tree written under build/: cli.train.main for
    one epoch (4 steps, a metrics line at batch 2, ending in a checkpoint),
    then the CLI's trainer with two epochs, which must resume from that
    checkpoint at epoch 1 with the saved weights, and trains one more
    epoch; then the loader alone over that epoch's batches. Image panels are off: matplotlib is not installed on the card's
    machine (PERF.md)."""
    from baseboostdepth_tpu_torch.cli import train as cli
    from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
    from baseboostdepth_tpu_torch.data.loader import KittiTrainLoader

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_", dir=build_dir) as root:
        t0 = time.perf_counter()
        write_kitti_tree(root)
        write_s = time.perf_counter() - t0
        argv = ["--data.kt_path", os.path.join(root, "raw"),
                "--data.splits_dir", os.path.join(root, "splits"),
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
        expect["corner_sweep"] = 4 * steps  # default options, 4 loss scales at epochs 0-1
        check(launches == expect, f"trainer: kernel launches {launches}, expected {expect}")
        with open(os.path.join(root, "logs", "smoke", "metrics.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        check(len(logged) == 2 and all(np.isfinite(m["loss"]) for m in logged),
              f"trainer: metrics lines {logged}")
        ckpts = tr2.ckpt.all_steps()
        check(ckpts == [steps1, steps], f"trainer: checkpoints {ckpts}")

        # the loader alone over epoch 1's batches: its share of the epoch
        cfg = tr2.cfg
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in KittiTrainLoader(
            tr2.train_index, stage_for_epoch(1, cfg.method.trimin), cfg.optim.batch_size,
            cfg.data.height, cfg.data.width, trimin=cfg.method.trimin,
            num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
            seed=cfg.seed * 1000 + 1))
        loader_s = time.perf_counter() - t0
        check(n_loaded == steps1, f"trainer: the loader gave {n_loaded} batches")
    logged_rate = [m["imgs_per_sec"] for m in logged]
    epoch_rate = steps1 * B / wall2
    print(f"trainer: two runs of cli.train (epoch 0, then resumed at epoch 1 from step "
          f"{steps1}), {steps} steps, launches {launches['corner_sweep']} corner_sweep; "
          f"wrote 112 JPEGs in {write_s:.1f} s")
    print(f"timing trainer: logged imgs/s (wall clock since the epoch's start, loader "
          f"included) {[round(r, 2) for r in logged_rate]}; run 1 {wall1:.2f} s "
          f"(networks' init, {steps1} steps, checkpoint), run 2 train() {wall2:.2f} s "
          f"({epoch_rate:.2f} imgs/s over the epoch); the loader alone over that epoch "
          f"{loader_s:.2f} s ({steps1 * B / loader_s:.2f} imgs/s); the step alone (early_F2 "
          f"phase) {step_ms:.2f} ms/step = {B / step_ms * 1e3:.2f} imgs/s [{card}]")
    return {"launches": launches, "logged_imgs_per_s": logged_rate,
            "epoch_imgs_per_s": epoch_rate, "run1_s": wall1, "run2_train_s": wall2,
            "loader_epoch_s": loader_s}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # fp32 convs of the parity phase in full fp32
    torch.cuda.set_device(0)
    card = card_line()
    print(card)

    build()
    corner, inputs = kernel_phase(torch, card)
    stats = {"corner_sweep": corner, **ssim_phase(torch, card),
             **packed_phase(torch, card, corner, inputs),
             **planes_phase(torch, card, corner, inputs)}
    del inputs
    torch.cuda.empty_cache()
    parity_phase(torch)
    parity_phase(torch, **FUSED)
    parity_phase(torch, float_frames=True)
    runs = {
        "late_F7": step_phase(torch, card, "late_F7", steps=3),
        "early_F2": step_phase(torch, card, "early_F2", steps=2),
        "late_F7_fused": step_phase(torch, card, "late_F7", steps=3, **FUSED),
        "early_F2_fused": step_phase(torch, card, "early_F2", steps=2, **FUSED),
        "late_F7_float": step_phase(torch, card, "late_F7", steps=3, float_frames=True),
        "early_F2_float": step_phase(torch, card, "early_F2", steps=2, float_frames=True),
    }
    steps = {name: {k: r[k] for k in ("ms_per_step", "peak_gb", "loss_rel_vs_uint8") if k in r}
             for name, r in runs.items()}
    print(f"steps (default options, {FUSED}, float frames): {json.dumps(steps)} [{card}]")
    runs["trainer"] = trainer_phase(torch, card, runs["early_F2"]["ms_per_step"])
    launches = {n: sum(r["launches"][n] for r in runs.values()) for n in KERNELS}
    check(all(launches.values()), f"a kernel of the path never launched: {launches}")

    sources = {"corner_sweep": "corner_sweep.cu", "ssim_fused_fwd": "ssim_fused.cu",
               "ssim_fused_bwd": "ssim_fused.cu", "warp_packed_fwd": "warp_packed.cu",
               "warp_packed_bwd": "warp_packed.cu", "warp_planes_fwd": "warp_planes.cu",
               "warp_planes_bwd": "warp_planes.cu"}
    replaces = {"corner_sweep": "baseboostdepth_tpu/ops/warp_pallas.py:525",
                "ssim_fused_fwd": "baseboostdepth_tpu/ops/ssim_pallas.py:59",
                "ssim_fused_bwd": "baseboostdepth_tpu/ops/ssim_pallas.py:109",
                "warp_packed_fwd": "baseboostdepth_tpu/ops/warp_pallas.py:236",
                "warp_packed_bwd": "baseboostdepth_tpu/ops/warp_pallas.py:254",
                "warp_planes_fwd": "baseboostdepth_tpu/ops/warp_pallas.py:276",
                "warp_planes_bwd": "baseboostdepth_tpu/ops/warp_pallas.py:289"}
    entries = []
    for name in KERNELS:
        entries.append({
            "name": name, "route": "cuda",
            "source": f"baseboostdepth_tpu_torch/ops/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": launches[name],
            **stats[name],
            "launches_by_run": {run: r["launches"][name] for run, r in runs.items()},
        })
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
