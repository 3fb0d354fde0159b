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
  5. checks the step on a small input against the same step on the CPU,
     with the default options and with photo_impl="fused",
     warp_impl="pallas";
  6. trains the md2 main path at full width (640x192, batch 12, bf16
     networks): 3 steps of the late stage (F=7, scale 0, tri-min +
     incremental + partial + decomp, merged warp) and 2 of the early stage
     (F=2, scales 0-3, direct poses), first with the default options, then
     with photo_impl="fused", warp_impl="pallas"; finite losses, moving
     parameters and BN statistics, and every kernel's launches counted in
     each run and held to the counts the step's structure implies;
  7. prints timings (CUDA events, after warm-up) beside the card's name and
     power limit, a JSON line describing each kernel, and last
     {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
Without a GPU, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
H, W, B = 192, 640, 12
KERNELS = ("corner_sweep", "ssim_fused_fwd", "ssim_fused_bwd", "warp_packed_fwd",
           "warp_packed_bwd")
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
OPS_PER_PIXEL = {"ssim_fused_fwd": 3 * 104, "ssim_fused_bwd": 3 * 180,
                 "warp_packed_fwd": 3 * 25 + 4, "warp_packed_bwd": 3 * 30 + 4}


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

    return {"corner_sweep": wc.corner_sweep, "ssim_fused_fwd": sc.ssim_fused_fwd,
            "ssim_fused_bwd": sc.ssim_fused_bwd, "warp_packed_fwd": wc.warp_packed_fwd,
            "warp_packed_bwd": wc.warp_packed_bwd}


def build():
    """Build both kernel libraries at once; print ptxas' report of each."""
    from baseboostdepth_tpu_torch.ops import cuda_build
    from baseboostdepth_tpu_torch.ops import ssim_cuda as sc
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(wc._lib), pool.submit(sc._lib)]:
            f.result()
    build_s = time.perf_counter() - t0
    for mod in (wc, sc):
        for line in cuda_build.build_log(mod.LIB_NAME, mod.SOURCES).splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                print("build:", line.strip())
    print(f"built kernels: {json.dumps(list(KERNELS))} ({build_s:.1f} s incl. load, "
          "two libraries built in parallel)")


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


def parity_phase(torch, **options):
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
        loss, _ = loss_forward(state.depth_net, state.pose_net, tb, st, noise=noise.to(dev))
        loss.backward()
        grads = [p.grad for p in state.depth_net.parameters() if p.grad is not None]
        check(all(bool(torch.isfinite(g).all()) for g in grads), f"non-finite gradient on {dev}")
        losses[dev] = float(loss.detach())
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    check(rel <= 1e-4, f"small-input loss {options} on the card {losses['cuda']} vs CPU "
                       f"{losses['cpu']}")
    print(f"parity check {options or 'default options'}: 64x128 step loss card "
          f"{losses['cuda']:.7f} vs CPU {losses['cpu']:.7f} (rel {rel:.2e})")


def expected_launches(st) -> dict:
    """Kernel launches per step that the step's structure implies. Per loss
    scale the merged warp is one warp call, and the main-slot and
    error-pose photometric losses are one call each; the identity
    candidates' loss is one call per step. Gradients reach the warped
    images only (the identity candidates are raw frames), so each warp and
    each loss call but the identity one runs its backward once."""
    S = len(st.scales)
    counts = dict.fromkeys(KERNELS, 0)
    if st.warp_impl == "pallas":
        counts.update(warp_packed_fwd=S, warp_packed_bwd=S)
    else:
        counts.update(corner_sweep=S)
    if st.photo_impl == "fused" and st.use_ssim:
        counts.update(ssim_fused_fwd=1 + 2 * S, ssim_fused_bwd=2 * S)
    return counts


def step_phase(torch, card, name, steps, **options):
    from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
    from baseboostdepth_tpu_torch.training.batch import synthetic_batch
    from baseboostdepth_tpu_torch.training.step import init_state, main_path_static, make_train_step

    st = main_path_static(name, **options)
    label = f"{name} {options}" if options else name
    state = init_state(st, seed=0, device="cuda", steps_per_epoch=3317)
    realistic_pose_bias_(state.pose_net)
    batch = {k: torch.as_tensor(v).to("cuda")
             for k, v in synthetic_batch(st.F, B, st.height, st.width, seed=st.F).items()}
    params0 = [p.detach().clone() for p in state.depth_net.parameters()]
    stats0 = [b.detach().clone() for n, b in state.pose_net.named_buffers() if "running_" in n]
    step = make_train_step(st, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
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
    launches = {n: fn.launches for n, fn in wrappers.items()}

    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    expect = {n: steps * c for n, c in expected_launches(st).items()}
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
    return {"launches": launches, "ms_per_step": ms, "peak_gb": peak_gb}


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
             **packed_phase(torch, card, corner, inputs)}
    del inputs
    torch.cuda.empty_cache()
    parity_phase(torch)
    parity_phase(torch, **FUSED)
    runs = {
        "late_F7": step_phase(torch, card, "late_F7", steps=3),
        "early_F2": step_phase(torch, card, "early_F2", steps=2),
        "late_F7_fused": step_phase(torch, card, "late_F7", steps=3, **FUSED),
        "early_F2_fused": step_phase(torch, card, "early_F2", steps=2, **FUSED),
    }
    launches = {n: sum(r["launches"][n] for r in runs.values()) for n in KERNELS}
    check(all(launches.values()), f"a kernel of the path never launched: {launches}")
    steps = {name: {"ms_per_step": r["ms_per_step"], "peak_gb": r["peak_gb"]}
             for name, r in runs.items()}
    print(f"steps (default options vs {FUSED}): {json.dumps(steps)} [{card}]")

    sources = {"corner_sweep": "corner_sweep.cu", "ssim_fused_fwd": "ssim_fused.cu",
               "ssim_fused_bwd": "ssim_fused.cu", "warp_packed_fwd": "warp_packed.cu",
               "warp_packed_bwd": "warp_packed.cu"}
    replaces = {"corner_sweep": "baseboostdepth_tpu/ops/warp_pallas.py:525",
                "ssim_fused_fwd": "baseboostdepth_tpu/ops/ssim_pallas.py:59",
                "ssim_fused_bwd": "baseboostdepth_tpu/ops/ssim_pallas.py:109",
                "warp_packed_fwd": "baseboostdepth_tpu/ops/warp_pallas.py:236",
                "warp_packed_bwd": "baseboostdepth_tpu/ops/warp_pallas.py:254"}
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
