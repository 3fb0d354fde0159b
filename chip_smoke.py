"""Smoke run of the PyTorch port (baseboostdepth_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernel from ops/csrc/ (first use), prints ptxas'
     register report and lists the kernels built;
  3. holds the corner-sweep kernel against its plain PyTorch version at the
     main path's full shape (156 warps of 192x640 frames): corner planes
     exactly equal, the blended warp and its grid gradient against the plain
     float warp;
  4. checks the step on a small input against the same step on the CPU;
  5. trains the md2 main path at full width (640x192, batch 12, bf16
     networks): 3 steps of the late stage (F=7, scale 0, tri-min +
     incremental + partial + decomp, merged warp) and 2 of the early stage
     (F=2, scales 0-3, direct poses), with finite losses, moving parameters
     and BN statistics, and the kernel carrying every warp (launch counts);
  6. prints timings (CUDA events, after warm-up) beside the card's name and
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

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H, W, B = 192, 640, 12


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

    ms_gs = time_ms(torch, grid_sample_fwd)
    ms_gs_fb = time_ms(torch, grid_sample_fwd_bwd)
    bytes_moved = N * H * W * 3 + N * H * W * 8 + N * 4 * H * W * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"timing corner_sweep kernel: {ms_kernel:.4f} ms (bound {bound_ms:.4f} ms, "
          f"{bytes_moved / 1e9:.3f} GB) plain {ms_plain:.4f} ms [{card}]")
    print(f"timing corner warp fwd+bwd (kernel + blend + autodiff): {ms_corner_fb:.4f} ms [{card}]")
    print(f"timing F.grid_sample fwd: {ms_gs:.4f} ms, fwd+bwd: {ms_gs_fb:.4f} ms [{card}]")
    return {
        "max_abs_err": max_err, "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": bound_ms,
        "library_ms": ms_gs, "blend_max_abs_err": blend_err, "grid_grad_max_rel_err": grad_err,
        "corner_fwd_bwd_ms": ms_corner_fb, "grid_sample_fwd_bwd_ms": ms_gs_fb,
    }


def parity_phase(torch):
    """The step on a small input, on the card (kernel) and on the CPU (plain
    version), fp32 with TF32 off: the losses must agree."""
    from baseboostdepth_tpu_torch.training.batch import synthetic_batch
    from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, loss_forward

    st = StepStatic(height=64, width=128, F=2, scales=(0, 1, 2, 3), dtype="float32")
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
    check(rel <= 1e-4, f"small-input loss on the card {losses['cuda']} vs CPU {losses['cpu']}")
    print(f"parity check: 64x128 step loss card {losses['cuda']:.7f} vs CPU {losses['cpu']:.7f} "
          f"(rel {rel:.2e})")


def step_phase(torch, card, name, steps):
    from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc
    from baseboostdepth_tpu_torch.training.batch import synthetic_batch
    from baseboostdepth_tpu_torch.training.step import init_state, main_path_static, make_train_step

    st = main_path_static(name)
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

    wc.corner_sweep.launches = 0
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
    launches = wc.corner_sweep.launches

    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    check(launches == steps * len(st.scales),
          f"{name}: kernel launched {launches} times for {steps} steps x {len(st.scales)} scales")
    moved = any(not torch.equal(a, b) for a, b in zip(params0, state.depth_net.parameters()))
    check(moved, f"{name}: parameters did not change")
    stats1 = [b for n, b in state.pose_net.named_buffers() if "running_" in n]
    check(any(not torch.equal(a, b) for a, b in zip(stats0, stats1)),
          f"{name}: BN statistics did not change")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = times[1:]  # the first step is the warm-up
    ms = sum(timed) / len(timed)
    print(f"step {name}: losses {[round(v, 6) for v in losses]}, kernel launches {launches}, "
          f"peak memory {peak_gb:.2f} GB")
    print(f"timing {name} ms/step (CUDA events, mean of the {len(timed)} step(s) after one "
          f"warm-up step): {ms:.2f} (all steps {[round(t, 2) for t in times]}; "
          f"{B / ms * 1e3:.2f} imgs/s) [{card}]")
    del state, batch
    torch.cuda.empty_cache()
    return launches, ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from baseboostdepth_tpu_torch.ops import cuda_build
    from baseboostdepth_tpu_torch.ops import warp_cuda as wc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # fp32 convs of the parity phase in full fp32
    torch.cuda.set_device(0)
    card = card_line()
    print(card)

    t0 = time.perf_counter()
    wc._lib()
    build_s = time.perf_counter() - t0
    log = cuda_build.build_log("corner_sweep", wc._SOURCES)
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print("build:", line.strip())
    print(f"built kernels: {json.dumps(['corner_sweep'])} ({build_s:.1f} s incl. load)")

    k = kernel_phase(torch, card)
    parity_phase(torch)
    late_launches, late_ms = step_phase(torch, card, "late_F7", steps=3)
    early_launches, early_ms = step_phase(torch, card, "early_F2", steps=2)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "corner_sweep",
        "route": "cuda",
        "source": "baseboostdepth_tpu_torch/ops/csrc/corner_sweep.cu",
        "replaces": "baseboostdepth_tpu/ops/warp_pallas.py:525",
        "launches": late_launches + early_launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k["library_ms"],
        "library_call": "F.grid_sample(bilinear, border, align_corners=True) forward, "
                        "float32 frames, same grid (the blended warp, not the corner planes)",
        "blend_max_abs_err": k["blend_max_abs_err"],
        "grid_grad_max_rel_err": k["grid_grad_max_rel_err"],
        "corner_fwd_bwd_ms": k["corner_fwd_bwd_ms"],
        "grid_sample_fwd_bwd_ms": k["grid_sample_fwd_bwd_ms"],
        "late_ms_per_step": late_ms,
        "early_ms_per_step": early_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
