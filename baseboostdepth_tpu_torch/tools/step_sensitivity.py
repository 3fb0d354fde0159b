"""How far rounding moves the float32 training step, on the card.

    python -m baseboostdepth_tpu_torch.tools.step_sensitivity [--zoo cadepth]

Runs the late main-path stage's float32 step (profile_step.float32_step:
TF32 and cuDNN off, global batch 12, random weights from seed 0) of a zoo
with its default warp schedule, and prints the card's name and two JSON lines:

- "bn": every train-mode BatchNorm call's conditioning: per channel E[x^2]
  / var (the factor by which the fast variance E[x^2] - E[x]^2 magnifies
  the rounding of its sums) and the error of rsqrt(var + eps) from the
  float32 fast variance against the float64 two-pass one; the largest of
  each over the calls, the channels clamped at 0 or below eps, and the
  worst calls;
- "perturbation": the whole gradient's relative L2 distance from the
  step's, for the same step repeated and for the step with the depth
  network's first convolution's weights scaled by 1 + 1e-7 noise (about
  float32's rounding). A step whose gradient moves by far more than 1e-7
  there cannot be held entry by entry against a step whose forward rounds
  otherwise.
"""

from __future__ import annotations

import argparse
import json

import torch

from baseboostdepth_tpu_torch import profile_step as ps
from baseboostdepth_tpu_torch.config import ModelConfig
from baseboostdepth_tpu_torch.models.resnet import BatchNorm2d
from baseboostdepth_tpu_torch.ops.batch_norm import bn_sums

STAGE = "late_F7"


def bn_conditioning(options: dict) -> dict:
    """The step's train-mode BatchNorm calls, each input read in float64."""
    calls, names = [], {}

    def record(module, args):
        if not (isinstance(module, BatchNorm2d) and module.training):
            return
        x = args[0].detach()
        C, n = x.shape[1], x.numel() // x.shape[1]
        sums = bn_sums(x).view(2, C).float()
        mean = sums[0] / n
        fast = torch.clamp(sums[1] / n - mean * mean, min=0.0).double()
        var, _ = torch.var_mean(x.double(), dim=(0, 2, 3), correction=0)
        cond = (x.double() ** 2).mean((0, 2, 3)) / var.clamp_min(1e-300)
        exact = (var + module.eps).rsqrt()
        err = ((fast + module.eps).rsqrt() - exact).abs() / exact
        calls.append({"name": names.get(id(module), "?"), "shape": list(x.shape),
                      "max_E_x2_over_var": float(cond.max()), "max_rsqrt_rel_err": float(err.max()),
                      "channels_clamped": int((fast == 0).sum()),
                      "channels_var_below_eps": int((var < module.eps).sum())})

    def name_modules(state):
        for tag, net in (("depth", state.depth_net), ("pose", state.pose_net)):
            names.update({id(m): f"{tag}.{n}" for n, m in net.named_modules()})

    hook = torch.nn.modules.module.register_module_forward_pre_hook(record)
    try:
        ps.float32_step(STAGE, ps.B, prepare=name_modules, **options)
    finally:
        hook.remove()
    worst = sorted(calls, key=lambda c: -c["max_rsqrt_rel_err"])[:4]
    return {"bn_calls": len(calls),
            "max_E_x2_over_var": max(c["max_E_x2_over_var"] for c in calls),
            "max_rsqrt_rel_err": max(c["max_rsqrt_rel_err"] for c in calls),
            "channels_clamped": sum(c["channels_clamped"] for c in calls),
            "channels_var_below_eps": sum(c["channels_var_below_eps"] for c in calls),
            "worst_calls": worst}


def perturb_first_conv(state) -> None:
    """Scale the depth network's first convolution's weights by 1 + 1e-7
    noise (seed 9)."""
    w = next(m for m in state.depth_net.modules() if isinstance(m, torch.nn.Conv2d)).weight
    gen = torch.Generator(device=w.device).manual_seed(9)
    with torch.no_grad():
        w.mul_(1 + 1e-7 * torch.randn(w.shape, generator=gen, device=w.device))


def gradient_distance(got: dict, ref: dict) -> float:
    diff2 = sum(float((got["grads"][n].double() - r.double()).norm()) ** 2
                for n, r in ref["grads"].items())
    norm2 = sum(float(r.double().norm()) ** 2 for r in ref["grads"].values())
    return (diff2 / norm2) ** 0.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--zoo", choices=["md2", "monovit", "cadepth", "diffnet", "sql"],
                    default="cadepth")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_sensitivity needs a CUDA device")
    # the warp schedule profile_step's --merged_warp auto takes
    options = {"zoo": args.zoo,
               "merged_warp": ModelConfig(zoo=args.zoo).resolved_merged_warp()}
    print(ps.card_name())
    print(json.dumps({"zoo": args.zoo, **options, "bn": bn_conditioning(options)}))
    ref = ps.float32_step(STAGE, ps.B, **options)
    again = ps.float32_step(STAGE, ps.B, **options)
    moved = ps.float32_step(STAGE, ps.B, prepare=perturb_first_conv, **options)
    print(json.dumps({"zoo": args.zoo, **options, "perturbation": {
        "repeat_grad_rel_l2": gradient_distance(again, ref),
        "first_conv_1e-7_grad_rel_l2": gradient_distance(moved, ref),
        "first_conv_1e-7_loss_rel": abs(moved["loss"] - ref["loss"]) / abs(ref["loss"])}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
