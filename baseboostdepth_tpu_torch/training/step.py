"""The training step in PyTorch, the counterpart of
`baseboostdepth_tpu/training/step.py`: augmentation -> depth + pose forward
-> static candidate-slot warping -> min-reprojection loss -> Adam update.

Same design as the JAX step (see its docstring for the reference mapping):
all shapes static per curriculum stage (StepStatic), every pose pair the
stage needs stacked into ONE pose-net call, chained poses for incremental
stages (negative offsets chained properly), partial replacement as a masked
column splice, error-induced poses from the chained estimate before partial
replacement. The main-slot and error-pose warps run as one warp call over
2S-1 slots (merged_warp=True, the JAX package's default) or as two calls,
the main slots and then the error poses (merged_warp=False, the two-call
schedule; loss- and gradient-exact against the merged one). With
pose_input_scale != 1 the pose network sees the pairs bilinearly resized
(half-pixel, no antialiasing) to round(H*s/32)*32 x round(W*s/32)*32.
Zoos in DEPTH_IS_METRIC (SQLdepth) output metric depth, which the step
uses as depth; the others' disparities go through disp_to_depth.

Two kernel options, with the JAX package's names and defaults:
warp_impl "auto" / "corner" (the corner-plane warp) or "pallas" (the packed
warp, a forward and a backward kernel), and photo_impl "xla" (the plain
photometric loss of ops/ssim.py) or "fused" (the fused SSIM kernels of
ops/ssim_cuda.py, gradient into the warped images only). One deliberate
difference: the JAX step takes the fused photometric kernel only on a TPU
and its XLA path elsewhere; the port takes it whenever asked, so on CPU
tensors it runs the kernels' plain versions, as every port kernel does.

Frames may be uint8 (the loader's batches: colour = frames / 255, the warp
reads the uint8 frames through the kernel warp_impl selects) or float
(already in [0, 1]: used as they are, and warped by the float-planes kernel
pair of ops/warp_planes.py whatever warp_impl says, as in the JAX step).

PyTorch idiom: the networks are nn.Modules that hold their parameters and
BatchNorm buffers, the train step updates them in place, and the automask
noise, like the SQL head's dropout masks, comes from an explicit
torch.Generator (the noise may be passed in instead). Under
dtype="bfloat16" only the depth and pose networks run under autocast;
disparity sigmoids, the pose mean, geometry, the warp and the losses stay
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from baseboostdepth_tpu_torch import geometry, losses
from baseboostdepth_tpu_torch.data.augment import apply_flip, color_jitter
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.models import DEPTH_IS_METRIC, build_depth_net, build_pose_net
from baseboostdepth_tpu_torch.ops.resize import lanczos_pyramid, resize_bilinear
from baseboostdepth_tpu_torch.ops.sampling import bilinear_sample, resolve_warp
from baseboostdepth_tpu_torch.parallel.sharding import (
    average_gradients_,
    draw_local,
    local_rows,
    world_size,
)
from baseboostdepth_tpu_torch.training.batch import num_temporal_slots
from baseboostdepth_tpu_torch.training.optim import make_optimizer, make_vit_optimizer


@dataclasses.dataclass(frozen=True)
class StepStatic:
    zoo: str = "md2"
    num_layers: int = 18
    height: int = 192
    width: int = 640
    F: int = 2  # stage-wide max temporal offset (NF = 2F + 2)
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    trimin: bool = True
    incremental: bool = False  # chained poses active this stage
    partial: bool = False
    decomp: bool = True
    pose_error: float = 5.5
    use_ssim: bool = True
    min_depth: float = 0.1
    max_depth: float = 100.0
    smooth_weight: float = 1e-3
    # the reference divides by len(initial opt.scales) == 4 even in late
    # epochs that compute one scale (trainer.py:44 vs 568)
    loss_norm_scales: int = 4
    dtype: str = "float32"
    warp_impl: str = "auto"  # auto | corner | pallas (ops/sampling.py::resolve_warp)
    photo_impl: str = "xla"  # xla | fused (ops/ssim.py::reprojection_loss)
    # the pose network on pairs resized by this factor (1.0 = the reference)
    pose_input_scale: float = 1.0
    # main-slot and error-pose warps in one call (True) or two (False)
    merged_warp: bool = True

    @property
    def metric_depth(self) -> bool:
        return self.zoo in DEPTH_IS_METRIC


# The main path's two curriculum stages (bench.py's step classes): the late
# stage, the bench's worst class, and the early stage.
MAIN_PATH_STAGES = {
    "late_F7": dict(F=7, scales=(0,), incremental=True, partial=True),
    "early_F2": dict(F=2, scales=(0, 1, 2, 3), incremental=False, partial=False),
}


def main_path_static(stage: str, dtype: str = "bfloat16", **options) -> StepStatic:
    """StepStatic of one main-path stage at the published 640x192 width:
    md2 ResNet-18, tri-min + decomp, pose_error 5.5. `options` sets other
    fields, the stage's too, e.g. warp_impl="pallas", photo_impl="fused",
    or zoo="sql", scales=(0,)."""
    fields = dict(zoo="md2", num_layers=18, trimin=True, decomp=True, pose_error=5.5,
                  dtype=dtype, **MAIN_PATH_STAGES[stage])
    return StepStatic(**{**fields, **options})


@dataclasses.dataclass
class TrainState:
    step: int
    depth_net: nn.Module
    pose_net: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler

    def state_dict(self) -> dict:
        """Everything a resume needs: both networks (BatchNorm statistics
        included), Adam's moments, the schedule's position and the step."""
        return {"step": self.step, "depth_net": self.depth_net.state_dict(),
                "pose_net": self.pose_net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Restore `state_dict()`'s contents in place, onto the device the
        networks live on."""
        self.depth_net.load_state_dict(sd["depth_net"])
        self.pose_net.load_state_dict(sd["pose_net"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])


def build_networks(st: StepStatic, generator: Optional[torch.Generator] = None):
    # the decoder always owns all four disp heads; StepStatic.scales only
    # selects which scales enter the loss (reference trainer.py:88-89)
    depth_net = build_depth_net(st.zoo, st.num_layers, generator)
    pose_net = build_pose_net(generator)
    return depth_net, pose_net


def init_state(
    st: StepStatic,
    seed: int = 0,
    device="cuda",
    learning_rate: float = 1e-4,
    milestones: Sequence[int] = (11, 13, 15, 16, 17, 18, 19),
    gamma: float = 0.4,
    steps_per_epoch: int = 1,
    vit_encoder_lr: float = 5e-5,
) -> TrainState:
    """Networks initialised from `seed` (on the CPU, then moved to `device`
    in channels-last layout) and Adam under the MultiStep schedule; for
    monovit the two-group AdamW (the depth encoder at `vit_encoder_lr`), as
    the JAX trainer builds it."""
    device = require_device(device)
    gen = torch.Generator().manual_seed(seed)
    depth_net, pose_net = build_networks(st, gen)
    depth_net.to(device, memory_format=torch.channels_last)
    pose_net.to(device, memory_format=torch.channels_last)
    if st.zoo == "monovit":
        encoder = list(depth_net.encoder.parameters())
        ids = {id(p) for p in encoder}
        rest = [p for p in depth_net.parameters() if id(p) not in ids]
        opt, sched = make_vit_optimizer(encoder, rest + list(pose_net.parameters()),
                                        learning_rate, vit_encoder_lr, milestones, gamma,
                                        steps_per_epoch)
    else:
        params = list(depth_net.parameters()) + list(pose_net.parameters())
        opt, sched = make_optimizer(params, learning_rate, milestones, gamma, steps_per_epoch)
    return TrainState(0, depth_net, pose_net, opt, sched)


# --------------------------------------------------------------------------
# Pose pair table (static python -> one batched pose-net call)
# --------------------------------------------------------------------------
def _pose_pair_table(st: StepStatic):
    """Static (left_frame_index, right_frame_index) blocks on the NF axis.

    Incremental stage: [step+ g=1..F | step- g=1..F]. Direct stage:
    [dir+ g=1..F | dir- g=1..F]. Negative offsets feed (source, target) and
    are inverted (reference trainer.py:349-360, 380-402). Direct pairs for
    partial replacement are gathered per sample in predict_poses.
    """
    F = st.F
    left, right = [], []
    if st.incremental:
        for g in range(1, F + 1):  # step+ : (g-1, g)
            left.append(F + g - 1), right.append(F + g)
        for g in range(1, F + 1):  # step- : (-g, -g+1), inverted
            left.append(F - g), right.append(F - g + 1)
    else:
        for g in range(1, F + 1):
            left.append(F), right.append(F + g)
        for g in range(1, F + 1):
            left.append(F - g), right.append(F)
    return np.asarray(left), np.asarray(right)


def _n_slot_pairs(st: StepStatic) -> int:
    """Per-sample direct pose pairs partial replacement needs: slots 0..3
    where |offset| > 1, so 2 at F == 2, 4 at F >= 3, 0 below."""
    if not (st.incremental and st.partial):
        return 0
    if st.F < 2:
        return 0
    n = 2 if st.F == 2 else 4
    return min(n, num_temporal_slots(st.F, st.trimin))


def _pose_lut(st: StepStatic, aa: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(axisangle, translation) [B, 2F, 3] -> lut [B, 2F+1, 4, 4] with index
    o+F = T(0 -> o) (offset 0 = identity): chained under incremental,
    direct otherwise."""
    B = aa.shape[0]
    F = st.F
    eye = torch.eye(4, dtype=aa.dtype, device=aa.device).expand(B, 1, 4, 4)

    def lut_from(pos, neg):
        return torch.cat([neg.flip(1), eye, pos], dim=1)

    tfp = geometry.transformation_from_parameters
    if st.incremental:
        step_pos = tfp(aa[:, :F], t[:, :F], invert=False)
        step_neg = tfp(aa[:, F : 2 * F], t[:, F : 2 * F], invert=True)
        return lut_from(geometry.compose_poses(step_pos), geometry.compose_poses(step_neg))
    return lut_from(tfp(aa[:, :F], t[:, :F], invert=False), tfp(aa[:, F:], t[:, F:], invert=True))


def _gather_slots(lut: torch.Tensor, slot_offset: torch.Tensor, F: int) -> torch.Tensor:
    """lut [B, 2F+1, 4, 4], slot_offset [B, S] -> [B, S, 4, 4]."""
    idx = (slot_offset.long() + F)[:, :, None, None].expand(-1, -1, 4, 4)
    return torch.gather(lut, 1, idx)


def slot_poses(st, aa, t, slot_offset, slot_partial):
    """Per-slot poses from the batched pose-net outputs.

    aa / t [B, P, 3]: the first 2F entries are the static pair-table poses;
    with partial replacement the last _n_slot_pairs(st) entries are the
    per-sample slot-direct poses (even slot = forward pair, odd = reversed
    pair to invert). Returns (T_slot [B, S, 4, 4], T_err [B, S, 4, 4] or
    None); the error poses derive from the chained estimate BEFORE partial
    replacement (reference trainer.py:375-377 vs 407-418). Built out of
    place, so autograd sees no in-place update.
    """
    F = st.F
    lut = _pose_lut(st, aa[:, : 2 * F], t[:, : 2 * F])
    T_chain = _gather_slots(lut, slot_offset, F)

    T_err = None
    if st.decomp and st.trimin:
        Tc = T_chain.detach()
        top = torch.cat([Tc[..., :3, :3], Tc[..., :3, 3:] / st.pose_error], dim=-1)
        T_err = torch.cat([top, Tc[..., 3:, :]], dim=-2)

    T_slot = T_chain
    n_par = _n_slot_pairs(st)
    if n_par > 0:
        B = aa.shape[0]
        aa_d, t_d = aa[:, 2 * F :], t[:, 2 * F :]
        tfp = geometry.transformation_from_parameters
        T_even = tfp(aa_d[:, 0::2], t_d[:, 0::2], invert=False)
        T_odd = tfp(aa_d[:, 1::2], t_d[:, 1::2], invert=True)
        T_dir = torch.stack([T_even, T_odd], dim=2).reshape(B, n_par, 4, 4)
        head = T_chain[:, :n_par]
        T_repl = torch.cat([head[..., :, :3], T_dir[..., :, 3:]], dim=-1)
        pm = slot_partial[:, :n_par, None, None]
        T_slot = torch.cat([torch.where(pm, T_repl, head), T_chain[:, n_par:]], dim=1)
    return T_slot, T_err


@torch.no_grad()
def init_disp_bias(depth_net: nn.Module, value: float) -> None:
    """Set every disparity-head conv bias to `value` (a sigmoid logit); the
    cold-start aid of the JAX package's init_disp_bias, off unless
    configured. SQLdepth has no disparity heads: nothing changes."""
    for conv in depth_net.dispconvs():
        conv.bias.fill_(value)


def _depth_of(st: StepStatic, disp: torch.Tensor) -> torch.Tensor:
    """Depth from the depth network's output: SQLdepth's is metric depth
    already, the other zoos' disparities go through disp_to_depth."""
    if st.metric_depth:
        return disp
    return geometry.disp_to_depth(disp, st.min_depth, st.max_depth)[1]


def _autocast(st: StepStatic, device: torch.device):
    return torch.autocast(
        device_type=device.type, dtype=torch.bfloat16, enabled=st.dtype == "bfloat16"
    )


def predict_poses(st, pose_net, aug, slot_offset, slot_partial):
    """All per-slot poses via ONE batched pose-net call over the static pair
    table plus the per-sample slot-direct pairs partial replacement needs.

    aug [B, NF, H, W, 3] augmented frames -> (T_slot, T_err)."""
    B, _, H, W, _ = aug.shape
    F = st.F
    left, right = _pose_pair_table(st)
    left = torch.as_tensor(left, device=aug.device)
    right = torch.as_tensor(right, device=aug.device)
    pairs = torch.cat([aug[:, left], aug[:, right]], dim=-1)  # [B, P0, H, W, 6]

    n_par = _n_slot_pairs(st)
    if n_par > 0:
        idx = slot_offset[:, :n_par].long() + F
        src = aug[torch.arange(B, device=aug.device)[:, None], idx]  # [B, n_par, H, W, 3]
        tgt = aug[:, F : F + 1].expand_as(src)
        # even slots: (target, source); odd slots: (source, target), the
        # pose inverted in slot_poses (reference trainer.py:396-402, 410-415)
        even = (torch.arange(n_par, device=aug.device) % 2 == 0)[None, :, None, None, None]
        lhs = torch.where(even, tgt, src)
        rhs = torch.where(even, src, tgt)
        pairs = torch.cat([pairs, torch.cat([lhs, rhs], dim=-1)], dim=1)

    P = pairs.shape[1]
    flat = pairs.reshape(B * P, H, W, 6)
    if st.pose_input_scale != 1.0:
        flat = resize_bilinear(flat, int(round(H * st.pose_input_scale / 32)) * 32,
                               int(round(W * st.pose_input_scale / 32)) * 32)
    with _autocast(st, aug.device):
        aa, t = pose_net(flat)
    aa = aa.reshape(B, P, 3).float()
    t = t.reshape(B, P, 3).float()
    return slot_poses(st, aa, t, slot_offset, slot_partial)


# --------------------------------------------------------------------------
# Loss forward
# --------------------------------------------------------------------------
def loss_forward(
    depth_net: nn.Module,
    pose_net: nn.Module,
    batch: Dict[str, torch.Tensor],
    st: StepStatic,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    train: bool = True,
):
    """Returns (total_loss, metrics). In train mode the networks' BatchNorm
    running statistics are updated in place.

    batch: the training/batch.py dict as tensors on one device. noise: the
    automask noise [B, 1, H, W], already scaled by 1e-5; drawn from
    `generator` when not given. In a process group of W ranks the batch is
    this rank's rows of the global batch, the noise is drawn (or given) at
    the global batch [W*B, 1, H, W] and this rank takes its rows, and the
    networks' BatchNorm reduces over the global batch; the loss is this
    rank's share, whose gradient averaged over the ranks is the global
    batch's.
    """
    H, W, F = st.height, st.width, st.F
    NF = 2 * F + 2
    frames = batch["frames"]
    device = frames.device
    if frames.shape[1] != NF:
        raise ValueError(
            f"batch frame axis {frames.shape[1]} != 2F+2 = {NF}: the batch's "
            f"stage F and StepStatic.F disagree"
        )
    is_u8 = frames.dtype == torch.uint8
    warp_fn = resolve_warp(frames, st.warp_impl)
    frames = apply_flip(frames, batch["flip"])
    color = frames.to(torch.float32) / 255.0 if is_u8 else frames

    B = color.shape[0]
    aug = color_jitter(color, batch["jitter"])

    depth_net.train(train)
    pose_net.train(train)
    with _autocast(st, device):
        disps = depth_net(aug[:, F], generator=generator)

    T_slot, T_err = predict_poses(st, pose_net, aug, batch["slot_offset"], batch["slot_partial"])

    # all slots: S temporal + stereo
    T_slots = torch.cat([T_slot, batch["stereo_T"][:, None]], dim=1)

    stereo_idx = torch.full((B, 1), NF - 1, dtype=torch.long, device=device)
    src_idx = torch.cat([batch["slot_offset"].long() + F, stereo_idx], dim=1)
    sources_raw = frames[torch.arange(B, device=device)[:, None], src_idx]  # [B, S+1, H, W, 3]
    sources = sources_raw.to(torch.float32) / 255.0 if is_u8 else sources_raw
    # the warp reads the uint8 frames themselves, or the float frames
    warp_src = sources_raw if is_u8 else sources
    target = color[:, F]
    slot_valid = batch["slot_valid"]

    def photo_losses(images, valid):
        return losses.slot_losses(target, images, valid, use_ssim=st.use_ssim,
                                  impl=st.photo_impl)

    ident_l = photo_losses(sources, slot_valid)
    if noise is None:
        noise = draw_local(torch.randn, (B, 1, H, W), generator=generator, device=device) * 1e-5
    elif world_size() > 1:
        if noise.shape[0] != B * world_size():
            raise ValueError(f"noise has {noise.shape[0]} rows; the global batch has "
                             f"{B * world_size()}")
        noise = local_rows(noise)

    pyramid = lanczos_pyramid(target, num_scales=max(st.scales) + 1)

    K = batch["K"]
    inv_K = batch["inv_K"]

    def warp_all(depth_hw, Ts, src):
        """depth [B, H, W], Ts [B, S, 4, 4], src [B, S, H, W, 3] ->
        warped [B, S, H, W, 3]."""
        S = Ts.shape[1]
        depth_r = depth_hw[:, None].expand(B, S, H, W).reshape(B * S, H, W)
        # sample-major repeat (jnp.repeat), not Tensor.repeat
        K_r = K.repeat_interleave(S, dim=0)
        iK_r = inv_K.repeat_interleave(S, dim=0)
        grid = geometry.warp_grid(depth_r, K_r, iK_r, Ts.reshape(B * S, 4, 4))
        return warp_fn(src.reshape(B * S, H, W, 3), grid).reshape(B, S, H, W, 3)

    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    for s in st.scales:
        disp = disps[s]  # decoder returns all four scales, finest first
        disp_full = disp if disp.shape[1:3] == (H, W) else resize_bilinear(disp, H, W)
        depth = _depth_of(st, disp_full[..., 0])

        if T_err is not None and st.merged_warp:
            # one merged warp call: error slot i reuses main slot i's source
            # (T_err has S-1 slots)
            S_main, S_err = T_slots.shape[1], T_err.shape[1]
            both = warp_all(
                depth,
                torch.cat([T_slots, T_err], dim=1),
                torch.cat([warp_src[:, :S_main], warp_src[:, :S_err]], dim=1),
            )
            warped, warped_e = both[:, :S_main], both[:, S_main:]
        else:
            warped = warp_all(depth, T_slots, warp_src)
            warped_e = None
            if T_err is not None:  # the two-call schedule
                warped_e = warp_all(depth, T_err, warp_src[:, : T_err.shape[1]])
        warp_l = photo_losses(warped, slot_valid)

        err_l = None
        if warped_e is not None:
            err_l = photo_losses(warped_e, slot_valid[:, :-1])

        min_l = losses.min_reprojection(warp_l, ident_l, noise, err_l)
        loss_s = torch.mean(min_l)

        # SQL's head emits at H/2: upsampled before the smoothness term
        # (reference trainer.py:558-559)
        if st.smooth_weight:
            ps = pyramid[s]
            disp_sm = disp if disp.shape[1:3] == ps.shape[1:3] else resize_bilinear(
                disp, ps.shape[1], ps.shape[2]
            )
            nd = losses.normalized_disp(disp_sm)
            sm = losses.smooth_loss(nd, ps.to(nd.dtype))
            loss_s = loss_s + st.smooth_weight * sm / (2**s)

        metrics[f"loss/{s}"] = loss_s.detach()
        total = total + loss_s

    total = total / st.loss_norm_scales
    metrics["loss"] = total.detach()
    return total, metrics


# --------------------------------------------------------------------------
# The update
# --------------------------------------------------------------------------
def make_train_step(st: StepStatic, device="cuda"):
    """Build train_step(state, batch, generator=None, noise=None) -> metrics.

    The step moves the batch (numpy arrays or tensors) to `device`, runs
    loss_forward in train mode, back-propagates, takes one Adam step and one
    scheduler step, and advances state.step; the networks, BatchNorm
    statistics and optimizer state are updated in place. In a process group
    the batch is this rank's rows, the gradients are averaged over the
    ranks before the update (`parallel.average_gradients_`), and the
    metrics are this rank's.
    """
    device = require_device(device)

    def train_step(state: TrainState, batch, generator=None, noise=None):
        tb = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_forward(
            state.depth_net, state.pose_net, tb, st, generator=generator, noise=noise
        )
        loss.backward()
        average_gradients_([*state.depth_net.parameters(), *state.pose_net.parameters()])
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return metrics

    return train_step


def make_debug_forward(st: StepStatic, device="cuda"):
    """Build debug_fn(depth_net, pose_net, batch, generator=None) -> image
    panel tensors, the counterpart of the JAX package's make_debug_forward.

    The observability the reference gets from wandb image logging
    (trainer.py:736-772): target, disparity, per-slot warped candidates, the
    per-pixel min loss, and which candidate won (warp / identity /
    error-pose per slot -- the reference's `ident` masks,
    trainer.py:1046-1100). Networks in eval mode, no gradient, no
    augmentation. Run on demand at log time, never in the train loop; like
    the JAX one it warps with the plain gather (`ops.sampling.bilinear_sample`),
    not with the step's kernels.
    """
    device = require_device(device)

    @torch.no_grad()
    def debug_fn(depth_net: nn.Module, pose_net: nn.Module, batch, generator=None):
        H, W, F = st.height, st.width, st.F
        tb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        frames = tb["frames"]
        is_u8 = frames.dtype == torch.uint8
        frames = apply_flip(frames, tb["flip"])
        color = frames.to(torch.float32) / 255.0 if is_u8 else frames

        depth_net.eval()
        pose_net.eval()
        with _autocast(st, device):
            disps = depth_net(color[:, F])
        disp0 = disps[0].float()
        disp_full = disp0 if disp0.shape[1:3] == (H, W) else resize_bilinear(disp0, H, W)
        T_slot, T_err = predict_poses(st, pose_net, color, tb["slot_offset"], tb["slot_partial"])
        T_slots = torch.cat([T_slot, tb["stereo_T"][:, None]], dim=1)
        depth = _depth_of(st, disp_full[..., 0])

        B = color.shape[0]
        S = T_slots.shape[1]
        target = color[:, F]
        stereo_idx = torch.full((B, 1), 2 * F + 1, dtype=torch.long, device=device)
        src_idx = torch.cat([tb["slot_offset"].long() + F, stereo_idx], dim=1)
        sources = color[torch.arange(B, device=device)[:, None], src_idx]

        def warp(Ts):
            n = Ts.shape[1]
            d = depth[:, None].expand(B, n, H, W).reshape(B * n, H, W)
            grid = geometry.warp_grid(d, tb["K"].repeat_interleave(n, dim=0),
                                      tb["inv_K"].repeat_interleave(n, dim=0),
                                      Ts.reshape(B * n, 4, 4))
            return bilinear_sample(sources[:, :n].reshape(B * n, H, W, 3), grid).reshape(
                B, n, H, W, 3)

        warped = warp(T_slots)
        slot_valid = tb["slot_valid"]
        warp_l = losses.slot_losses(target, warped, slot_valid, use_ssim=st.use_ssim)
        ident_l = losses.slot_losses(target, sources, slot_valid, use_ssim=st.use_ssim)
        noise = torch.randn((B, 1, H, W), generator=generator, device=device) * 1e-5
        cands = [warp_l, ident_l + noise]
        if T_err is not None:
            cands.append(losses.slot_losses(target, warp(T_err), slot_valid[:, :-1],
                                            use_ssim=st.use_ssim))
        all_c = torch.cat(cands, dim=1)
        winner = torch.argmin(all_c, dim=1).to(torch.int32)
        return {
            "target": target,
            "disp": disp_full[..., 0],
            "depth": depth,
            "warped": warped,
            "min_loss": torch.amin(all_c, dim=1),
            # candidate index: 0..S-1 warp, S..2S-1 identity, 2S.. error
            "winner": winner,
            # automask = an identity candidate won (a stationary pixel)
            "automask": ((winner >= S) & (winner < 2 * S)).to(torch.float32),
        }

    return debug_fn


def make_eval_forward(st: StepStatic, device="cuda"):
    """Build eval_fn(depth_net, images [B, H, W, 3] float in [0, 1]) ->
    depth [B, h, w] float32 on `device`: the val()/evaluate path, disp_0 ->
    disp_to_depth (reference trainer.py:299-307), at full resolution; for
    SQLdepth its metric depth as it comes, at H/2 (the caller resizes to the
    GT). The counterpart of the JAX package's make_eval_forward. The
    network runs in eval mode without gradients."""
    device = require_device(device)

    @torch.no_grad()
    def eval_fn(depth_net: nn.Module, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(device, torch.float32)
        depth_net.eval()
        with _autocast(st, device):
            disps = depth_net(x)
        return _depth_of(st, disps[0].float()[..., 0])

    return eval_fn
