"""Data parallelism of the port's other zoos on the CPU: MonoViT, DIFFNet,
CADepth and SQLdepth, one train step each of two gloo processes against
one process on the same global batch from the same state
(tests/test_torch_port_dist.py holds md2 ResNet-18).

How it runs, as test_torch_port_dist.py: a module fixture starts this file
as two child processes (ranks 0 and 1 of a gloo group met through a
`file://` rendezvous in the test's temporary directory), at a lowered CPU
priority (tests/torch_port_helpers.py); both run all four zoos, one after
the other, while the pytest process computes the one-process references;
the children save what they saw to `.npz` / `.json` files.

The zoos, cut as test_torch_port_vit_step.py and test_torch_port_zoo_step.py
cut them, float32, global batch 2 (1 a rank), each from the port's init
(seed 0, the pose head biased to KITTI-scale motion), its random draws
from a generator seeded 11:
  monovit  the minimal MPViT (widths 16-64, 8 heads, one path and one block
           a stage) with drop-path on (rate 0.5: the four blocks at 0, 1/6,
           1/3 and 1/2), the late step (F=3, incremental + partial + decomp,
           scale 0), 64x128, its two-group AdamW (the depth encoder at 5e-5,
           the rest at 1e-4, weight decay 1e-4);
  diffnet  HRNet-18 with stages 3 and 4 cut to one module, the same step,
           Adam;
  cadepth  ResNet-50, the two-call warp schedule, F=2, scales 0-3, 64x128;
  sql      ResNet-50, the SQL head's dropout on (0.1), F=1, scale 0,
           128x512 (its head needs 64 patch tokens).

Held (measured on these inputs in brackets; none of the bounds is new):
  - replicas: both ranks' averaged gradients, parameters and BN statistics
    bit-equal, and their losses;
  - the draws: drop-path's and the feed-forward dropouts' masks, made
    through `draw_local` on each rank, are the rank's rows of the
    one-process draws, bit for bit (and the automask noise's); the SQL
    head's attention-dropout masks, one [1, 1, N, N] mask a call shared by
    the batch and the heads (flax's broadcast_dropout), are each the whole
    one-process mask on every rank;
  - each step against one process, the whole-step bounds that ROADMAP.md,
    C states for the zoo: losses 1e-6 relative; gradients per entry 1e-4
    relative + 2e-5, per tensor 3e-2 relative L2 + 1e-7 RMS; BN statistics
    1e-4 relative + a floor of each tensor's largest entry, 5e-5 for
    MonoViT and DIFFNet (batch-statistics BN deep in the encoder at batch
    2), 1e-5 for the pose network; the ResNet-50 depth networks (cadepth,
    sql) 6e-2 relative L2 per tensor and 6e-2 of the tensor's largest entry
    on top of the per-entry bound, BN floor 2e-4; parameters where both
    gradients exceed 4e-5 (for a ResNet-50 tensor, 4e-5 plus its per-entry
    allowance, beyond which the two gradients' signs agree) to 1e-6 after
    the update. [loss / entries beyond the relative part / worst tensor's
    relative L2 / BN statistics of the largest entry / parameters, measured
    on the tree with float64 BN sums and the SQL head's broadcast attention
    mask: monovit 9.4e-8 / 6.5e-7 / 3.1e-3 / 2.5e-7 / 7.5e-9; diffnet
    1.9e-7 / 1.8e-6 / 1.7e-3 / 1.9e-6 / 1.5e-8; cadepth 1.6e-7 / 1.4e-5 /
    1.8e-3 / 7.6e-6 / 1.5e-8; sql 0 / 1.6e-6 / 1.0e-3 / 0 / 6.0e-8.]
    DIFFNet held these bounds only once the BatchNorm sums were taken in
    float64 (ops/batch_norm.py): with float32
    sums its first conv's entries were 7.1e-5 beyond the relative part, the
    fast variance's autodiff cancelling in float32.
  - MonoViT's AdamW after `average_gradients_`: each parameter's update on
    rank 0 is its group's first AdamW step on the averaged gradient, p -
    lr * wd * p - lr * g / (|g| + 1e-8), to 1e-6, with lr 5e-5 for the
    depth encoder and 1e-4 for the rest.

Time: ~45-50 s on one worker (three processes side by side).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import (
    check_step,
    digest,
    lowered_priority,
    named,
    ranks_running,
    split,
    wait_ranks,
)

WORLD, B = 2, 2
GEN_SEED = 11
DROP_PATH = 0.5
CHILD_TIMEOUT_S = 400
ADAM_EPS = 1e-8
#: the smallest MPViT (test_torch_port_vit_step.py's MINIMAL)
MINIMAL = dict(embed_dims=(16, 32, 48, 64), num_path=(1, 1, 1, 1), num_layers=(1, 1, 1, 1),
               num_heads=(8, 8, 8, 8))
LATE = dict(H=64, W=128, F=3, scales=(0,), incremental=True, partial=True, f_max=(3, 2))
ZOOS = {
    "monovit": dict(zoo="monovit", num_layers=18, **LATE),
    "diffnet": dict(zoo="diffnet", num_layers=18, **LATE),
    "cadepth": dict(zoo="cadepth", num_layers=50, H=64, W=128, F=2, scales=(0, 1, 2, 3),
                    incremental=False, partial=False, f_max=(2, 1), merged_warp=False),
    "sql": dict(zoo="sql", num_layers=50, H=128, W=512, F=1, scales=(0,), incremental=False,
                partial=False, f_max=(1, 1)),
}
#: (BN floor of the depth network, whether its depth network is a ResNet-50)
BOUNDS = {"monovit": (5e-5, False), "diffnet": (5e-5, False), "cadepth": (2e-4, True),
          "sql": (2e-4, True)}


# --------------------------------------------------------------------------
# Shared by the children and the pytest process
# --------------------------------------------------------------------------
def depth_net(zoo, num_layers, generator):
    """StepStatic's depth network, with MonoViT and DIFFNet cut as the
    module docstring says (put in place of step.build_depth_net)."""
    from baseboostdepth_tpu_torch.models import build_depth_net
    from baseboostdepth_tpu_torch.models.depth_decoder import init_decoder_
    from baseboostdepth_tpu_torch.models.diffnet import HRNET18_STAGES, DIFFNetDepthNet
    from baseboostdepth_tpu_torch.models.monovit import MonoViTDepthNet
    from baseboostdepth_tpu_torch.models.resnet import init_encoder_

    if zoo == "monovit":
        net = MonoViTDepthNet(**MINIMAL, drop_path_rate=DROP_PATH)
        init_decoder_(net, generator)
        return net
    if zoo == "diffnet":
        cut = {**HRNET18_STAGES, "stage3": {**HRNET18_STAGES["stage3"], "modules": 1},
               "stage4": {**HRNET18_STAGES["stage4"], "modules": 1}}
        net = DIFFNetDepthNet(cut)
        init_encoder_(net.encoder, generator)
        init_decoder_(net.decoder, generator)
        return net
    return build_depth_net(zoo, num_layers, generator)


def statics(cfg):
    from baseboostdepth_tpu_torch.training.step import StepStatic

    return StepStatic(zoo=cfg["zoo"], num_layers=cfg["num_layers"], height=cfg["H"],
                      width=cfg["W"], F=cfg["F"], scales=cfg["scales"], trimin=True,
                      incremental=cfg["incremental"], partial=cfg["partial"], decomp=True,
                      pose_error=5.5, dtype="float32",
                      merged_warp=cfg.get("merged_warp", True))


def global_batch(cfg, seed):
    """B samples of smooth textured frames (sums of plane waves, as the
    step parity files make them), KITTI-like intrinsics, a stereo slot,
    colour jitter on the first sample, the second flipped."""
    from baseboostdepth_tpu_torch.data.augment import sample_jitter_params
    from baseboostdepth_tpu_torch.training.batch import make_batch, num_frames

    H, W, F, f_max = cfg["H"], cfg["W"], cfg["F"], cfg["f_max"]
    rng = np.random.default_rng(seed)
    NF = num_frames(F)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    k = rng.uniform(0.05, 0.2, (B, NF, 3, 3, 2))
    ph = rng.uniform(0, 2 * np.pi, (B, NF, 3, 3))
    waves = np.sin(k[..., 0, None, None] * x + k[..., 1, None, None] * y + ph[..., None, None])
    frames = np.clip(np.rint(127.5 + 40.0 * waves.sum(axis=3)), 0, 255).astype(np.uint8)
    frames = frames.transpose(0, 1, 3, 4, 2).copy()
    for b in range(B):  # loader contract: out-of-window frames copy frame 0
        for o in range(-F, F + 1):
            if abs(o) > f_max[b]:
                frames[b, o + F] = frames[b, F]
    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    stereo_T[:, 0, 3] = 0.1
    jitter = sample_jitter_params(rng, B, NF)
    jitter[0, :, :3] = rng.uniform(0.8, 1.2, (NF, 3))
    jitter[0, :, 3] = rng.uniform(-0.1, 0.1, NF)
    flip = np.arange(B) % 2 == 1
    return make_batch(frames, np.asarray(f_max), K, stereo_T, flip, jitter, F, True, True)


def recorded_draws(draws):
    """draw_local that also keeps a copy of each draw in `draws` (to stand
    in for the name in models/monovit.py, models/sql.py, training/step.py)."""
    from baseboostdepth_tpu_torch.parallel import sharding

    def draw_local(draw, shape, **kwargs):
        out = sharding.draw_local(draw, shape, **kwargs)
        draws.append(out.detach().clone().numpy())
        return out

    return draw_local


def recorded_attention_keep(masks):
    """models/sql.py's attention_keep that also keeps a copy of each mask in
    `masks` (wrapping the module's own function, not a recorder an earlier
    zoo put in its place)."""
    from baseboostdepth_tpu_torch.models import sql

    draw = getattr(sql.attention_keep, "unrecorded", sql.attention_keep)

    def attention_keep(*args, **kwargs):
        out = draw(*args, **kwargs)
        masks.append(out.detach().clone().numpy())
        return out

    attention_keep.unrecorded = draw
    return attention_keep


def run_zoo(name, patch):
    """One train step of zoo `name` on this process's rows of the global
    batch, from the port's init; `patch(module, attribute, value)` puts the
    cut networks and the draw recorders in place. Returns the global loss,
    the (averaged) gradients, the parameters and BN statistics after the
    step, the parameters before it with their AdamW group (lr, weight
    decay), the draws of a batch's leading shape in order, and the SQL
    head's attention-dropout masks in order."""
    from baseboostdepth_tpu_torch.models import monovit, sql
    from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
    from baseboostdepth_tpu_torch.parallel import all_reduce_mean, broadcast_state_, local_rows
    from baseboostdepth_tpu_torch.training import step as step_mod

    cfg = ZOOS[name]
    st = statics(cfg)
    draws, masks = [], []
    patch(step_mod, "build_depth_net", depth_net)
    for mod in (monovit, sql, step_mod):
        patch(mod, "draw_local", recorded_draws(draws))
    patch(sql, "attention_keep", recorded_attention_keep(masks))
    state = step_mod.init_state(st, device="cpu", steps_per_epoch=10)
    realistic_pose_bias_(state.pose_net)
    broadcast_state_([state.depth_net, state.pose_net])
    params0 = named(state, "params")
    groups = {}
    for g in state.optimizer.param_groups:
        ids = {id(p) for p in g["params"]}
        for net, m in (("depth", state.depth_net), ("pose", state.pose_net)):
            groups.update({f"{net}.{n}": (g["lr"], g["weight_decay"])
                           for n, p in m.named_parameters() if id(p) in ids})
    batch = {n: local_rows(torch.as_tensor(v)) for n, v in global_batch(cfg, seed=cfg["F"]).items()}
    metrics = step_mod.make_train_step(st, device="cpu")(
        state, batch, generator=torch.Generator().manual_seed(GEN_SEED))
    return dict(loss=float(all_reduce_mean([metrics["loss"]])[0]), grads=named(state, "grads"),
                params=named(state, "params"), buffers=named(state, "buffers"),
                params0=params0, groups=groups, draws=draws, masks=masks)


# --------------------------------------------------------------------------
# The child: one rank
# --------------------------------------------------------------------------
def child(rank: int, tmp: str) -> None:
    from baseboostdepth_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{tmp}/rdv", WORLD, rank, "cpu")
    arrays, report = {}, {}
    for name in ZOOS:
        s = run_zoo(name, setattr)
        report[name] = {"loss": s["loss"], **{f"digest_{w}": digest(s[w])
                                              for w in ("grads", "params", "buffers")}}
        arrays.update({f"{name}/draws/{i}": d for i, d in enumerate(s["draws"])})
        arrays.update({f"{name}/masks/{i}": m for i, m in enumerate(s["masks"])})
        if rank == 0:
            for w in ("grads", "params", "buffers"):
                arrays.update({f"{name}/{w}/{n}": v for n, v in s[w].items()})
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


# --------------------------------------------------------------------------
# The fixture: children + references
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both children's results and the one-process reference of each zoo,
    the children at this module's lowered CPU priority."""
    tmp = str(tmp_path_factory.mktemp("dist_zoos"))
    ref = {}
    with ranks_running(__file__, WORLD, tmp) as procs:
        with pytest.MonkeyPatch.context() as mp:
            for name in ZOOS:
                ref[name] = run_zoo(name, mp.setattr)
        wait_ranks(procs, CHILD_TIMEOUT_S)
    ranks = []
    for r in range(WORLD):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append({"arrays": arrays, "report": json.load(f)})
    return {"ref": ref, "ranks": ranks}


def _got(runs, name):
    arrays, report = runs["ranks"][0]["arrays"], runs["ranks"][0]["report"]
    return {"loss": report[name]["loss"],
            **{w: split(arrays, f"{name}/{w}/") for w in ("grads", "params", "buffers")}}


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------
def test_replicas_are_bit_equal(runs):
    """Both ranks hold the same averaged gradients, parameters and BN
    statistics after each zoo's step, and the same global loss."""
    r0, r1 = (r["report"] for r in runs["ranks"])
    for name in ZOOS:
        for w in ("grads", "params", "buffers"):
            a, b = r0[name][f"digest_{w}"], r1[name][f"digest_{w}"]
            assert a.keys() == b.keys() and a, f"{name} {w}"
            assert a == b, f"{name} {w}: {[n for n in a if a[n] != b[n]][:5]}"
        assert r0[name]["loss"] == r1[name]["loss"], name


@pytest.mark.parametrize("name", list(ZOOS))
def test_two_processes_match_one_process(runs, name):
    """The zoo's step in two processes against one process: the ranks' draws
    are the rows of the one-process draws, every rank's SQL attention mask
    is the whole one-process mask, and the step holds the zoo's whole-step
    bounds (module docstring)."""
    ref = runs["ref"][name]
    halves = [split(r["arrays"], f"{name}/draws/") for r in runs["ranks"]]
    assert len(halves[0]) == len(halves[1]) == len(ref["draws"]) > 0
    for i, whole in enumerate(ref["draws"]):
        got = np.concatenate([h[str(i)] for h in halves])
        np.testing.assert_array_equal(got, whole, err_msg=f"{name} draw {i}")
    if name in ("monovit", "sql"):  # drop-path or dropout masks, then the automask noise
        assert len(ref["draws"]) > 1
    # the SQL head's four layers draw one attention mask each
    assert len(ref["masks"]) == (4 if name == "sql" else 0)
    for r, rank in enumerate(runs["ranks"]):
        masks = split(rank["arrays"], f"{name}/masks/")
        assert len(masks) == len(ref["masks"])
        for i, whole in enumerate(ref["masks"]):
            assert whole.shape[:2] == (1, 1)
            np.testing.assert_array_equal(masks[str(i)], whole, err_msg=f"{name} rank {r} mask {i}")
    floor, deep = BOUNDS[name]
    print("measured", name, check_step(
        _got(runs, name), ref, 0, name, loss_rtol=1e-6, grad_rtol=1e-4, grad_atol=2e-5,
        leaf_rtol=3e-2, leaf_rms=1e-7, stats_rtol=1e-4, stats_floor=1e-5, pinned_at=4e-5,
        depth_stats_floor=floor, deep_rtol=6e-2 if deep else None))


def test_monovit_two_group_adamw_after_averaged_gradients(runs):
    """MonoViT's update in two processes: every parameter's first AdamW step
    of its group on the averaged gradient, the depth encoder at 5e-5, the
    rest at 1e-4, weight decay 1e-4."""
    ref = runs["ref"]["monovit"]
    got = _got(runs, "monovit")
    lrs = set()
    for n, p1 in got["params"].items():
        lr, wd = ref["groups"][n]
        lrs.add((n.startswith("depth.encoder."), lr, wd))
        p0 = ref["params0"][n].astype(np.float64)
        g = got["grads"].get(n)
        if g is None:  # no gradient: AdamW leaves it
            np.testing.assert_array_equal(p1, ref["params0"][n], err_msg=n)
            continue
        g = g.astype(np.float64)
        expect = p0 - lr * wd * p0 - lr * g / (np.abs(g) + ADAM_EPS)
        np.testing.assert_allclose(p1, expect, rtol=0, atol=1e-6, err_msg=f"AdamW {n}")
    assert lrs == {(True, 5e-5, 1e-4), (False, 1e-4, 1e-4)}, lrs


if __name__ == "__main__":
    child(int(sys.argv[1]), sys.argv[2])
