"""A record of how a zoo learns in the synthetic accuracy benchmark: the
diagnostic behind fault C4 (SQLdepth on the card, ROADMAP.md §C). Not a
test file and not part of the port: a script for one GPU, importing
nothing of JAX, run from the repository's root,

    python tests/torch_port_c4_record.py run OUT.json
        [--init-state FILE | --init-seed J] [--head-dropout R] [--trainer-seed K]
        [-- synthetic_benchmark args, default: --zoo sql]

runs `tools/synthetic_benchmark.main` (the scene, Trainer, schedule and
scores of the tool, its log directory suffixed `_record<tag>`) and writes
OUT.json: the tool's result, the loss of every step, the learning rate of
every step, each network part's gradient norm over the first 20 steps
(encoder, decoder, transformer, bins_regressor, convert_to_prob, the rest
of the head, pose), each part's parameter change over the run relative to
its initial norm, the median and the 5th and 95th percentiles of the
predicted depth (metric for SQLdepth) over the first 8 validation images
before training and after every epoch, and the card's name and power
limit. It writes no checkpoint (a run would write ~5 GB). Variants, each
applied after the Trainer is built and before its first score:
`--init-state` loads both networks from a file of {"depth": state_dict,
"pose": state_dict} (tests/torch_port_c4.py jax-init writes the JAX
package's init so), `--init-seed` builds both networks as the Trainer
would from seed J, `--head-dropout` sets every dropout rate of an SQLdepth
head, `--trainer-seed` gives the Trainer another seed (its init, its
loader's order and its step draws) on the scene of the tool's seed; the
init options act after it, so that one init trains under several streams.

    python tests/torch_port_c4_record.py card-vs-cpu OUT.json
        [--steps 8] [--batch 4] [--init-state FILE]

trains SQLdepth from one state on the card and on the CPU, the same
batches (the first of the scene's epoch-0 loader at 192x640), the same
automask noise, dropout 0, float32 with TF32 off, and writes each step's
loss on both and the first step's per-part gradient norms on both with
their relative L2 difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repository
from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch  # noqa: E402
from baseboostdepth_tpu_torch.device import describe, require_device  # noqa: E402
from baseboostdepth_tpu_torch.tools import synthetic_benchmark as sb  # noqa: E402
from baseboostdepth_tpu_torch.training.step import build_networks, init_disp_bias  # noqa: E402

GRAD_STEPS = 20
PARTS = (("encoder.encoder.", "encoder"), ("encoder.decoder.", "decoder"),
         ("head.transformer_encoder.", "transformer"), ("head.bins_regressor.", "bins_regressor"),
         ("head.convert_to_prob.", "convert_to_prob"), ("encoder.", "encoder"),
         ("decoder.", "decoder"))


def part_of(net: str, name: str) -> str:
    """The part of network `net` ("depth" / "pose") a parameter belongs to."""
    if net == "pose":
        return "pose"
    return next((part for prefix, part in PARTS if name.startswith(prefix)), "head_other")


def named_parts(depth_net, pose_net):
    return [(part_of(net, n), p) for net, m in (("depth", depth_net), ("pose", pose_net))
            for n, p in m.named_parameters()]


def load_state(depth_net, pose_net, path: str) -> None:
    sd = torch.load(path)
    depth_net.load_state_dict(sd["depth"])
    pose_net.load_state_dict(sd["pose"])


def set_head_dropout(depth_net, rate: float) -> int:
    """Every dropout rate of the SQL head (attention and feed-forward) at
    `rate`; returns how many modules took it."""
    n = 0
    for m in depth_net.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = rate
            n += 1
    return n


def record_run(opts, device) -> dict:
    record = {"variant": {k: getattr(opts, k)
                          for k in ("init_state", "init_seed", "head_dropout", "trainer_seed")},
              "args": opts.bench, "losses": [], "lr": [], "grad_norms": [],
              "depth_quantiles": []}
    trainers = []

    class Recording(sb.EpochTimedTrainer):
        def __init__(self, cfg, device="cuda"):
            super().__init__(cfg, device)
            trainers.append(self)
            st = self.state
            if opts.init_state:
                load_state(st.depth_net, st.pose_net, opts.init_state)
            elif opts.init_seed is not None:
                nets = build_networks(self._static_for_stage(stage_for_epoch(0, cfg.method.trimin)),
                                      torch.Generator().manual_seed(opts.init_seed))
                for net, new in zip((st.depth_net, st.pose_net), nets):
                    net.load_state_dict(new.state_dict())
                if cfg.method.disp_init_bias is not None:
                    init_disp_bias(st.depth_net, cfg.method.disp_init_bias)
            if opts.head_dropout is not None:
                record["dropout_modules"] = set_head_dropout(st.depth_net, opts.head_dropout)
            self.parts = named_parts(st.depth_net, st.pose_net)
            self.start = [p.detach().clone() for _, p in self.parts]
            record["depth_quantiles"].append(self.depth_quantiles(0))
            step = st.optimizer.step

            def recorded_step(*a, **k):
                if len(record["grad_norms"]) < GRAD_STEPS:
                    sq = {}
                    for part, p in self.parts:
                        if p.grad is not None:
                            sq[part] = sq.get(part, 0.0) + float(p.grad.float().pow(2).sum())
                    record["grad_norms"].append({k_: v ** 0.5 for k_, v in sq.items()})
                record["lr"].append(st.optimizer.param_groups[0]["lr"])
                return step(*a, **k)

            st.optimizer.step = recorded_step

        def _save(self, global_step, extra):
            pass

        def _train_epoch(self, epoch, t0, stop_requested):
            going_on = super()._train_epoch(epoch, t0, stop_requested)
            record["depth_quantiles"].append(self.depth_quantiles(epoch))
            return going_on

        def depth_quantiles(self, epoch):
            """5th, 50th and 95th percentiles of the depth the network
            predicts on the first 8 validation images (eval mode)."""
            from baseboostdepth_tpu_torch.data.loader import EvalLoader
            from baseboostdepth_tpu_torch.training.step import make_eval_forward

            st = self._static_for_stage(stage_for_epoch(epoch, self.cfg.method.trimin))
            imgs, _, n = next(iter(EvalLoader(self.val_paths[:8], self.cfg.data.height,
                                              self.cfg.data.width, batch_size=8)))
            depth = make_eval_forward(st, self.device)(self.state.depth_net,
                                                       imgs[:n].astype("float32") / 255.0)
            q = torch.quantile(depth.float().flatten().cpu(), torch.tensor([0.05, 0.5, 0.95]))
            return [float(v) for v in q]

        def _step_fn(self, st):
            fn = super()._step_fn(st)

            def recorded(state, batch, generator=None):
                metrics = fn(state, batch, generator=generator)
                record["losses"].append(float(metrics["loss"]))
                return metrics

            return recorded

    make_config = sb.make_config
    tag = "".join(f"_{k}{v}" for k, v in (("init", "file" if opts.init_state else opts.init_seed),
                                          ("dropout", opts.head_dropout),
                                          ("seed", opts.trainer_seed)) if v is not None)

    def tagged_config(args):
        cfg = make_config(args)
        cfg.log.model_name += f"_record{tag}"
        if opts.trainer_seed is not None:
            cfg.seed = opts.trainer_seed
        return cfg

    trainer_cls = sb.EpochTimedTrainer
    sb.EpochTimedTrainer, sb.make_config = Recording, tagged_config
    try:
        record["result"] = sb.main(opts.bench, device=device)
    finally:
        sb.EpochTimedTrainer, sb.make_config = trainer_cls, make_config
    tr = trainers[0]
    change, norm = {}, {}
    for (part, p), p0 in zip(tr.parts, tr.start):
        change[part] = change.get(part, 0.0) + float((p.detach().float() - p0.float()).pow(2).sum())
        norm[part] = norm.get(part, 0.0) + float(p0.float().pow(2).sum())
    record["param_change_rel"] = {k: (change[k] / max(norm[k], 1e-30)) ** 0.5 for k in change}
    return record


def card_vs_cpu(opts, device) -> dict:
    from baseboostdepth_tpu_torch.data import kitti
    from baseboostdepth_tpu_torch.data.loader import KittiTrainLoader
    from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root, B = opts.root, opts.batch
    index = kitti.KittiRawIndex(root, os.path.join(root, "splits/synth/train_files_baselines.txt"))
    stage = stage_for_epoch(0, True, 6, sql=True)
    batches = []
    for b in KittiTrainLoader(index, stage, B, 192, 640, trimin=True, use_stereo=True,
                              classic=False, num_workers=4, seed=0):
        batches.append(b)
        if len(batches) == opts.steps:
            break
    runs = {}
    for label, dev in (("card", device), ("cpu", torch.device("cpu"))):
        st = StepStatic(zoo="sql", num_layers=18, F=stage.F, scales=(0,), trimin=True,
                        incremental=False, partial=False, decomp=True, dtype="float32")
        state = init_state(st, device=dev, steps_per_epoch=27)
        if opts.init_state:
            load_state(state.depth_net, state.pose_net, opts.init_state)
        set_head_dropout(state.depth_net, 0.0)
        step = make_train_step(st, device=dev)
        parts = named_parts(state.depth_net, state.pose_net)
        losses, grads = [], {}
        opt_step = state.optimizer.step

        def first_step(*a, **k):
            for i, (part, p) in enumerate(parts):
                if p.grad is not None:
                    grads[i] = (part, p.grad.detach().double().cpu().clone())
            state.optimizer.step = opt_step
            return opt_step(*a, **k)

        state.optimizer.step = first_step
        for i, b in enumerate(batches):
            noise = torch.randn((B, 1, 192, 640), generator=torch.Generator().manual_seed(i)) * 1e-5
            losses.append(float(step(state, b, noise=noise.to(dev))["loss"]))
        runs[label] = (losses, grads)
    norm = {"card": {}, "cpu": {}}
    diff = {}
    for i, (part, g) in runs["cpu"][1].items():
        gc = runs["card"][1].get(i, (part, torch.zeros_like(g)))[1]
        norm["cpu"][part] = norm["cpu"].get(part, 0.0) + float(g.pow(2).sum())
        norm["card"][part] = norm["card"].get(part, 0.0) + float(gc.pow(2).sum())
        diff[part] = diff.get(part, 0.0) + float((gc - g).pow(2).sum())
    return {"batch": B, "steps": len(batches), "init": opts.init_state or "port, seed 0",
            "loss_card": runs["card"][0], "loss_cpu": runs["cpu"][0],
            "grad_norm_card": {k: v ** 0.5 for k, v in norm["card"].items()},
            "grad_norm_cpu": {k: v ** 0.5 for k, v in norm["cpu"].items()},
            "grad_diff_rel": {k: (diff[k] / max(norm["cpu"][k], 1e-30)) ** 0.5 for k in diff}}


def parse_args(argv=None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    bench = []
    if "--" in argv:
        i = argv.index("--")
        argv, bench = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["run", "card-vs-cpu"])
    ap.add_argument("out")
    init = ap.add_mutually_exclusive_group()
    init.add_argument("--init-state", default=None)
    init.add_argument("--init-seed", type=int, default=None)
    ap.add_argument("--head-dropout", type=float, default=None)
    ap.add_argument("--trainer-seed", type=int, default=None)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--root", default="logs/synth_scene")
    opts = ap.parse_args(argv)
    opts.bench = bench or ["--zoo", "sql"]
    return opts


def main(argv=None, device="cuda") -> dict:
    device = require_device(device)
    opts = parse_args(argv)
    t0 = time.time()
    out = record_run(opts, device) if opts.what == "run" else card_vs_cpu(opts, device)
    out["seconds"] = time.time() - t0
    out["device"] = describe(device)
    with open(opts.out, "w") as f:
        json.dump(out, f, indent=1)
    if opts.what == "run":
        r = out["result"]
        print(f"record: init {r['init']['abs_rel']:.4f} final {r['final']['abs_rel']:.4f} "
              f"a1 {r['final']['a1']:.4f} | {out['device']}")
    print(f"wrote {opts.out}")
    return out


if __name__ == "__main__":
    main()
