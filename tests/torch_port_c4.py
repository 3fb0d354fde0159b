"""SQLdepth's training on the CPU, the port against the JAX package: the
scripts behind fault C4's CPU records (ROADMAP.md, C; PERF.md, §6; the
first step's per-part gradient norms at 192x640 are
tests/test_torch_port_sql_full_width_step.py). Not a test file: run from
the repository's root,

    JAX_PLATFORMS=cpu python tests/torch_port_c4.py jax-init OUT.pt [SEED]
            [--height H --width W]
        JAX's Trainer init of SQLdepth (init_state, PRNGKey(SEED), default
        0, eager, as the JAX Trainer calls it with cfg.seed, at HxW,
        default 192x640; the head needs 64 patch tokens, so at least
        128x512 at KITTI's aspect), converted by
        models/convert.py::from_jax and saved as {"depth": state_dict,
        "pose": state_dict} for the port (tests/torch_port_c4_record.py
        --init-state OUT.pt on the card);
    JAX_PLATFORMS=cpu python tests/torch_port_c4.py trainers [SCENE]
        both packages' Trainers side by side on a 40-frame 512x128 scene
        (rendered under SCENE), batch 2, the curriculum switch after epoch
        0, bucketing on, float32, dropout 0, from JAX's init: epoch 0 (early
        stage) and epoch 9 (late, batches of two F buckets), each step's
        loss, learning rate and batch F; one JSON line;
    JAX_PLATFORMS=cpu python tests/torch_port_c4.py init-stats [N]
        N inits of both networks from each package (JAX's Trainer init at
        PRNGKey(100 + k), the port's init_state at seed 100 + k): for each
        part (the depth encoder, its decoder, the SQL head, the pose
        encoder, the pose decoder) the mean and the largest deviation from
        1 of a tensor's spread over its flax spread (means over the draws),
        and, in train mode on the first 4 validation images of
        logs/synth_scene (pose: the 3 pairs of neighbours), the mean and
        standard error over the draws, and the port's distance from JAX in
        standard errors (z), of the encoder's last feature's spread, the
        decoder output's spread, the depth's median and 5th-95th percentile
        spread, the bin probabilities' entropy, their logits' spread and
        the pose's rotation and translation norms; one JSON line;
    JAX_PLATFORMS=cpu python tests/torch_port_c4.py recipe [SCENE_SEED] [OUT.json]
        the JAX package's CPU convergence recipe
        (tests/test_synthetic_convergence.py) on SyntheticScene(SCENE_SEED),
        default 0, in both packages side by side, the port from JAX's
        PRNGKey(0) init with JAX's batches' bytes and JAX's automask noise
        (tests/test_torch_port_synthetic_convergence.py::run_recipe; 10-16 min
        at 4 torch threads): each step's two losses, abs_rel / a1 / depth
        spread every 5 steps, where the curves part and where each package
        escapes the plateau; written under "scene<SEED>" into OUT.json
        (default docs/results/c4_recipe_cpu.json);
    JAX_PLATFORMS=cpu python tests/torch_port_c4.py step-floor [SCENE_SEED] [OUT.json]
        the recipe's first step from JAX's init, by part of the two
        networks: the port's gradient against JAX's, and the port's own
        gradient under a 3e-7 and a 1e-6 relative weight noise against
        itself (the float32 rounding floor of this state), each against
        test_torch_port_step.py's per-entry bound; under
        "first_step_floor_scene<SEED>" in OUT.json (~4 min);
    JAX_PLATFORMS=cpu python tests/torch_port_c4.py recipe-jax-twin [SCENE_SEED] [OUT.json]
        the same recipe in the JAX package alone, twice on the same batches
        and keys, the second from its init with every weight multiplied by
        1 + 1e-6 N(0, 1): how fast float32 rounding alone parts JAX's own
        trajectory from itself; under "jax_twin_scene<SEED>" in OUT.json
        (~6 min);
    JAX_PLATFORMS=cpu python tests/torch_port_c4.py jax-run INIT_SEED OUT.json
            [tool args]
        the JAX package's own benchmark tool (tools/synthetic_benchmark.py,
        loaded by path and not edited) with the tool args (such as --zoo
        sql --width 512 --height 128 --root logs/synth_scene_128x512), its
        Trainer at cfg.seed = INIT_SEED, its logs and checkpoints under
        logs/jax_run; the tool's result in OUT.json (SQLdepth at 128x512
        in bf16: ~11 min for one epoch with the tool's set-up and scores,
        on an 8-core CPU shared with other jobs);
    python tests/torch_port_c4.py port-init SEED OUT.pt
        the port's own init at seed SEED (init_state's networks) in the
        same file format;
    python tests/torch_port_c4.py mix A.pt B.pt PREFIX OUT.pt
        A's networks with the depth network's tensors under PREFIX (such as
        "head.") taken from B.
"""

import copy
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]  # the test helpers and the repository
import baseboostdepth_tpu.models.sql as jax_sql  # noqa: E402
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic  # noqa: E402
from baseboostdepth_tpu.training.step import init_state as jax_init_state  # noqa: E402
from baseboostdepth_tpu_torch.models.convert import from_jax  # noqa: E402
from test_torch_port_zoos import NoDropTransformerLayer  # noqa: E402

def jax_init(out, seed=0, height=192, width=640):
    t = time.time()
    st = JaxStepStatic(zoo="sql", num_layers=18, height=height, width=width, F=2, scales=(0,),
                       trimin=True, incremental=False, partial=False, decomp=True,
                       dtype="bfloat16")
    state = jax_init_state(st, optax.adam(1e-4), jax.random.PRNGKey(seed))
    depth_sd, pose_sd = from_jax(*jax.tree.map(np.asarray, (state.params, state.stats)))
    torch.save({"depth": depth_sd, "pose": pose_sd}, out)
    print("saved", out, len(depth_sd), len(pose_sd), f"{time.time() - t:.0f}s")


def trainers(root):
    from baseboostdepth_tpu.config import Config as JaxConfig
    from baseboostdepth_tpu.training.optim import multistep_lr as jax_multistep_lr
    from baseboostdepth_tpu.training.trainer import Trainer as JaxTrainer
    from baseboostdepth_tpu_torch.tools import synthetic_benchmark as sb
    from baseboostdepth_tpu_torch.training.trainer import Trainer

    t0 = time.time()
    args = sb.parse_args(["--zoo", "sql", "--dtype", "float32", "--root", root, "--n-frames", "40",
                          "--width", "512", "--height", "128", "--epochs", "2",
                          "--switch-epoch", "1", "--batch-size", "2"])
    sb.ensure_scene(sb.scene_root(args), args.n_frames, args.width, args.height, args.seed,
                    workers=4)
    tmp = tempfile.TemporaryDirectory()  # the two runs' checkpoints, ~1.7 GB
    logs = tmp.name
    cfg = sb.make_config(args)
    cfg.log.log_dir = os.path.join(logs, "port")

    jcfg = JaxConfig()
    for sec in ("model", "data", "optim", "method", "log"):
        for k, v in vars(getattr(cfg, sec)).items():
            if hasattr(getattr(jcfg, sec), k):
                setattr(getattr(jcfg, sec), k, v)
    jcfg.seed = cfg.seed
    jcfg.log.log_dir = os.path.join(logs, "jax")

    jax_sql.TransformerLayer = NoDropTransformerLayer
    jtr = JaxTrainer(jcfg)
    jrec = {"loss": [], "F": [], "lr": []}
    jsched = jax_multistep_lr(jcfg.optim.learning_rate, jcfg.optim.lr_milestones,
                              jcfg.optim.lr_gamma, jtr.steps_per_epoch)
    jstep_fn = jtr._step_fn

    def jax_step_fn(st):
        fn = jstep_fn(st)

        def rec(state, batch, key):
            n = int(state.step)
            state, metrics = fn(state, batch, key)
            jrec["loss"].append(float(metrics["loss"]))
            jrec["F"].append(st.F)
            jrec["lr"].append(float(jsched(n)))
            return state, metrics

        return rec

    jtr._step_fn = jax_step_fn
    params, stats = jax.tree.map(np.asarray, (jax.device_get(jtr.state.params),
                                              jax.device_get(jtr.state.stats)))
    tr = Trainer(cfg, "cpu")
    dsd, psd = from_jax(params, stats)
    tr.state.depth_net.load_state_dict(dsd)
    tr.state.pose_net.load_state_dict(psd)
    for m in tr.state.depth_net.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    prec = {"loss": [], "F": [], "lr": []}
    pstep_fn = tr._step_fn

    def port_step_fn(st):
        fn = pstep_fn(st)

        def rec(state, batch, generator=None):
            prec["lr"].append(state.optimizer.param_groups[0]["lr"])
            metrics = fn(state, batch, generator=generator)
            prec["loss"].append(float(metrics["loss"]))
            prec["F"].append(st.F)
            return metrics

        return rec


    tr._step_fn = port_step_fn
    # epoch 0 (early stage, F=2), then epoch 9 (late: the scene's baselines
    # of ~0.150 give f_max 2 or 3 at its cutoff 0.45, so batches of the
    # buckets F=2 and F=5), the state carried on; the schedule's milestones
    # (1, 2) put its step boundaries at 0 and 10
    for t in (jtr, tr):
        t.logger.close = lambda: None
    for start, stop in ((0, 1), (9, 10)):
        for t in (jtr, tr):
            t.start_epoch, t.cfg.optim.num_epochs = start, stop
            t.train()
    tmp.cleanup()
    rel = [abs(a - b) / abs(b) for a, b in zip(prec["loss"], jrec["loss"])]
    print(json.dumps({"jax": jrec, "port": prec, "loss_rel": rel,
                      "milestones": cfg.optim.lr_milestones,
                      "steps_per_epoch": [jtr.steps_per_epoch, tr.steps_per_epoch],
                      "seconds": time.time() - t0}))


PARTS = (("depth:encoder.encoder.", "encoder"), ("depth:encoder.decoder.", "decoder"),
         ("depth:head.", "head"), ("pose:encoder.", "pose_encoder"), ("pose:decoder.", "pose_decoder"))


def init_stats(n=12):
    from baseboostdepth_tpu.training.step import build_networks as jax_build_networks
    from baseboostdepth_tpu_torch.data import kitti
    from baseboostdepth_tpu_torch.data.loader import EvalLoader
    from baseboostdepth_tpu_torch.models import PoseNet
    from baseboostdepth_tpu_torch.models.sql import SQLDepthNet
    from baseboostdepth_tpu_torch.training.step import StepStatic, init_state

    root = "logs/synth_scene"
    idx = kitti.KittiRawIndex(root, f"{root}/splits/synth/val_files.txt")
    paths = [idx.image_path(s.folder, s.frame_index, s.side) for s in idx.samples][:4]
    imgs, _, m = next(iter(EvalLoader(paths, 192, 640, batch_size=4)))
    x = torch.from_numpy(imgs[:m].astype(np.float32) / 255.0)
    pairs = torch.cat([x[:-1], x[1:]], dim=-1)

    def probe(depth_net, pose_net):
        seen = {}

        def keep(name, pick=lambda o: o):
            return lambda mod, i, o: seen.update({name: pick(o)})  # returns None

        hooks = [depth_net.encoder.encoder.register_forward_hook(keep("enc", lambda o: o[-1])),
                 depth_net.encoder.decoder.register_forward_hook(keep("dec")),
                 depth_net.head.convert_to_prob.register_forward_hook(keep("logits"))]
        with torch.no_grad():
            d = depth_net.train()(x)[0]
            aa, t = pose_net.train()(pairs)
        for h in hooks:
            h.remove()
        logits = seen["logits"].float()
        p = torch.softmax(logits, 1)
        return [float(seen["enc"].float().std()), float(seen["dec"].float().std()),
                float(d.median()), float(d.quantile(0.95) - d.quantile(0.05)),
                float(-(p * p.clamp_min(1e-30).log()).sum(1).mean()),
                float(logits.std(1).mean()), float(aa.norm(dim=-1).mean()),
                float(t.norm(dim=-1).mean())]

    # JAX's Trainer init (training/step.py::init_state's two calls on one
    # split key), each network jitted alone; the port's init_state
    jst = JaxStepStatic(zoo="sql", num_layers=18, height=192, width=640, F=2, scales=(0,),
                        trimin=True, incremental=False, partial=False, decomp=True,
                        dtype="bfloat16")
    jdepth, jpose = jax_build_networks(jst)
    dinit = jax.jit(lambda k: jdepth.init(k, jnp.zeros((1, 192, 640, 3)), train=False))
    pinit = jax.jit(lambda k: jpose.init(k, jnp.zeros((1, 192, 640, 6)), train=False))
    stats = {"jax": [], "port": []}
    spread = {"jax": {}, "port": {}}
    t0 = time.time()
    for k in range(n):
        rd, rp = jax.random.split(jax.random.PRNGKey(100 + k))
        dv, pv = (jax.tree.map(np.asarray, f(r)) for f, r in ((dinit, rd), (pinit, rp)))
        jd, jp = from_jax({"depth": dv["params"], "pose": pv["params"]},
                          {"depth": dv["batch_stats"], "pose": pv["batch_stats"]})
        state = init_state(StepStatic(zoo="sql"), seed=100 + k, device="cpu")
        sds = {"jax": (jd, jp),
               "port": (state.depth_net.state_dict(), state.pose_net.state_dict())}
        for fam, (dsd, psd) in sds.items():
            depth_net, pose_net = SQLDepthNet(), PoseNet()
            depth_net.load_state_dict(dsd)
            pose_net.load_state_dict(psd)
            stats[fam].append(probe(depth_net, pose_net))
            for net, sd in (("depth", dsd), ("pose", psd)):
                for name, t in sd.items():
                    if t.dtype == torch.float32 and t.numel() > 1:
                        key = f"{net}:{name}"
                        spread[fam][key] = spread[fam].get(key, 0.0) + float(t.std()) / n
    out = {"draws": n, "seconds": time.time() - t0, "spread_ratio": {}}
    for prefix, part in PARTS:
        ratio = {name: spread["port"][name] / spread["jax"][name] for name in spread["jax"]
                 if name.startswith(prefix) and spread["jax"][name] > 0}
        worst = max(ratio, key=lambda name: abs(ratio[name] - 1))
        out["spread_ratio"][part] = {"tensors": len(ratio), "worst": [worst, ratio[worst]],
                                     "mean": float(np.mean(list(ratio.values())))}
    names = ("encoder_feature_std", "decoder_output_std", "depth_median", "depth_spread",
             "entropy", "logit_spread", "pose_axisangle", "pose_translation")
    a = {fam: np.array(rows) for fam, rows in stats.items()}
    for i, name in enumerate(names):
        mean = {fam: float(a[fam][:, i].mean()) for fam in a}
        se = {fam: float(a[fam][:, i].std(ddof=1) / np.sqrt(n)) for fam in a}
        out[name] = {"jax": [mean["jax"], se["jax"]], "port": [mean["port"], se["port"]],
                     "z": (mean["port"] - mean["jax"]) / max(np.hypot(se["jax"], se["port"]),
                                                              1e-30)}
    print(json.dumps(out))


def update_json(out, key, value):
    """OUT's JSON object (empty if the file is new) with `key` set."""
    old = {}
    if os.path.exists(out):
        with open(out) as f:
            old = json.load(f)
    old[key] = value
    with open(out, "w") as f:
        json.dump(old, f, indent=1)


def recipe(scene_seed, out):
    """The JAX package's CPU convergence recipe on SyntheticScene(scene_seed)
    in both packages side by side (run_recipe of
    tests/test_torch_port_synthetic_convergence.py); its record under
    "scene<SEED>" in OUT (other keys kept)."""
    from test_torch_port_synthetic_convergence import run_recipe

    with tempfile.TemporaryDirectory() as root:
        rec = run_recipe(root, scene_seed, torch_threads=4)
    update_json(out, f"scene{scene_seed}",
                dict(rec, host="CPU (JAX package and port), not a GPU"))
    print(json.dumps({k: rec[k] for k in ("first_loss_rel", "part_step_1e-3", "loss_rel_max",
                                          "seconds")}))
    for side in ("jax", "port"):
        r = rec[side]
        print(side, {k: r[k] for k in ("escape_step", "leaves_init_step")},
              {k: round(r["init"][k], 4) for k in ("abs_rel", "a1")},
              {k: round(r["final"][k], 4) for k in ("abs_rel", "a1")})


FLOOR_PARTS = (("depth.encoder.encoder.conv1.", "depth_conv1"), ("depth.encoder.", "depth_encoder"),
               ("depth.decoder.", "depth_decoder"), ("pose.encoder.", "pose_encoder"),
               ("pose.decoder.", "pose_decoder"))


def step_floor(scene_seed, out, noises=(3e-7, 1e-6)):
    """The recipe's first step from JAX's PRNGKey(0) init (eager), JAX's
    batch and noise: by part (FLOOR_PARTS), how far the port's gradient
    lies from JAX's, and how far the port's own gradient moves when its
    weights are multiplied by 1 + NOISE * N(0, 1) (torch seed 0): the
    largest entry excess over test_torch_port_step.py's per-entry bound
    (1e-4 |g| + 2e-5; positive: beyond it), the entries beyond it and the
    relative L2 difference; and the loss's relative difference. Under
    "first_step_floor_scene<SEED>" in OUT."""
    import test_torch_port_synthetic_convergence as rc
    from baseboostdepth_tpu.training.step import loss_forward as jax_loss_forward
    from baseboostdepth_tpu_torch.training.step import StepStatic, make_train_step
    from torch_port_helpers import named

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as root:
        recipe = rc.Recipe(root, scene_seed)
        jb, b, key = next(recipe.stream(1))
    side = rc.JaxSide()
    p, s = side.state.params, side.state.stats
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p_, s_, b_, k_: jax_loss_forward(p_, s_, b_, k_, side.st, True), has_aux=True))(
            p, s, jax.tree.map(jnp.asarray, jb), jax.random.PRNGKey(key))
    state_np = jax.tree.map(np.asarray, (p, s))
    gd, gp = from_jax(jax.tree.map(np.asarray, grads), state_np[1])
    ref = {**{f"depth.{n}": v.numpy() for n, v in gd.items()},
           **{f"pose.{n}": v.numpy() for n, v in gp.items()}}
    noise = torch.from_numpy(rc.jax_noise(key))
    step = make_train_step(StepStatic(**rc.STATIC), device="cpu")

    def port(weight_noise=0.0):
        state = rc.port_state(*state_np)
        if weight_noise:
            gen = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for net in (state.depth_net, state.pose_net):
                    for q in net.parameters():
                        q.mul_(1 + weight_noise * torch.randn(q.shape, generator=gen))
        return float(step(state, b, noise=noise)["loss"]), named(state, "grads")

    def compare(got, want):
        parts = {}
        for n, g in got.items():
            g, r = g.astype(np.float64), want[n].astype(np.float64)
            excess = np.abs(g - r) - 1e-4 * np.abs(r) - 2e-5
            part = next(lbl for pre, lbl in FLOOR_PARTS if n.startswith(pre))
            e = parts.setdefault(part, {"excess": -1.0, "beyond": 0, "d2": 0.0, "n2": 0.0})
            e["excess"] = max(e["excess"], float(excess.max()))
            e["beyond"] += int((excess > 0).sum())
            e["d2"] += float(((g - r) ** 2).sum())
            e["n2"] += float((r ** 2).sum())
        return {k: {"excess": v["excess"], "beyond": v["beyond"],
                    "rel_l2": (v["d2"] / max(v["n2"], 1e-30)) ** 0.5} for k, v in parts.items()}

    loss_p, g_p = port()
    rec = {"jax_vs_port": {"loss_rel": abs(loss_p / float(loss) - 1), **compare(g_p, ref)}}
    for wn in noises:
        loss_n, g_n = port(wn)
        rec[f"port_noise_{wn}_vs_port"] = {"loss_rel": abs(loss_n / loss_p - 1),
                                           **compare(g_n, g_p)}
    update_json(out, f"first_step_floor_scene{scene_seed}",
                dict(rec, host="CPU, one torch thread"))
    for k, v in rec.items():
        print(k, json.dumps(v))


def recipe_jax_twin(scene_seed, out, weight_noise=1e-6):
    """The recipe in the JAX package alone, twice on the same batches and
    keys: from PRNGKey(0)'s init and from it with every weight multiplied
    by 1 + weight_noise * N(0, 1) (numpy seed 0): how far float32 rounding
    alone moves JAX's own trajectory. Each step's two losses and abs_rel /
    a1 every 5 steps, under "jax_twin_scene<SEED>" in OUT."""
    import test_torch_port_synthetic_convergence as rc

    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        recipe = rc.Recipe(root, scene_seed)
        sides = [rc.JaxSide()]
        sides.append(copy.copy(sides[0]))
        rng = np.random.default_rng(0)
        base = jax.tree.map(np.asarray, sides[0].state.params)
        noisy = jax.tree.map(
            lambda a: (a * (1 + weight_noise * rng.standard_normal(a.shape))).astype(a.dtype),
            base)
        # copies: the jitted step donates its state's buffers
        sides[1].state = jax.tree.map(jnp.array, sides[0].state.replace(params=noisy))
        rec = {"weight_noise": weight_noise, "jax": {"loss": [], "evals": []},
               "jax_noisy": {"loss": [], "evals": []}}
        for k, (jb, _, key_seed) in enumerate(recipe.stream(rc.N_STEPS), 1):
            for name, side in zip(("jax", "jax_noisy"), sides):
                rec[name]["loss"].append(side.step(jb, key_seed))
                if k % rc.EVAL_EVERY == 0:
                    rec[name]["evals"].append(dict(step=k, **side.scores(recipe)))
    a, b = rec["jax"]["loss"], rec["jax_noisy"]["loss"]
    rec["first_loss_rel"] = abs(b[0] - a[0]) / abs(a[0])
    rec["part_step_1e-3"] = rc.first_step_over(b, a, 1e-3)
    rec["loss_rel_max"] = max(abs(y - x) / abs(x) for x, y in zip(a, b))
    rec["seconds"] = time.time() - t0
    update_json(out, f"jax_twin_scene{scene_seed}",
                dict(rec, host="CPU (JAX package), not a GPU"))
    print(json.dumps({k: rec[k] for k in ("first_loss_rel", "part_step_1e-3", "loss_rel_max",
                                          "seconds")}),
          {n: round(rec[n]["evals"][-1]["abs_rel"], 4) for n in ("jax", "jax_noisy")})


def jax_run(init_seed, out, tool_args):
    """The JAX package's tools/synthetic_benchmark.py main (loaded by path,
    unedited) with tool_args (the zoo, size, scene root, ...), its Trainer
    at cfg.seed = init_seed (its init draw PRNGKey(init_seed), its loader
    order and step keys), its log directory under logs/jax_run (the
    checkpoints kept for tools/synthetic_pose_eval.py); the tool's result
    (its wall_s: the Trainer's construction to the final score), the log
    directory and the host, under "jax_<zoo>_<dtype>_bias<B>_seed<SEED>"
    in OUT."""
    import baseboostdepth_tpu.training.trainer as jax_trainer
    from torch_port_helpers import jax_tool

    tool = jax_tool("synthetic_benchmark")
    base = jax_trainer.Trainer
    made = []

    class Seeded(base):
        def __init__(self, cfg):
            cfg.seed = init_seed
            cfg.log.log_dir = "logs/jax_run"
            cfg.log.model_name += f"_seed{init_seed}"
            super().__init__(cfg)
            made.append(self.log_path)

    argv = ["synthetic_benchmark", *tool_args]
    jax_trainer.Trainer, sys.argv = Seeded, argv
    try:
        tool.main()
    finally:
        jax_trainer.Trainer = base
    with open(os.path.join(made[0], "result.json")) as f:
        result = json.load(f)
    key = f"jax_{result['zoo']}_{result['dtype']}_bias{result['disp_bias']}_seed{init_seed}"
    update_json(out, key, {"result": result, "args": argv[1:], "log_path": made[0],
                           "host": "CPU (JAX package), not a GPU"})
    print(json.dumps({key: result["final"]["abs_rel"], "wall_s": result["wall_s"]}))


def port_init(seed, out):
    from baseboostdepth_tpu_torch.training.step import StepStatic, init_state

    state = init_state(StepStatic(zoo="sql"), seed=seed, device="cpu")
    torch.save({"depth": state.depth_net.state_dict(), "pose": state.pose_net.state_dict()}, out)


def mix(a, b, prefix, out):
    sa, sb = torch.load(a), torch.load(b)
    sa["depth"].update({k: v for k, v in sb["depth"].items() if k.startswith(prefix)})
    torch.save(sa, out)


if __name__ == "__main__":
    torch.set_num_threads(4)
    what = sys.argv[1]
    if what == "jax-init":
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("out")
        ap.add_argument("seed", nargs="?", type=int, default=0)
        ap.add_argument("--height", type=int, default=192)
        ap.add_argument("--width", type=int, default=640)
        a = ap.parse_args(sys.argv[2:])
        jax_init(a.out, a.seed, a.height, a.width)
    elif what == "recipe":
        recipe(int(sys.argv[2]) if len(sys.argv) > 2 else 0,
               sys.argv[3] if len(sys.argv) > 3 else "docs/results/c4_recipe_cpu.json")
    elif what == "step-floor":
        step_floor(int(sys.argv[2]) if len(sys.argv) > 2 else 0,
                   sys.argv[3] if len(sys.argv) > 3 else "docs/results/c4_recipe_cpu.json")
    elif what == "recipe-jax-twin":
        recipe_jax_twin(int(sys.argv[2]) if len(sys.argv) > 2 else 0,
                        sys.argv[3] if len(sys.argv) > 3 else "docs/results/c4_recipe_cpu.json")
    elif what == "jax-run":
        jax_run(int(sys.argv[2]), sys.argv[3], sys.argv[4:])
    elif what == "port-init":
        port_init(int(sys.argv[2]), sys.argv[3])
    elif what == "mix":
        mix(*sys.argv[2:6])
    elif what == "init-stats":
        init_stats(int(sys.argv[2]) if len(sys.argv) > 2 else 12)
    elif what == "trainers":
        trainers(sys.argv[2] if len(sys.argv) > 2
                 else os.path.join(tempfile.gettempdir(), "c4_scene"))
    else:
        raise SystemExit(__doc__)
