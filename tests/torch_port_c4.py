"""SQLdepth's training on the CPU, the port against the JAX package: the
scripts behind fault C4's CPU records (ROADMAP.md, C; PERF.md, §6; the
first step's per-part gradient norms at 192x640 are
tests/test_torch_port_sql_full_width_step.py). Not a test file: run from
the repository's root,

    JAX_PLATFORMS=cpu python tests/torch_port_c4.py jax-init OUT.pt [SEED]
        JAX's Trainer init of SQLdepth (init_state, PRNGKey(SEED), default
        0, eager, as the JAX Trainer calls it with cfg.seed), converted by
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
    python tests/torch_port_c4.py port-init SEED OUT.pt
        the port's own init at seed SEED (init_state's networks) in the
        same file format;
    python tests/torch_port_c4.py mix A.pt B.pt PREFIX OUT.pt
        A's networks with the depth network's tensors under PREFIX (such as
        "head.") taken from B.
"""

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

def jax_init(out, seed=0):
    t = time.time()
    st = JaxStepStatic(zoo="sql", num_layers=18, height=192, width=640, F=2, scales=(0,),
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
        jax_init(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 0)
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
