"""Data parallelism of the port (`--dist.enabled`, `parallel/sharding.py`)
on the CPU: two gloo processes against one process, and against the JAX
package's step on `data_mesh(2)`.

How it runs. A module-scoped fixture starts this file as a script in two
child processes (ranks 0 and 1 of a gloo group met through a `file://`
rendezvous in the test's temporary directory, so parallel test workers
cannot collide; PYTHONPATH is the repository only, one torch thread each,
and each child has 120 s before the test fails). While they run, the
pytest process computes the one-process references. The children write
what they saw to `.npz` / `.json` files, which the tests compare:

  - the full-method late step (F=3, incremental + partial + decomp, scale
    0) at 32x64, md2 ResNet-18 and its pose net, float32, global batch 4
    (2 a rank), two steps from the port's init: once with the automask
    noise drawn from a generator (seeded per step; against the one-process
    port step on the global batch with the same generators) and once with
    the noise given as the global array JAX's step draws (against JAX's
    step on `data_mesh(2)`: `replicate`, `shard_batch`, the corner-plane
    Pallas kernel in interpret mode);
  - a BatchNorm2d and a BasicBlock on each half of a batch against the
    whole-batch module in one process, in float64, and with a bf16 input
    under autocast;
  - the random draws of a batch's leading shape (the automask noise,
    MonoViT's drop-path, SQLdepth's dropout) against the one-process draws;
  - cli.train with `--dist.enabled` on a tiny KITTI tree: one epoch, then a
    resumed second, then a start whose ranks see different checkpoints.

Tolerances, each step against a reference step from the same state
(step 1 from the two-process run's state after step 0, rebuilt in one
process; measured on these inputs, step 0 / step 1, in brackets):
  - replicas: parameters, BN buffers and averaged gradients bit-equal.
  - two processes against one: the whole-step bounds of ROADMAP.md, C.
    Losses 1e-6 relative [2.0e-7 / 1.9e-7]; gradients per entry 1e-4
    relative + 2e-5 [excess over the relative part 3.6e-7 / 2.5e-6; before
    the one-process BN took flax's formula too, 9.7e-6 / 1.3e-6 at the
    encoder's conv1], per tensor 3e-2 relative L2 + 1e-7 RMS [2.0e-3 /
    4.3e-3; before, 9.9e-3 / 3.5e-3]; BN statistics 1e-4 relative + 1e-5
    of the tensor's largest entry [2.4e-6 / 1.0e-6 of it]; parameters
    where both gradients exceed 4e-5, 1e-6 after step 0 and 1e-5 after step
    1 (see torch_port_helpers.check_step) [1.5e-8 / 1.9e-6]; Adam's two
    updates held to their formula on the run's own gradients everywhere
    (1e-6). Only the order of float32 sums differs (a gradient is the mean
    of two halves; BN's statistics are E[x^2] - E[x]^2 of summed halves,
    in one process too), but, as between the two packages, a ~1e-7 change
    in the disparities moves the min over candidates and the warp's floor
    at a few pixels. The bounds are the whole-step ones of the port's
    other parity files, kept as they are.
  - against JAX's step on data_mesh(2): the same bounds, but losses 1e-5
    relative as test_torch_port_step.py holds them [1.8e-6 / 7.5e-7;
    entries 3.6e-7 / 3.4e-7; tensors 1.2e-3 / 1.5e-3; BN statistics 2.9e-6
    / 1.5e-6; parameters 6.0e-8 / 3.5e-7].
  - BatchNorm2d and BasicBlock, float64: outputs, input and weight
    gradients 1e-12 relative + 1e-12 [2.1e-15 of the largest entry, 1.4e-13
    absolute]; running statistics against the whole batch's float64
    statistics 1e-12 [9.0e-16] (the one-process module's against them,
    1e-6 [9.0e-16]: it reduces a float64 input in float64). bf16
    input under autocast: outputs and input gradients within one bf16
    rounding (2^-8 relative) [equal]; the convolutions' weight gradients
    2^-7 of the largest entry, since each rank's bf16 convolution rounds
    its half's sum [4.3e-3]; BN weight gradients and running statistics
    1e-5 relative + 1e-6 of the largest entry [2.8e-6, 1.2e-7].
  - draws: equal.
  - trainer: every rank ends with bit-equal parameters; only rank 0 writes
    the config, metrics and checkpoints; the logged losses equal the
    one-process run's to 2e-4 relative [4.0e-6 at step 2, 5.9e-5 at step
    4: after Adam's first updates, which move an entry whose gradient is
    near 0 by lr in the direction of its sign, the two runs' weights differ
    by up to 2 * lr at such entries].

Time: 60-80 s on one worker; 100-115 s beside five busy workers, 153 s
there at the lowered priority (the children and the JAX trace and compile
of the step, ~35 s, run side by side).
"""

import copy
import functools
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

WORLD, B, H, W, F = 2, 4, 32, 64, 3
F_MAX = (3, 2, 3, 1)
STEPS = 2
GEN_SEEDS = (101, 102)
ST = dict(height=H, width=W, F=F, scales=(0,), trimin=True, incremental=True, partial=True,
          decomp=True, pose_error=5.5, dtype="float32")
LR, ADAM_EPS = 1e-4, 1e-8  # make_optimizer's; the schedule is flat over these steps
FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


# --------------------------------------------------------------------------
# Inputs and runs shared by the children and the pytest process
# --------------------------------------------------------------------------
def _batch(seed):
    """A global batch of B samples with smooth textured frames (see
    test_torch_port_step.py::_smooth_frames for why smooth), varied
    windows, flips and jitter."""
    from baseboostdepth_tpu_torch.data.augment import sample_jitter_params
    from baseboostdepth_tpu_torch.training.batch import make_batch, num_frames

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
            if abs(o) > F_MAX[b]:
                frames[b, o + F] = frames[b, F]
    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    flip = np.arange(B) % 2 == 1
    stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    stereo_T[:, 0, 3] = np.where(flip, -0.1, 0.1)
    jitter = sample_jitter_params(rng, B, NF)
    return make_batch(frames, np.asarray(F_MAX), K, stereo_T, flip, jitter, F, True, True)


@functools.cache
def _built_networks():
    from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
    from baseboostdepth_tpu_torch.parallel import broadcast_state_
    from baseboostdepth_tpu_torch.training.step import StepStatic, init_state

    state = init_state(StepStatic(**ST), device="cpu", steps_per_epoch=10)
    realistic_pose_bias_(state.pose_net)
    broadcast_state_([state.depth_net, state.pose_net])
    return state.depth_net, state.pose_net


def initial_state():
    """A fresh TrainState at the port's init (seed 0), the pose head biased
    to KITTI-scale motion, rank 0's copy on every rank: copies of networks
    built once a process (the build takes seconds) under a new Adam and
    schedule, as init_state makes them."""
    from baseboostdepth_tpu_torch.training.optim import make_optimizer
    from baseboostdepth_tpu_torch.training.step import TrainState

    depth_net, pose_net = (copy.deepcopy(m) for m in _built_networks())
    opt, sched = make_optimizer([*depth_net.parameters(), *pose_net.parameters()],
                                steps_per_epoch=10)
    return TrainState(0, depth_net, pose_net, opt, sched)


def run_step(state, k, noises=None):
    """Train step k on this process's rows of global batch k, its automask
    noise drawn from the generator seeded GEN_SEEDS[k], or given as the
    global array noises[k]. Returns the global loss, the (averaged)
    gradients, and the parameters and BN running statistics after it."""
    from baseboostdepth_tpu_torch.parallel import all_reduce_mean, local_rows
    from baseboostdepth_tpu_torch.training.step import StepStatic, make_train_step

    step = make_train_step(StepStatic(**ST), device="cpu")
    batch = {n: local_rows(torch.as_tensor(v)) for n, v in _batch(seed=k).items()}
    if noises is None:
        metrics = step(state, batch, generator=torch.Generator().manual_seed(GEN_SEEDS[k]))
    else:
        metrics = step(state, batch, noise=torch.from_numpy(noises[k].copy()))
    return dict(loss=float(all_reduce_mean([metrics["loss"]])[0]), grads=named(state, "grads"),
                params=named(state, "params"), buffers=named(state, "buffers"))


def state_after_first_step(grads, buffers):
    """A one-process TrainState in the state a run reached after its first
    step, rebuilt from that step's (averaged) gradients and BN statistics:
    the initial state, the gradients set, one Adam and scheduler step (the
    same arithmetic as the run's), the running statistics copied."""
    state = initial_state()
    for net, m in (("depth", state.depth_net), ("pose", state.pose_net)):
        for n, p in m.named_parameters():
            g = grads.get(f"{net}.{n}")
            p.grad = None if g is None else torch.from_numpy(g.copy())
        with torch.no_grad():
            for n, b in m.named_buffers():
                if "running_" in n:
                    b.copy_(torch.from_numpy(buffers[f"{net}.{n}"]))
    state.optimizer.step()
    state.scheduler.step()
    state.step = 1
    return state


def bn_modules(dtype):
    """A BatchNorm2d(6) with random affine parameters and a BasicBlock(6 ->
    8, stride 2, with its projection), from a fixed seed."""
    from baseboostdepth_tpu_torch.models.resnet import BasicBlock, BatchNorm2d

    torch.manual_seed(3)
    bn, block = BatchNorm2d(6), BasicBlock(6, 8, stride=2)
    for m in (bn, *block.modules()):
        if isinstance(m, BatchNorm2d):
            torch.nn.init.uniform_(m.weight, 0.5, 1.5)
            torch.nn.init.uniform_(m.bias, -0.5, 0.5)
    return bn.to(dtype), block.to(dtype)


def bn_inputs():
    g = torch.Generator().manual_seed(4)
    x = 3.0 + torch.randn(B, 6, 9, 11, generator=g, dtype=torch.float64)
    return x, torch.randn(B, 6, 9, 11, generator=g, dtype=torch.float64), \
        torch.randn(B, 8, 5, 6, generator=g, dtype=torch.float64)


def run_bn(case):
    """The two modules in train mode on this process's rows of the inputs:
    float64, or the float32 modules on a bf16 input under autocast. Returns
    outputs, input gradients (of sum(y * cotangent)), weight gradients and
    running statistics, each as float64 arrays."""
    from baseboostdepth_tpu_torch.parallel import local_rows

    from baseboostdepth_tpu_torch.models.resnet import BatchNorm2d

    x, ct_bn, ct_block = (local_rows(t) for t in bn_inputs())
    dtype = torch.float64 if case == "float64" else torch.float32
    out = {}
    for name, m, ct in zip(("bn", "block"), bn_modules(dtype), (ct_bn, ct_block)):
        xi = (x if case == "float64" else x.to(torch.bfloat16)).clone().requires_grad_(True)
        m.train()
        for n, bn in m.named_modules():
            # each BN's running statistics after one update from this
            # process's input, in float64 (the modules start at 0 and 1)
            def exact(module, args, key=f"{name}/exact/{n + '.' if n else ''}"):
                v, mu = torch.var_mean(args[0].detach().double(), dim=(0, 2, 3), correction=0)
                out[key + "running_mean"] = (0.1 * mu).numpy()
                out[key + "running_var"] = (0.9 + 0.1 * v).numpy()
            if isinstance(bn, BatchNorm2d):
                bn.register_forward_pre_hook(exact)
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=case == "bf16"):
            y = m(xi)
        (y.double() * ct).sum().backward()
        out[f"{name}/y"] = y.detach().double().numpy()
        out[f"{name}/dx"] = xi.grad.double().numpy()
        for n, p in m.named_parameters():
            out[f"{name}/grad/{n}"] = p.grad.double().numpy()
        for n, b in m.named_buffers():
            if "running_" in n:
                out[f"{name}/{n}"] = b.double().numpy()
    return out


def run_draws(generator_seed=5):
    """Draws of a batch's leading shape, this process's rows: the automask
    noise as loss_forward draws it, MonoViT's drop-path mask (rate 0.5) and
    SQLdepth's dropout mask (rate 0.3) on all-ones inputs."""
    from baseboostdepth_tpu_torch.models.monovit import drop_path
    from baseboostdepth_tpu_torch.models.sql import dropout
    from baseboostdepth_tpu_torch.parallel import draw_local, local_rows

    gen = torch.Generator().manual_seed(generator_seed)
    noise = draw_local(torch.randn, (B // _world(), 1, H, W), generator=gen)
    path = drop_path(local_rows(torch.ones(B, 8, 16)), 0.5, True, gen)
    drop = dropout(local_rows(torch.ones(B, 2, 5, 5)), 0.3, True, gen)
    return {"noise": noise.numpy(), "drop_path": path.numpy(), "dropout": drop.numpy()}


def _world():
    from baseboostdepth_tpu_torch.parallel import world_size

    return world_size()


def write_tiny_kitti(root):
    """16 smooth 32x100 frames per camera, 8 training samples (the tree of
    tests/test_torch_port_trainer.py, without validation GT)."""
    from PIL import Image

    data = os.path.join(root, "raw")
    splits = os.path.join(root, "splits", "eigen_zhou")
    os.makedirs(splits)
    rng = np.random.default_rng(0)
    for cam in (2, 3):
        d = os.path.join(data, FOLDER, f"image_0{cam}", "data")
        os.makedirs(d)
        for i in range(16):
            base = rng.integers(40, 200, (8, 25, 3), dtype=np.uint8)
            img = Image.fromarray(base).resize((100, 32), Image.BILINEAR)
            img.save(os.path.join(d, f"{i:010d}.jpg"))
    with open(os.path.join(splits, "train_files_baselines.txt"), "w") as f:
        f.write("\n".join(f"{FOLDER} {i} l kt 0.05" for i in range(4, 12)) + "\n")
    return data, os.path.join(root, "splits")


def train_argv(tmp, name, epochs, rank=None, rdv=None, log_dir=None):
    data, splits = os.path.join(tmp, "kitti", "raw"), os.path.join(tmp, "kitti", "splits")
    argv = ["--data.kt_path", data, "--data.splits_dir", splits, "--data.height", str(H),
            "--data.width", str(W), "--data.num_workers", "1", "--model.dtype", "float32",
            "--optim.batch_size", str(B), "--optim.num_epochs", str(epochs),
            "--log.log_dir", log_dir or os.path.join(tmp, "logs"), "--log.model_name", name,
            "--log.log_frequency", "1", "--log.image_panels", "False"]
    if rank is not None:
        argv += ["--dist.enabled", "True", "--dist.coordinator", f"file://{tmp}/{rdv}",
                 "--dist.num_processes", str(WORLD), "--dist.process_id", str(rank)]
    return argv


# --------------------------------------------------------------------------
# The child: one rank
# --------------------------------------------------------------------------
def child(rank: int, tmp: str) -> None:
    from baseboostdepth_tpu_torch.cli import train as cli
    from baseboostdepth_tpu_torch.parallel import initialize_distributed
    from baseboostdepth_tpu_torch.training import checkpoint, trainer

    torch.set_num_threads(1)
    with np.load(os.path.join(tmp, "inputs.npz")) as z:
        noises = [z["noise0"], z["noise1"]]
    device = initialize_distributed(f"file://{tmp}/rdv_step", WORLD, rank, "cpu")
    assert device == torch.device("cpu")
    arrays, report = {}, {}
    arrays.update({f"draws/{k}": v for k, v in run_draws().items()})
    for case in ("float64", "bf16"):
        arrays.update({f"bn_{case}/{k}": v for k, v in run_bn(case).items()})
    for seq, seq_noises in (("gen", None), ("noise", noises)):
        state = initial_state()
        report[seq] = []
        for k in range(STEPS):
            s = run_step(state, k, seq_noises)
            report[seq].append({"loss": s["loss"], **{f"digest_{w}": digest(s[w])
                                                      for w in ("grads", "params", "buffers")}})
            if rank == 0:
                for w in ("grads", "params", "buffers"):
                    arrays.update({f"{seq}/{k}/{w}/{n}": v for n, v in s[w].items()})
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)

    # cli.train with --dist.enabled: count what each rank writes
    writes = {"checkpoint": 0, "metrics": 0, "config": 0}

    def counted(kind, fn):
        def wrapper(*args, **kwargs):
            writes[kind] += 1
            return fn(*args, **kwargs)
        return wrapper

    checkpoint.CheckpointManager.save = counted("checkpoint", checkpoint.CheckpointManager.save)
    trainer.MetricLogger.log = counted("metrics", trainer.MetricLogger.log)
    trainer.Config.save = counted("config", trainer.Config.save)
    tr = cli.main(train_argv(tmp, "dist", 1, rank, "rdv_train1"), device="cpu")
    report["epoch0"] = {"step": tr.state.step, "digest": digest(named(tr.state, "params"))}
    tr = cli.main(train_argv(tmp, "dist", 2, rank, "rdv_train2"), device="cpu")
    report["epoch1"] = {"step": tr.state.step, "start_epoch": tr.start_epoch,
                        "digest": digest({**named(tr.state, "params"),
                                          **named(tr.state, "buffers")}),
                        "writes": dict(writes)}
    # rank 1 looks into another (empty) checkpoint directory
    other = os.path.join(tmp, "logs_rank1") if rank == 1 else None
    try:
        cli.main(train_argv(tmp, "dist", 3, rank, "rdv_train3", log_dir=other), device="cpu")
        report["mismatch"] = "no error"
    except RuntimeError as e:
        report["mismatch"] = str(e)
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


def jax_noise():
    """The automask noise JAX's loss_forward draws from PRNGKey(k + 1) at
    the global batch, for each step."""
    import jax

    return [np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(k + 1))[0],
                                         (B, 1, H, W)) * 1e-5) for k in range(STEPS)]


class JaxMeshStep:
    """JAX's loss_forward gradient and Adam update, jitted, on data_mesh(2):
    the state replicated and the batch sharded with the JAX package's
    `replicate` and `shard_batch`; step k draws its noise from
    PRNGKey(k + 1) (`jax_noise`). Adam's state for a later step is built
    from the port run's gradients (`adam_state`), so that both updates start
    from the same moments."""

    def __init__(self):
        import jax
        import optax

        from baseboostdepth_tpu.parallel import data_mesh
        from baseboostdepth_tpu.training.optim import make_optimizer
        from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
        from baseboostdepth_tpu.training.step import loss_forward

        self.mesh = data_mesh(2)
        jst = JaxStepStatic(warp_impl="corner", merged_warp=True, **ST)
        self.opt = opt = make_optimizer(steps_per_epoch=10)
        mesh = self.mesh

        @jax.jit
        def step(p, s, o, b, key):
            (loss, (_, new_s)), g = jax.value_and_grad(
                lambda p_: loss_forward(p_, s, b, key, jst, True, mesh), has_aux=True)(p)
            upd, o = opt.update(g, o, p)
            return loss, g, optax.apply_updates(p, upd), new_s, o

        self._step = step

    def adam_state(self, state, grads):
        """Adam's state after one update of the port's `state` by the port's
        named `grads` (zeros where a parameter has none)."""
        import jax
        import jax.numpy as jnp

        from baseboostdepth_tpu.parallel import replicate
        from test_torch_port_step import to_flax

        def with_grads(net, m):
            sd = m.state_dict()
            for n, _ in m.named_parameters():
                g = grads.get(f"{net}.{n}")
                sd[n] = torch.zeros_like(sd[n]) if g is None else torch.from_numpy(g)
            return sd

        params, _ = to_flax(state.depth_net.state_dict(), state.pose_net.state_dict())
        g, _ = to_flax(with_grads("depth", state.depth_net), with_grads("pose", state.pose_net))
        p, g = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, g)
        return replicate(self.opt.update(g, self.opt.init(p), p)[1], self.mesh)

    def __call__(self, state, k, opt_state=None):
        """Step k from the weights and BN statistics of the port's `state`;
        Adam's state from `opt_state` (a fresh one if None). Returns the
        result named as the port's, and Adam's new state."""
        import jax
        import jax.numpy as jnp

        from baseboostdepth_tpu.parallel import replicate, shard_batch
        from baseboostdepth_tpu_torch.models.convert import from_jax
        from test_torch_port_step import to_flax

        params, stats = to_flax(state.depth_net.state_dict(), state.pose_net.state_dict())
        p = replicate(jax.tree.map(jnp.asarray, params), self.mesh)
        s = replicate(jax.tree.map(jnp.asarray, stats), self.mesh)
        o = replicate(self.opt.init(p), self.mesh) if opt_state is None else opt_state
        b = shard_batch(jax.tree.map(jnp.asarray, _batch(seed=k)), self.mesh)
        loss, g, p, s, o = self._step(p, s, o, b, jax.random.PRNGKey(k + 1))
        s = jax.tree.map(np.asarray, s)
        gd, gp = from_jax(jax.tree.map(np.asarray, g), s)
        nd, np_ = from_jax(jax.tree.map(np.asarray, p), s)

        def named(d, p_):
            return {**{f"depth.{n}": v.numpy() for n, v in d.items()},
                    **{f"pose.{n}": v.numpy() for n, v in p_.items()}}

        def params_only(d):  # from_jax fills in the BN buffers too
            return {n: v for n, v in d.items()
                    if "running_" not in n and "num_batches" not in n}

        new = named(nd, np_)
        return dict(loss=float(loss), grads=params_only(named(gd, gp)),
                    params=params_only(new),
                    buffers={n: v for n, v in new.items() if "running_" in n}), o


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both children's results, and per sequence and step the references
    from the same state: step 0 from the initial state, step 1 from the
    two-process run's state after step 0 (rebuilt in one process, see
    `state_after_first_step`).

    The suite's longest file, tests/test_zoo_training.py, runs beside this
    one and sets the suite's wall clock (ROADMAP.md, "The time budget"):
    the children inherit this module's lowered CPU priority
    (`one_torch_thread`), so that a busy CPU serves the other workers'
    tests before these three processes."""
    from baseboostdepth_tpu_torch.cli import train as cli

    tmp = str(tmp_path_factory.mktemp("dist"))
    noises = jax_noise()
    np.savez(os.path.join(tmp, "inputs.npz"), noise0=noises[0], noise1=noises[1])
    write_tiny_kitti(os.path.join(tmp, "kitti"))
    with ranks_running(__file__, WORLD, tmp) as procs:
        # while the children run: what needs nothing of theirs
        ref = {"draws": run_draws(), "bn_float64": run_bn("float64"),
               "bn_bf16": run_bn("bf16")}
        state = initial_state()
        ref["params0"] = named(state, "params")
        ref["gen"] = [run_step(state, 0)]
        jax_step = JaxMeshStep()
        ref["jax"] = [jax_step(initial_state(), 0)[0]]
        cli.main(train_argv(tmp, "one", 2), device="cpu")  # resuming is exact
        wait_ranks(procs)
    ranks = []
    for r in range(WORLD):
        path = os.path.join(tmp, f"rank{r}.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        os.remove(path)  # ~450 MB of rank 0's gradients and parameters
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append({"arrays": arrays, "report": json.load(f)})
    got = ranks[0]["arrays"]
    rebuilt = {}
    for seq in ("gen", "noise"):
        state = state_after_first_step(split(got, f"{seq}/0/grads/"),
                                       split(got, f"{seq}/0/buffers/"))
        rebuilt[seq] = named(state, "params")
        if seq == "gen":
            ref["gen"].append(run_step(state, 1))
        else:
            adam = jax_step.adam_state(initial_state(), split(got, "noise/0/grads/"))
            ref["jax"].append(jax_step(state, 1, adam)[0])
    return {"tmp": tmp, "ref": ref, "ranks": ranks, "rebuilt": rebuilt}


def _got(runs, seq, k):
    arrays, report = runs["ranks"][0]["arrays"], runs["ranks"][0]["report"]
    return {"loss": report[seq][k]["loss"],
            **{w: split(arrays, f"{seq}/{k}/{w}/") for w in ("grads", "params", "buffers")}}


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------
def test_replicas_are_bit_equal(runs):
    """Both ranks hold the same averaged gradients, parameters and BN
    statistics after every step of both runs and of the trainer; the
    one-process rebuild of the state after the first step (the references'
    start) is the two-process run's, bit for bit."""
    r0, r1 = (r["report"] for r in runs["ranks"])
    for seq in ("gen", "noise"):
        for k in range(STEPS):
            for w in ("grads", "params", "buffers"):
                a, b = r0[seq][k][f"digest_{w}"], r1[seq][k][f"digest_{w}"]
                assert a.keys() == b.keys()
                assert a == b, f"{seq} step {k} {w}: {[n for n in a if a[n] != b[n]][:5]}"
            assert r0[seq][k]["loss"] == r1[seq][k]["loss"]
        assert digest(runs["rebuilt"][seq]) == r0[seq][0]["digest_params"]
    assert r0["epoch0"]["digest"] == r1["epoch0"]["digest"]
    assert r0["epoch1"]["digest"] == r1["epoch1"]["digest"]


def test_two_processes_match_one_process(runs):
    """The generator-driven run, each step against the one-process port
    step on the global batch with the same generator from the same state;
    and Adam's two updates held to their formula on the run's own averaged
    gradients, everywhere."""
    for k in range(STEPS):
        print("measured, step", k, check_step(
            _got(runs, "gen", k), runs["ref"]["gen"][k], k, "one process", loss_rtol=1e-6,
            grad_rtol=1e-4, grad_atol=2e-5, leaf_rtol=3e-2, leaf_rms=1e-7, stats_rtol=1e-4,
            stats_floor=1e-5, pinned_at=4e-5))
    b1, b2 = 0.9, 0.999
    g1, g2 = (_got(runs, "gen", k)["grads"] for k in range(STEPS))
    p1, p2 = (_got(runs, "gen", k)["params"] for k in range(STEPS))
    params0 = runs["ref"]["params0"]
    for n in p1:
        if n not in g1:  # no gradient: Adam leaves it
            np.testing.assert_array_equal(p2[n], params0[n])
            continue
        a, b = g1[n].astype(np.float64), g2[n].astype(np.float64)
        e1 = params0[n] - LR * a / (np.abs(a) + ADAM_EPS)
        np.testing.assert_allclose(p1[n], e1, rtol=0, atol=1e-6, err_msg=f"Adam 1 {n}")
        m = b1 * (1 - b1) * a + (1 - b1) * b
        v = b2 * (1 - b2) * a * a + (1 - b2) * b * b
        e2 = p1[n] - LR * (m / (1 - b1**2)) / (np.sqrt(v / (1 - b2**2)) + ADAM_EPS)
        np.testing.assert_allclose(p2[n], e2, rtol=0, atol=1e-6, err_msg=f"Adam 2 {n}")


def test_two_processes_match_jax_data_mesh(runs):
    """The run with JAX's global noise, each step against JAX's step on
    data_mesh(2) from the same weights and BN statistics."""
    for k in range(STEPS):
        print("measured, step", k, check_step(
            _got(runs, "noise", k), runs["ref"]["jax"][k], k, "JAX", loss_rtol=1e-5,
            grad_rtol=1e-4, grad_atol=2e-5, leaf_rtol=3e-2, leaf_rms=1e-7, stats_rtol=1e-4,
            stats_floor=1e-5, pinned_at=4e-5))


@pytest.mark.parametrize("case", ["float64", "bf16"])
def test_global_batch_norm_matches_whole_batch(runs, case):
    """BatchNorm2d and a BasicBlock on each rank's half equal the
    whole-batch modules in one process: the ranks' outputs and input
    gradients are the rows of the whole batch's, their weight gradients sum
    to its, and their running statistics (equal on both ranks) are the
    whole batch's. In float64 those are held to the whole batch's float64
    statistics, to which the one-process module's are held too (1e-6). With
    a bf16 input the lone BatchNorm's statistics and output are the whole
    batch's bit for bit, and each rank's bf16 convolutions round its half's
    weight gradient before the halves are added."""
    halves = [split(r["arrays"], f"bn_{case}/") for r in runs["ranks"]]
    ref = runs["ref"][f"bn_{case}"]
    assert halves[0].keys() == ref.keys()
    for n, r in ref.items():
        if "/exact/" in n:
            continue
        module, key = n.split("/", 1)
        if n.endswith(("/y", "/dx")):
            got = np.concatenate([h[n] for h in halves])
        elif "/grad/" in n:
            got = halves[0][n] + halves[1][n]
        else:
            got = halves[0][n]
            np.testing.assert_array_equal(got, halves[1][n], err_msg=n)
        if case == "bf16" and module == "bn" and (key == "y" or "running_" in key):
            # the halves' float64 sums, all-reduced, round once to the whole
            # batch's float32 sums: its statistics and output, bit for bit
            np.testing.assert_array_equal(got, r, err_msg=n)
        if case == "float64":
            if "running_" in key:
                exact = ref[f"{module}/exact/{key}"]
                np.testing.assert_allclose(r, exact, rtol=1e-6, err_msg=f"one process {n}")
                r = exact
            np.testing.assert_allclose(got, r, rtol=1e-12, atol=1e-12, err_msg=n)
        elif n.endswith(("/y", "/dx")):  # bf16 values: one rounding apart at most
            np.testing.assert_allclose(got, r, rtol=2.0**-8, atol=1e-6, err_msg=n)
        elif "conv" in key or "downsample.0" in key:
            np.testing.assert_allclose(got, r, rtol=0, atol=2.0**-7 * np.abs(r).max(),
                                       err_msg=n)
        else:
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6 * np.abs(r).max(),
                                       err_msg=n)


def test_random_draws_match_one_process(runs):
    """The automask noise, MonoViT's drop-path and SQLdepth's dropout drawn
    on each rank are its rows of the one-process draws; with no process
    group the helpers are the identity."""
    from baseboostdepth_tpu_torch import parallel

    for k, ref in runs["ref"]["draws"].items():
        got = np.concatenate([split(r["arrays"], "draws/")[k] for r in runs["ranks"]])
        np.testing.assert_array_equal(got, ref, err_msg=k)
    assert (parallel.world_size(), parallel.rank(), parallel.is_lead()) == (1, 0, True)
    x = torch.arange(6.0)
    assert parallel.local_rows(x) is x and parallel.all_reduce_mean([x])[0] is x
    assert parallel.broadcast_int(7) == 7


def test_dist_trainer_is_lead_only_and_matches_one_process(runs):
    """cli.train --dist.enabled in two processes: one epoch, then a resumed
    second; only rank 0 writes the config, metrics and checkpoints; the
    ranks end equal; the logged losses are the one-process run's; the
    loader's rows of each rank partition the global batch; a rank that sees
    another checkpoint than the lead makes every rank raise."""
    from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
    from baseboostdepth_tpu_torch.data.kitti import KittiRawIndex
    from baseboostdepth_tpu_torch.data.loader import KittiTrainLoader

    tmp = runs["tmp"]
    r0, r1 = (r["report"] for r in runs["ranks"])
    for r in (r0, r1):
        assert r["epoch0"]["step"] == 2 and r["epoch1"]["step"] == 4
        assert r["epoch1"]["start_epoch"] == 1
        assert "shared by all processes" in r["mismatch"], r["mismatch"]
    # the lead writes the config twice (each run), one metrics line a
    # logged step, a checkpoint at each epoch's end; rank 1 nothing
    assert r0["epoch1"]["writes"] == {"checkpoint": 2, "metrics": 2, "config": 2}
    assert r1["epoch1"]["writes"] == {"checkpoint": 0, "metrics": 0, "config": 0}
    assert r0["epoch0"]["digest"] == r1["epoch0"]["digest"]
    assert r0["epoch1"]["digest"] == r1["epoch1"]["digest"]
    assert not os.path.exists(os.path.join(tmp, "logs_rank1", "dist", "config.json"))

    def logged(name):
        with open(os.path.join(tmp, "logs", name, "metrics.jsonl")) as f:
            return [m for m in map(json.loads, f) if "imgs_per_sec" in m]

    dist_log, one_log = logged("dist"), logged("one")
    assert [m["step"] for m in dist_log] == [m["step"] for m in one_log] == [2, 4]
    for a, b in zip(dist_log, one_log):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-4)
    # the ranks' loader rows partition the global batch, byte for byte
    index = KittiRawIndex(os.path.join(tmp, "kitti", "raw"),
                          os.path.join(tmp, "kitti", "splits", "eigen_zhou",
                                       "train_files_baselines.txt"), ".jpg")

    def loader(p, n):
        return KittiTrainLoader(index, stage_for_epoch(0, True), B, H, W, trimin=True,
                                num_workers=1, seed=7, process_index=p, process_count=n)

    for whole, *parts in zip(loader(0, 1), loader(0, 2), loader(1, 2)):
        for k, v in whole.items():
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), v, err_msg=k)


if __name__ == "__main__":
    child(int(sys.argv[1]), sys.argv[2])
