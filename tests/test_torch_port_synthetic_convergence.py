"""Port parity: the JAX package's CPU convergence recipe
(tests/test_synthetic_convergence.py) replayed in the port step for step.

The recipe: 56 frames of SyntheticScene(seed) at 64x192 in KITTI layout
(margin 7, a fifth for validation: 34 train and 8 val samples), the
curriculum's epoch-8 stage (F=2, scales 0-1, tri-min, decomp, direct
poses), float32, Adam at a flat 1e-4, batch 12, 100 steps; a new
KittiTrainLoader (2 workers, PIL decode) whenever one runs out, its seed
and each step's PRNGKey drawn from np.random.default_rng(0) in the JAX
test's order. The port starts from JAX's init_state(PRNGKey(0)) carried
across by models/convert.py::from_jax, trains on the port's loader (its
batches byte-equal to JAX's) and takes, at each step, the automask noise
that JAX's step draws from its key (`noise=`). Both packages run side by
side on the CPU; abs_rel and a1 (median scaling, each package's eval
forward and metrics) every EVAL_EVERY steps on the 8 val frames, with the
predicted depth's 95th / 5th percentile ratio.

Cases (single-worker times on the repository's CPU test machine, 8
cores, one torch thread):
- the recipe's first 10 batches byte-equal between the two packages'
  loaders (~16 s, of it ~15 s the module fixture's render in 4
  processes);
- the recipe's first 3 steps at batch 12 from JAX's init with the pose
  head biased to KITTI-scale motion, each from JAX's state at that step,
  with JAX's batch and noise: loss and per-scale losses, every gradient
  and the BN statistics after the step held to test_torch_port_step.py's
  whole-step bounds (~58 s: JAX's jitted init ~20 s and step compile
  ~14 s, a port step ~6 s);
- slow: the whole recipe in both packages from JAX's unbiased init
  (`run_recipe`), the JAX test's four criteria held for the port, the
  first step's loss to 1e-6 relative of JAX's and the port's final
  abs_rel within 0.05 of JAX's, computed here (559 s at 4 torch
  threads). `python tests/torch_port_c4.py recipe SCENE_SEED` runs the
  same and writes its record.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.data import kitti as jax_kitti
from baseboostdepth_tpu.data.curriculum import stage_for_epoch as jax_stage_for_epoch
from baseboostdepth_tpu.data.loader import EvalLoader as JaxEvalLoader
from baseboostdepth_tpu.data.loader import KittiTrainLoader as JaxTrainLoader
from baseboostdepth_tpu.evaluation.metrics import METRIC_NAMES as JAX_METRIC_NAMES
from baseboostdepth_tpu.evaluation.metrics import single_image_errors as jax_errors
from baseboostdepth_tpu.training.optim import make_optimizer as jax_make_optimizer
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu.training.step import init_state as jax_init_state
from baseboostdepth_tpu.training.step import loss_forward as jax_loss_forward
from baseboostdepth_tpu.training.step import make_eval_forward as jax_make_eval_forward
from baseboostdepth_tpu.training.step import make_train_step as jax_make_train_step
from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
from baseboostdepth_tpu_torch.data.loader import EvalLoader, KittiTrainLoader
from baseboostdepth_tpu_torch.data.synthetic import SyntheticScene, materialize_kitti_layout
from baseboostdepth_tpu_torch.evaluation.metrics import METRIC_NAMES, single_image_errors
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, make_eval_forward
from baseboostdepth_tpu_torch.training.step import make_train_step
from torch_port_helpers import lowered_priority, named


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker; the module at a lowered CPU priority
    (torch_port_helpers.lowered_priority)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


H, W, N_FRAMES, B, LR, N_STEPS = 64, 192, 56, 12, 1e-4, 100
EVAL_EVERY = 5
STATIC = dict(zoo="md2", num_layers=18, height=H, width=W, F=2, scales=(0, 1), trimin=True,
              incremental=False, partial=False, decomp=True)
# test_torch_port_step.py's whole-step bounds
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 2e-5
GRAD_LEAF_RTOL, GRAD_LEAF_RMS, STATS_RTOL, STATS_FLOOR = 3e-2, 1e-7, 1e-4, 1e-5
ESCAPED = 0.45  # abs_rel under it: off the constant-depth plateau (JAX test's last criterion)


class Recipe:
    """The recipe's scene (rendered by the port's renderer, byte-equal to
    the JAX package's: test_torch_port_synthetic.py) and both packages'
    views of it."""

    def __init__(self, root: str, scene_seed: int = 0):
        root, splits_dir = materialize_kitti_layout(
            root, n_frames=N_FRAMES, width=W, height=H, seed=scene_seed, margin=7,
            val_fraction=0.2, scene=SyntheticScene(seed=scene_seed), workers=4)
        split = os.path.join(splits_dir, "synth")
        train = os.path.join(split, "train_files_baselines.txt")
        self.index = kitti.KittiRawIndex(root, train)
        self.jax_index = jax_kitti.KittiRawIndex(root, train)
        val = kitti.KittiRawIndex(root, os.path.join(split, "val_files.txt"))
        self.val_paths = [val.image_path(s.folder, s.frame_index, s.side) for s in val.samples]
        self.gt = np.load(os.path.join(split, "gt_depths.npz"))["data"]

    def stream(self, n_steps: int):
        """(JAX batch, port batch, key seed) of each step, in the JAX test's
        order of draws: a loader seed, then a PRNGKey seed a batch."""
        rng = np.random.default_rng(0)
        stage, jstage = stage_for_epoch(8, trimin=True), jax_stage_for_epoch(8, trimin=True)
        n = 0
        while True:
            kw = dict(batch_size=B, height=H, width=W, trimin=True, use_stereo=True,
                      num_workers=2, seed=int(rng.integers(2**31)), use_native=False)
            jbatches = list(JaxTrainLoader(self.jax_index, jstage, **kw))
            batches = list(KittiTrainLoader(self.index, stage, **kw))
            assert len(batches) == len(jbatches) > 0
            for jb, b in zip(jbatches, batches):
                yield jb, b, int(rng.integers(2**31))
                n += 1
                if n == n_steps:
                    return


def jax_noise(key_seed: int) -> np.ndarray:
    """The automask noise JAX's train step draws from PRNGKey(key_seed)
    (loss_forward: the first half of a split, normal, times 1e-5)."""
    key = jax.random.split(jax.random.PRNGKey(key_seed))[0]
    return np.array(jax.random.normal(key, (B, 1, H, W)) * 1e-5)


def same_bytes(jb: dict, b: dict) -> bool:
    return jb.keys() == b.keys() and all(
        np.asarray(jb[k]).dtype == np.asarray(b[k]).dtype
        and np.asarray(jb[k]).tobytes() == np.asarray(b[k]).tobytes() for k in jb)


def scores(recipe: Recipe, depth_of, loader_cls, errors, names) -> dict:
    """abs_rel & friends (median scaling, as the JAX test's _abs_rel) and the
    predicted depth's 95th / 5th percentile ratio over the val frames."""
    import cv2

    totals, depths, n = np.zeros(len(names)), [], 0
    for imgs, start, cnt in loader_cls(recipe.val_paths, H, W, batch_size=4):
        depth = depth_of(imgs.astype(np.float32) / 255.0)
        for j in range(cnt):
            g = recipe.gt[start + j]
            totals += np.array(errors(cv2.resize(depth[j], (g.shape[1], g.shape[0])), g))
            depths.append(depth[j])
            n += 1
    out = dict(zip(names, (totals / n).tolist()))
    p5, p95 = np.percentile(np.stack(depths), [5, 95])
    out["depth_spread"] = float(p95 / p5)
    return out


class JaxSide:
    """The JAX package's recipe: its init, jitted train step and eval
    forward."""

    def __init__(self, jit_init: bool = False):
        self.st = JaxStepStatic(**STATIC)
        self.opt = jax_make_optimizer(learning_rate=LR, steps_per_epoch=10**6)
        init = lambda key: jax_init_state(self.st, self.opt, key)  # noqa: E731
        # eager, as the JAX test and Trainer call it (~35 s here), or jitted
        self.state = (jax.jit(init) if jit_init else init)(jax.random.PRNGKey(0))
        self.step_fn = jax_make_train_step(self.st, self.opt)
        self.eval_fn = jax_make_eval_forward(self.st)

    def params(self):
        return jax.tree.map(np.asarray, (jax.device_get(self.state.params),
                                         jax.device_get(self.state.stats)))

    def step(self, batch, key_seed: int) -> float:
        self.state, metrics = self.step_fn(self.state, jax.tree.map(jnp.asarray, batch),
                                           jax.random.PRNGKey(key_seed))
        return float(metrics["loss"])

    def scores(self, recipe: Recipe) -> dict:
        p, s = self.state.params, self.state.stats
        return scores(recipe, lambda x: np.asarray(self.eval_fn(p, s, x)), JaxEvalLoader,
                      jax_errors, JAX_METRIC_NAMES)


def port_state(params, stats, state=None):
    """The port's TrainState (float32, Adam at a flat LR), or `state`,
    holding JAX's networks."""
    if state is None:
        state = init_state(StepStatic(**STATIC), device="cpu", learning_rate=LR,
                           steps_per_epoch=10**6)
    depth_sd, pose_sd = from_jax(params, stats)
    state.depth_net.load_state_dict(depth_sd)
    state.pose_net.load_state_dict(pose_sd)
    return state


def port_scores(recipe: Recipe, state) -> dict:
    fwd = make_eval_forward(StepStatic(**STATIC), "cpu")
    return scores(recipe, lambda x: fwd(state.depth_net, x).numpy(), EvalLoader,
                  single_image_errors, METRIC_NAMES)


def first_step_over(a, b, rtol):
    """The index (the step's number less 1) of the first step whose two
    losses differ by more than rtol relative (None: none does)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if abs(x - y) > rtol * abs(y)), None)


def run_recipe(root: str, scene_seed: int = 0, torch_threads=None) -> dict:
    """Both packages through the recipe on SyntheticScene(scene_seed),
    side by side; the record of each step's losses, the scores every
    EVAL_EVERY steps, where the curves part and where each escapes."""
    t0 = time.time()
    threads = torch.get_num_threads()
    if torch_threads:
        torch.set_num_threads(torch_threads)
    try:
        recipe = Recipe(root, scene_seed)
        jside = JaxSide()
        state = port_state(*jside.params())
        step = make_train_step(StepStatic(**STATIC), device="cpu")
        rec = {"scene_seed": scene_seed, "steps": N_STEPS, "eval_every": EVAL_EVERY,
               "jax": {"loss": [], "evals": []}, "port": {"loss": [], "evals": []}}

        def evaluate(k):
            for side, m in (("jax", jside.scores(recipe)), ("port", port_scores(recipe, state))):
                rec[side]["evals"].append(dict(step=k, **m))
            print(f"step {k}: abs_rel jax {rec['jax']['evals'][-1]['abs_rel']:.4f} port "
                  f"{rec['port']['evals'][-1]['abs_rel']:.4f} ({time.time() - t0:.0f} s)",
                  flush=True)

        evaluate(0)
        for k, (jb, b, key_seed) in enumerate(recipe.stream(N_STEPS), 1):
            rec["jax"]["loss"].append(jside.step(jb, key_seed))
            noise = torch.from_numpy(jax_noise(key_seed))
            rec["port"]["loss"].append(float(step(state, b, noise=noise)["loss"]))
            if k % EVAL_EVERY == 0:
                evaluate(k)
    finally:
        torch.set_num_threads(threads)
    jl, pl = rec["jax"]["loss"], rec["port"]["loss"]
    rec["first_loss_rel"] = abs(pl[0] - jl[0]) / abs(jl[0])
    rec["part_step_1e-3"] = first_step_over(pl, jl, 1e-3)
    rec["loss_rel_max"] = max(abs(p - j) / abs(j) for p, j in zip(pl, jl))
    for side in ("jax", "port"):
        ev = rec[side]["evals"]
        rec[side]["init"], rec[side]["final"] = ev[0], ev[-1]
        rec[side]["escape_step"] = next((e["step"] for e in ev if e["abs_rel"] < ESCAPED), None)
        # the first evaluation at which abs_rel has moved by more than 0.01
        rec[side]["leaves_init_step"] = next(
            (e["step"] for e in ev[1:] if abs(e["abs_rel"] - ev[0]["abs_rel"]) > 0.01), None)
    rec["seconds"] = time.time() - t0
    return rec


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    return Recipe(str(tmp_path_factory.mktemp("recipe_scene")))


def test_recipe_batches_byte_equal(recipe):
    """The recipe's first 10 batches (five loaders of two) from the port's
    loader byte-equal to the JAX package's, every array."""
    n = 0
    for jb, b, _ in recipe.stream(10):
        assert same_bytes(jb, b), f"batch {n}"
        n += 1
    assert n == 10


def test_first_steps_match_jax(recipe):
    """Steps 1-3 of the recipe at batch 12 from JAX's PRNGKey(0) init
    (init_state jitted) with the pose head biased to KITTI-scale motion
    (models/pose.py::realistic_pose_bias_, as test_torch_port_step.py
    does), each from JAX's state at that step (networks and BN statistics
    through from_jax), with JAX's batch and JAX's noise: the port's loss,
    per-scale losses, every gradient and its BN statistics after the step
    against JAX's (value_and_grad of loss_forward, then optax's Adam,
    jitted once) at the whole-step bounds of test_torch_port_step.py.

    Unbiased, an untrained pose network emits ~0.001-scale poses: the
    temporal warps sit near the identity and the pose network's gradient
    is as sensitive as float32 rounding gets. There, at the recipe's first
    step, JAX's gradient of the pose encoder's first convolution lies
    beyond the per-entry bound around the port's at 13 of 18,816 entries
    (by at most 3.6e-6 past it), and so does the port's own gradient when
    its weights are multiplied by 1 + 3e-7 N(0, 1), 2-3 float32 ulps, at
    17 (`tests/torch_port_c4.py step-floor`): a rounding-level spread, not
    the port's."""
    from test_torch_port_step import to_flax

    from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_

    jside = JaxSide(jit_init=True)
    opt = jside.opt
    state = port_state(*jside.params())
    realistic_pose_bias_(state.pose_net)
    p, s = jax.tree.map(jnp.asarray, to_flax(state.depth_net.state_dict(),
                                             state.pose_net.state_dict()))
    o = opt.init(p)
    step = make_train_step(StepStatic(**STATIC), device="cpu")

    @jax.jit
    def jax_step(p, s, o, b, k):
        (loss, (metrics, new_stats)), grads = jax.value_and_grad(
            lambda p_: jax_loss_forward(p_, s, b, k, jside.st, True), has_aux=True)(p)
        updates, o = opt.update(grads, o, p)
        return loss, metrics, new_stats, grads, jax.tree.map(lambda a, u: a + u, p, updates), o

    worst = []  # per step: loss relative, largest entry excess over rtol, largest tensor rel L2
    for k, (jb, b, key_seed) in enumerate(recipe.stream(3)):
        params_np, stats_np = jax.tree.map(np.asarray, (p, s))
        port_state(params_np, stats_np, state)
        loss, metrics, s, grads, p, o = jax_step(p, s, o, jax.tree.map(jnp.asarray, jb),
                                                 jax.random.PRNGKey(key_seed))
        got = step(state, b, noise=torch.from_numpy(jax_noise(key_seed)))
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=LOSS_RTOL,
                                   err_msg=f"step {k} loss")
        for sc in STATIC["scales"]:
            np.testing.assert_allclose(float(got[f"loss/{sc}"]), float(metrics[f"loss/{sc}"]),
                                       rtol=LOSS_RTOL, err_msg=f"step {k} loss/{sc}")
        worst.append([abs(float(got["loss"]) / float(loss) - 1), 0.0, 0.0])
        gd, gp = from_jax(jax.tree.map(np.asarray, grads), stats_np)
        for net, ref in ((state.depth_net, gd), (state.pose_net, gp)):
            for n, q in net.named_parameters():
                r = ref[n].numpy().astype(np.float64)
                if q.grad is None:  # a head outside the step's scales: zeros in JAX
                    assert not r.any(), n
                    continue
                g = q.grad.numpy().astype(np.float64)
                np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=f"step {k} grad {n}")
                err = np.linalg.norm(g - r)
                bound = GRAD_LEAF_RTOL * np.linalg.norm(r) + GRAD_LEAF_RMS * np.sqrt(r.size)
                assert err <= bound, f"step {k} grad {n}: |diff| {err:.3e} > {bound:.3e}"
                worst[k][1] = max(worst[k][1], float((np.abs(g - r) - GRAD_RTOL * np.abs(r)).max()))
                if np.linalg.norm(r) > 1e-5:
                    worst[k][2] = max(worst[k][2], err / np.linalg.norm(r))
        nd, np_ = from_jax(params_np, jax.tree.map(np.asarray, s))
        ref_stats = {**{f"depth.{n}": v.numpy() for n, v in nd.items()},
                     **{f"pose.{n}": v.numpy() for n, v in np_.items()}}
        for n, v in named(state, "buffers").items():
            r = ref_stats[n]
            np.testing.assert_allclose(v, r, rtol=STATS_RTOL, atol=STATS_FLOOR * np.abs(r).max(),
                                       err_msg=f"step {k} {n}")
    print(f"\nby step: loss relative, gradient entry excess over rtol, tensor relative L2: {worst}")


@pytest.mark.slow
def test_recipe_converges_in_port_as_in_jax(tmp_path):
    """The whole recipe in both packages: the JAX test's four criteria
    held for the port, its first loss to 1e-6 relative of JAX's, its
    final abs_rel within 0.05 of JAX's (JAX's computed here)."""
    rec = run_recipe(str(tmp_path), torch_threads=4)
    pl, port, jaxr = rec["port"]["loss"], rec["port"], rec["jax"]
    print(f"\nsteps {len(pl)}: loss {pl[0]:.4f} -> {np.mean(pl[-5:]):.4f}; abs_rel jax "
          f"{jaxr['init']['abs_rel']:.4f} -> {jaxr['final']['abs_rel']:.4f}, port "
          f"{port['init']['abs_rel']:.4f} -> {port['final']['abs_rel']:.4f}; curves part (1e-3) at "
          f"step index {rec['part_step_1e-3']}; escape jax {jaxr['escape_step']}, port "
          f"{port['escape_step']}; {rec['seconds']:.0f} s")
    assert rec["first_loss_rel"] <= 1e-6, rec["first_loss_rel"]
    assert np.mean(pl[-5:]) < 0.6 * pl[0], pl
    assert port["final"]["abs_rel"] < 0.75 * port["init"]["abs_rel"], (port["init"], port["final"])
    assert port["final"]["a1"] > port["init"]["a1"] + 0.15, (port["init"], port["final"])
    assert port["final"]["abs_rel"] < 0.45, port["final"]
    assert abs(port["final"]["abs_rel"] - jaxr["final"]["abs_rel"]) <= 0.05, \
        (port["final"], jaxr["final"])
