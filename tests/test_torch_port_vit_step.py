"""Port parity: one training step of the monovit zoo against the JAX
package's step (`check_late_step`, which tests/test_torch_port_diffnet_step.py
runs for diffnet, each file under a minute on one worker), the eval and
debug forwards of both zoos, and MonoViT's two-group AdamW against
optax.multi_transform of two optax.adamw.

The step: the late stage's method at a small frame budget (F=3,
incremental + partial + decomp, scale 0), 64x128, batch 2, fp32, the same
weights, batch and automask noise, as tests/test_torch_port_step.py's
`late_F3_incremental_partial` case holds md2. The depth networks are cut so
that JAX compiles in seconds, on both sides alike (module-level names put
in place by monkeypatch): MonoViT over a minimal MPViT (widths 16-64, 8
heads, one path and one block a stage; tests/test_torch_port_monovit.py
holds the richer narrow one) with drop-path off, DIFFNet with HRNet-18's
stages 3 and 4
cut to one module each (tests/test_torch_port_diffnet.py). The port's init
(from seed 0, the pose head biased to KITTI-scale motion) reaches JAX
through the JAX package's importers, JAX's gradients and updated
parameters come back through models/convert.py::from_jax. MonoViT's step
takes the two-group AdamW (the depth encoder at vit_encoder_lr 5e-5, the
rest at 1e-4, weight decay 1e-4) on both sides, DIFFNet's Adam. The JAX
side warps with its plain XLA gather (warp_impl="xla", as
tests/test_torch_port_zoo_step.py does: its Pallas kernels in interpret
mode would double the compile, and test_torch_port_step.py holds the port
against them), the port with the corner-plane kernel's plain version.

Tolerances are the whole-step bounds of ROADMAP.md, C: losses 1e-5
relative; gradients per entry 1e-4 relative + 2e-5 absolute, per tensor
3e-2 relative L2 + 1e-7 RMS (measured: entries up to 7.1e-6 (MonoViT)
and 4.0e-6 (DIFFNet) beyond the relative part, both at the depth encoder's
first conv); BN statistics
1e-4 relative with a floor of 5e-5 of each tensor's largest entry, wider
than the md2 step's 1e-5 floor, as ROADMAP.md, C says: batch-statistics
BatchNorm in float32 at batch 2 deep in the encoder, where a channel has
16 values (MPViT's stage 3, HRNet's 144-wide branch, both 2x4), makes batch
means that nearly cancel; measured 1.7e-5 (MonoViT, stage 3's aggregate)
and 1.3e-5 (DIFFNet, stage 4's fusion into the 144-wide branch) of the
largest entry. The update is held to
its formula on the port's own gradient, p - lr * wd * p - lr * g / (|g| +
1e-8) with each group's lr (wd 0 for Adam), to 1e-6, and to JAX's updated
parameters to 1e-6 where |g| > 4e-5 (the gradient's sign pinned).

The eval and debug forwards of each zoo: disp_to_depth of the finest
disparity, the network in eval mode (no drop-path drawn).

The optimizer alone: a random parameter tree with a depth-encoder and a
rest group, seven steps of random gradients with 2 steps an epoch and
milestones (2, 3) (rate x0.4 from step 2, again from step 4), all
parameters to 1e-6 relative after every step (float32 Adam moments
summed in another order).

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 40 s, JAX compiling most of it.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import baseboostdepth_tpu.models.diffnet as jax_diffnet
import baseboostdepth_tpu.models.monovit as jax_monovit
from baseboostdepth_tpu.training.optim import make_optimizer as jax_make_optimizer
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu.training.step import loss_forward as jax_loss_forward
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.models.depth_decoder import init_decoder_
from baseboostdepth_tpu_torch.models.diffnet import DIFFNetDepthNet
from baseboostdepth_tpu_torch.models.monovit import MonoViTDepthNet
from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
from baseboostdepth_tpu_torch.models.resnet import init_encoder_
from baseboostdepth_tpu_torch.training import step as step_mod
from baseboostdepth_tpu_torch.training.batch import num_temporal_slots
from baseboostdepth_tpu_torch.training.optim import make_vit_optimizer
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, make_train_step
from tests.test_torch_port_diffnet import CUT, diffnet_to_flax
from tests.test_torch_port_monovit import NARROW, monovit_to_flax
from tests.test_torch_port_step import B, GRAD_ATOL, GRAD_LEAF_RMS, GRAD_LEAF_RTOL, H, W, _batch
from tests.test_torch_port_zoos import pose_to_flax
from torch_port_helpers import lowered_priority

ADAM_EPS = 1e-8
BN_FLOOR = 5e-5  # of each statistics tensor's largest entry (ROADMAP.md, C)
LATE = dict(F=3, scales=(0,), incremental=True, partial=True, f_max=(3, 2))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


#: the smallest MPViT: one path and one block a stage (the shared encodings
#: across blocks are held in tests/test_torch_port_monovit.py)
MINIMAL = {**NARROW, "num_path": (1, 1, 1, 1), "num_layers": (1, 1, 1, 1)}


class MinimalMPViT(jax_monovit.MPViT):
    embed_dims: Tuple[int, ...] = MINIMAL["embed_dims"]
    num_path: Tuple[int, ...] = MINIMAL["num_path"]
    num_layers: Tuple[int, ...] = MINIMAL["num_layers"]
    num_heads: Tuple[int, ...] = MINIMAL["num_heads"]
    drop_path_rate: float = 0.0


def _port_net(zoo, generator):
    if zoo == "monovit":
        net = MonoViTDepthNet(**MINIMAL, drop_path_rate=0.0)
        init_decoder_(net, generator)
        return net
    net = DIFFNetDepthNet(CUT)
    init_encoder_(net.encoder, generator)
    init_decoder_(net.decoder, generator)
    return net


def _close(actual, desired, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(actual, np.float64), np.asarray(desired, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def check_late_step(zoo, monkeypatch):
    """The late step of `zoo` (monovit or diffnet, cut as the module
    docstring says) against JAX's, at the bounds stated there."""
    if zoo == "monovit":
        monkeypatch.setattr(jax_monovit, "MPViT", MinimalMPViT)
    else:
        monkeypatch.setattr(jax_diffnet, "HRNET18_STAGES", CUT)
    monkeypatch.setattr(step_mod, "build_depth_net",
                        lambda z, num_layers, generator: _port_net(z, generator))
    kw = dict(zoo=zoo, height=H, width=W, F=LATE["F"], scales=LATE["scales"], trimin=True,
              incremental=True, partial=True, decomp=True, pose_error=5.5, dtype="float32")
    jst = JaxStepStatic(warp_impl="xla", merged_warp=True, **kw)
    tst = StepStatic(**kw)
    assert tst.merged_warp
    batch = _batch(LATE["F"], LATE["f_max"], seed=LATE["F"])

    state = init_state(tst, device="cpu", steps_per_epoch=10)
    realistic_pose_bias_(state.pose_net)
    sd = state.depth_net.state_dict()
    dp, ds = monovit_to_flax(sd, MINIMAL) if zoo == "monovit" else diffnet_to_flax(sd)
    pp, ps = pose_to_flax(state.pose_net.state_dict())
    params, stats = {"depth": dp, "pose": pp}, {"depth": ds, "pose": ps}

    opt = jax_make_optimizer(steps_per_epoch=10, vit=zoo == "monovit")
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (B, 1, H, W)) * 1e-5)

    @jax.jit
    def jax_step(p, s, b, k):
        (loss, aux), grads = jax.value_and_grad(
            lambda p_: jax_loss_forward(p_, s, b, k, jst, True), has_aux=True)(p)
        updates, _ = opt.update(grads, opt.init(p), p)
        return loss, aux, grads, jax.tree.map(lambda a, u: a + u, p, updates)

    jloss, (jmetrics, jnew_stats), jgrads, jparams_new = jax_step(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jax.tree.map(jnp.asarray, batch), key)
    jparams_new = jax.tree.map(np.asarray, jparams_new)

    groups = {id(p): (g["lr"], g["weight_decay"]) for g in state.optimizer.param_groups
              for p in g["params"]}
    params0 = {id(p): p.detach().clone().numpy()
               for net in (state.depth_net, state.pose_net) for p in net.parameters()}
    metrics = make_train_step(tst, device="cpu")(state, batch, noise=torch.tensor(noise))
    assert state.step == 1

    _close(float(metrics["loss"]), float(jloss), rtol=1e-5, what="loss")
    _close(float(metrics["loss/0"]), float(jmetrics["loss/0"]), rtol=1e-5, what="loss/0")

    gd, gp = from_jax(jax.tree.map(np.asarray, jgrads), stats)
    nd, np_ = from_jax(jparams_new, jax.tree.map(np.asarray, jnew_stats))
    for net, g_ref, new_ref in ((state.depth_net, gd, nd), (state.pose_net, gp, np_)):
        n_checked = 0
        for name, p in net.named_parameters():
            g = g_ref[name].numpy().astype(np.float64)
            tgrad = p.grad.numpy() if p.grad is not None else np.zeros(g.shape, np.float32)
            _close(tgrad, g, rtol=1e-4, atol=GRAD_ATOL, what=f"grad {name}")
            err = np.linalg.norm(tgrad - g)
            bound = GRAD_LEAF_RTOL * np.linalg.norm(g) + GRAD_LEAF_RMS * np.sqrt(g.size)
            assert err <= bound, f"grad {name}: |diff| {err:.3e} > {bound:.3e}"

            lr, wd = groups[id(p)]
            p_new = p.detach().numpy().astype(np.float64)
            p0, t64 = params0[id(p)].astype(np.float64), tgrad.astype(np.float64)
            expect = p0 - lr * wd * p0 - lr * t64 / (np.abs(t64) + ADAM_EPS)
            np.testing.assert_allclose(p_new, expect, rtol=0, atol=1e-6, err_msg=f"update {name}")
            pinned = np.abs(g) > 2 * GRAD_ATOL
            diff = np.abs(p_new - new_ref[name].numpy())
            assert (diff[pinned] <= 1e-6).all(), f"param after the update {name}"
            n_checked += 1
        assert n_checked == len(list(net.parameters()))
        for name, buf in net.state_dict().items():
            if "running_" in name:
                ref = new_ref[name].numpy()
                _close(buf.numpy(), ref, rtol=1e-4, atol=BN_FLOOR * np.abs(ref).max(), what=name)
    if zoo == "monovit":
        lrs = [g["lr"] for g in state.optimizer.param_groups]
        assert lrs == [5e-5, 1e-4]


@pytest.mark.parametrize("zoo", ["monovit", "diffnet"])
def test_eval_and_debug_forwards(zoo, monkeypatch):
    """make_eval_forward gives disp_to_depth of the network's finest
    disparity in eval mode, as the JAX package's does (the networks
    themselves are held against JAX in test_torch_port_monovit.py and
    _diffnet.py); make_debug_forward runs the network in eval mode, so two
    generators give the same disparity and warped candidates (only the
    automask noise differs), all finite."""
    from baseboostdepth_tpu_torch.geometry import disp_to_depth
    from baseboostdepth_tpu_torch.training.step import make_debug_forward, make_eval_forward

    monkeypatch.setattr(step_mod, "build_depth_net",
                        lambda z, num_layers, generator: _port_net(z, generator))
    tst = StepStatic(zoo=zoo, height=H, width=W, F=2, scales=(0, 1, 2, 3), trimin=True,
                     incremental=False, partial=False, decomp=True, dtype="float32")
    state = init_state(tst, device="cpu")
    if zoo == "monovit":  # drop-path on: eval mode must not draw it
        for m in state.depth_net.modules():
            if hasattr(m, "drop_rate"):
                m.drop_rate = 0.5
    batch = _batch(2, (2, 1), seed=11)
    images = batch["frames"][:, 2].astype(np.float32) / 255.0
    tdepth = make_eval_forward(tst, device="cpu")(state.depth_net, images)
    with torch.no_grad():
        disp0 = state.depth_net.eval()(torch.from_numpy(images))[0][..., 0]
    assert tdepth.shape == (B, H, W)
    assert torch.equal(tdepth, disp_to_depth(disp0, tst.min_depth, tst.max_depth)[1])

    debug = make_debug_forward(tst, device="cpu")
    a = debug(state.depth_net, state.pose_net, batch, torch.Generator().manual_seed(0))
    b = debug(state.depth_net, state.pose_net, batch, torch.Generator().manual_seed(1))
    for k in ("disp", "depth", "warped"):
        assert torch.equal(a[k], b[k]) and bool(torch.isfinite(a[k]).all()), k
    assert a["warped"].shape == (B, num_temporal_slots(2, True) + 1, H, W, 3)  # + stereo


def test_late_step_matches_jax(monkeypatch):
    check_late_step("monovit", monkeypatch)


def test_two_group_adamw_matches_optax_across_a_schedule_boundary():
    """make_vit_optimizer against the JAX package's make_optimizer(vit=True)
    over seven steps crossing two milestones; every parameter to 1e-6
    relative after every step."""
    rng = np.random.default_rng(0)
    shapes = {"depth": {"encoder": {"a": (3, 4), "b": (5,)}, "decoder": {"c": (2, 3)}},
              "pose": {"encoder": {"d": (4,)}}}
    tree = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
             for _ in range(7)]

    tparams = jax.tree.map(lambda a: torch.nn.Parameter(torch.tensor(a)), tree)
    enc = list(tparams["depth"]["encoder"].values())
    rest = [tparams["depth"]["decoder"]["c"], tparams["pose"]["encoder"]["d"]]
    opt, sched = make_vit_optimizer(enc, rest, 1e-3, 4e-4, milestones=(2, 3), gamma=0.4,
                                    steps_per_epoch=2)
    jopt = jax_make_optimizer(1e-3, (2, 3), 0.4, 2, vit=True, vit_encoder_lr=4e-4)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    lrs = []
    for g in grads:
        jax.tree.map(lambda p, gi: setattr(p, "grad", torch.tensor(gi)), tparams, g)
        lrs.append([grp["lr"] for grp in opt.param_groups])
        opt.step()
        sched.step()
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for t, j in zip(jax.tree.leaves(tparams), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    # the rates the schedule gave each step: x0.4 from step 2, again from 4
    np.testing.assert_allclose(
        lrs, [[4e-4 * f, 1e-3 * f] for f in (1, 1, 0.4, 0.4, 0.16, 0.16, 0.16)], rtol=1e-12)
