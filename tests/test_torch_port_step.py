"""Port parity: one training step of baseboostdepth_tpu_torch against
baseboostdepth_tpu, the slice as a whole.

64x128, B=2, fp32, the same weights (the port's init, carried to JAX by the
JAX package's reference-checkpoint importers; JAX's gradients come back
through models/convert.py), the same batch and the same automask noise.
The JAX side runs the corner-plane Pallas kernel in interpret mode
(warp_impl="corner"); the port runs the kernel's plain version, as it does
on any CPU tensor. Two stages, and the second once more with the step's
kernel options:

  (a) F=2, direct poses, scales (0, 1, 2, 3) -- the early curriculum stage;
  (b) F=3, incremental + partial + decomp, scale (0,) -- the late stage's
      method at a smaller frame budget;
  (c) (b) with photo_impl="fused", warp_impl="pallas" on both sides. On the
      CPU the JAX step runs its packed Pallas warp pair in interpret mode
      but its XLA photometric loss (it takes the fused kernel on a TPU
      only); the port runs the plain versions of its packed-warp and fused
      SSIM kernels. The two photometric losses have the same values, and
      their gradients differ only at ties (a clip bound, pred == target);
      the case holds the same tolerances as (b);
  (d) (a) with float frames (the uint8 frames / 255 as float32): both
      steps use them as colour without dividing, and warp them through the
      float-planes kernel pair (JAX: `bilinear_sample_pallas` in interpret
      mode; the port: the plain versions of `ops/warp_planes.py`'s
      kernels). Same tolerances.

Tolerances: total and per-scale losses 1e-5 relative; BN statistics 1e-4
relative, with a floor of 1e-5 of each tensor's largest entry for batch
means that nearly cancel. Gradients, per entry, 1e-4 relative plus 2e-5
absolute; and per parameter tensor, the L2 norm of the difference within
3e-2 of the reference's norm plus 1e-7 RMS, which pins tensors whose
entries all sit below the absolute floor. The loss is only piecewise
smooth: the min over candidates and the floor inside the bilinear warp
switch branch where two candidates tie or a coordinate crosses an integer,
and the two packages' disparities differ by ~1e-6 (float32 convolutions
summed in another order), which flips such a branch at a few pixels.
Measured on these inputs: entries differ by at most 8.9e-6 (early stage,
the encoder's conv1 weight, whose gradient reaches 7.9e-3); per tensor the
relative L2 difference is at most 1.9e-3 in the early stage (apart from
the one-entry scale-2 disparity bias, whose gradient nearly cancels to
6.8e-7 and differs by 6.1e-8) and 1.03e-2 in the late stage (BN weights of
the first block, gradients ~5e-5). Adam's first step is
lr * g / (|g| + 1e-8): every entry of the port's update is held to that
formula on its own gradient (1e-6), and to JAX's updated parameters (1e-6)
where |g| > 4e-5, so that the gradients' signs agree. Two JAX compilations:
one gradient-plus-update per stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.models.torch_import import (
    depth_decoder_torch_to_flax,
    pose_decoder_torch_to_flax,
    resnet_torch_to_flax,
)
from baseboostdepth_tpu.training.optim import make_optimizer as jax_make_optimizer
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu.training.step import loss_forward as jax_loss_forward
from baseboostdepth_tpu_torch.data.augment import sample_jitter_params
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.models.pose import realistic_pose_bias_
from baseboostdepth_tpu_torch.training.batch import make_batch, num_frames
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, make_train_step

H, W, B = 64, 128, 2
LR, ADAM_EPS = 1e-4, 1e-8  # make_optimizer defaults; the schedule is flat at step 0
GRAD_ATOL = 2e-5  # per entry, with rtol 1e-4
GRAD_LEAF_RTOL, GRAD_LEAF_RMS = 3e-2, 1e-7  # per leaf, L2

STAGES = {
    "early_F2_direct": dict(F=2, scales=(0, 1, 2, 3), incremental=False, partial=False,
                            f_max=(2, 1)),
    "late_F3_incremental_partial": dict(F=3, scales=(0,), incremental=True, partial=True,
                                        f_max=(3, 2)),
    "late_F3_fused_packed": dict(F=3, scales=(0,), incremental=True, partial=True,
                                 f_max=(3, 2), photo_impl="fused", warp_impl="pallas"),
    "early_F2_float": dict(F=2, scales=(0, 1, 2, 3), incremental=False, partial=False,
                           f_max=(2, 1), float_frames=True),
}


def _smooth_frames(rng, NF):
    """Smooth textured uint8 frames: each a sum of random plane waves.

    Bilinear warping is not differentiable at integer coordinates, and the
    two packages' grids differ in the last float32 bits; on white-noise
    frames a coordinate that crosses an integer between them swaps a texel
    pair and moves the gradient by the difference of two random texels. On
    smooth frames (as camera images are) that jump is a second difference of
    the image, small against the gradient tolerance below. Each frame has
    its own texture, so the photometric loss stays large (as on noise
    frames) against the smoothness term, whose neighbour differences of
    nearly flat disparities carry the largest relative rounding error.
    """
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    k = rng.uniform(0.05, 0.2, (B, NF, 3, 3, 2))
    ph = rng.uniform(0, 2 * np.pi, (B, NF, 3, 3))
    waves = np.sin(k[..., 0, None, None] * x + k[..., 1, None, None] * y + ph[..., None, None])
    img = 127.5 + 40.0 * waves.sum(axis=3)  # [B, NF, 3, H, W]
    return np.clip(np.rint(img), 0, 255).astype(np.uint8).transpose(0, 1, 3, 4, 2)


def _batch(F, f_max, seed, float_frames=False):
    rng = np.random.default_rng(seed)
    NF = num_frames(F)
    frames = _smooth_frames(rng, NF)
    for b in range(B):  # loader contract: out-of-window frames copy frame 0
        for o in range(-F, F + 1):
            if abs(o) > f_max[b]:
                frames[b, o + F] = frames[b, F]
    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    stereo_T[:, 0, 3] = (0.1, -0.1)
    jitter = sample_jitter_params(rng, B, NF)
    jitter[0, :, :3] = rng.uniform(0.8, 1.2, (NF, 3))
    jitter[0, :, 3] = rng.uniform(-0.1, 0.1, NF)
    flip = np.array([False, True])
    if float_frames:
        frames = frames.astype(np.float32) / np.float32(255.0)
    return make_batch(frames, np.asarray(f_max), K, stereo_T, flip, jitter, F, True, True)


def to_flax(depth_sd, pose_sd):
    """Port state_dicts -> the JAX package's (params, batch_stats) trees, via
    its own importers of the reference's torch checkpoints."""
    d = {k: v.detach().numpy() for k, v in depth_sd.items()}
    p = {k: v.detach().numpy() for k, v in pose_sd.items()}

    def sub(sd, prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    de_p, de_s = resnet_torch_to_flax(d, prefix="encoder.encoder.")
    pe_p, pe_s = resnet_torch_to_flax(p, prefix="encoder.encoder.")
    params = {
        "depth": {"encoder": de_p, "decoder": depth_decoder_torch_to_flax(sub(d, "decoder."))},
        "pose": {"encoder": pe_p, "decoder": pose_decoder_torch_to_flax(sub(p, "decoder."))},
    }
    return params, {"depth": {"encoder": de_s}, "pose": {"encoder": pe_s}}


def _close(actual, desired, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(actual, np.float64), np.asarray(desired, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("stage", list(STAGES))
def test_train_step_matches_jax(stage):
    cfg = STAGES[stage]
    kw = dict(height=H, width=W, F=cfg["F"], scales=cfg["scales"], trimin=True,
              incremental=cfg["incremental"], partial=cfg["partial"], decomp=True,
              pose_error=5.5, dtype="float32", photo_impl=cfg.get("photo_impl", "xla"))
    jst = JaxStepStatic(warp_impl=cfg.get("warp_impl", "corner"), merged_warp=True, **kw)
    tst = StepStatic(warp_impl=cfg.get("warp_impl", "auto"), **kw)
    batch = _batch(cfg["F"], cfg["f_max"], seed=cfg["F"],
                   float_frames=cfg.get("float_frames", False))
    assert batch["frames"].dtype == (np.float32 if cfg.get("float_frames") else np.uint8)

    # ---- weights: the port's init from seed 0, the pose head biased to
    # KITTI-scale motion (as bench.py does), carried to JAX
    state = init_state(tst, device="cpu", steps_per_epoch=10)
    realistic_pose_bias_(state.pose_net)
    params, stats = to_flax(state.depth_net.state_dict(), state.pose_net.state_dict())

    # ---- JAX: value_and_grad of loss_forward and one Adam update, in one
    # compiled function (the batch is an argument, not a constant)
    opt = jax_make_optimizer(steps_per_epoch=10)
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

    # ---- port: same weights, same batch, same noise, one train step
    params0 = {id(p): p.detach().clone().numpy()
               for net in (state.depth_net, state.pose_net) for p in net.parameters()}
    metrics = make_train_step(tst, device="cpu")(state, batch, noise=torch.tensor(noise))
    assert state.step == 1

    _close(float(metrics["loss"]), float(jloss), rtol=1e-5, what="loss")
    for s in cfg["scales"]:
        _close(float(metrics[f"loss/{s}"]), float(jmetrics[f"loss/{s}"]), rtol=1e-5, what=f"loss/{s}")

    # gradients: the JAX gradient tree mapped to torch names and layouts
    gd, gp = from_jax(jax.tree.map(np.asarray, jgrads), stats)
    nd, np_ = from_jax(jparams_new, jax.tree.map(np.asarray, jnew_stats))
    for net, g_ref, new_ref in ((state.depth_net, gd, nd), (state.pose_net, gp, np_)):
        n_checked = 0
        for name, p in net.named_parameters():
            g = g_ref[name].numpy().astype(np.float64)
            # a head outside StepStatic.scales gets no gradient (JAX: zeros)
            tgrad = p.grad.numpy() if p.grad is not None else np.zeros(g.shape, np.float32)
            _close(tgrad, g, rtol=1e-4, atol=GRAD_ATOL, what=f"grad {name}")
            # the leaf as a whole, so leaves whose entries all sit below the
            # absolute floor are pinned too
            err = np.linalg.norm(tgrad - g)
            bound = GRAD_LEAF_RTOL * np.linalg.norm(g) + GRAD_LEAF_RMS * np.sqrt(g.size)
            assert err <= bound, f"grad {name}: |diff| {err:.3e} > {bound:.3e} (|g| {np.linalg.norm(g):.3e})"

            # Adam's first step, from the port's own gradient, on every entry
            p_new = p.detach().numpy().astype(np.float64)
            t64 = tgrad.astype(np.float64)
            expect = params0[id(p)] - LR * t64 / (np.abs(t64) + ADAM_EPS)
            np.testing.assert_allclose(p_new, expect, rtol=0, atol=1e-6, err_msg=f"Adam {name}")
            # ... and against JAX's update where the gradient's sign is pinned
            pinned = np.abs(g) > 2 * GRAD_ATOL
            diff = np.abs(p_new - new_ref[name].numpy())
            assert (diff[pinned] <= 1e-6).all(), f"param after Adam {name}: {diff[pinned].max()}"
            n_checked += 1
        assert n_checked == len(list(net.parameters()))
        for name, buf in net.state_dict().items():
            if "running_" in name:
                ref = new_ref[name].numpy()
                _close(buf.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(), what=name)


def test_eval_and_debug_forwards_match_jax():
    """make_eval_forward (validation depth) and make_debug_forward (image
    panels) against the JAX package's, at the same weights, on the
    early-stage batch: depths and warped images to 1e-4 relative + 1e-5.
    The per-pixel candidate minimum is held to 1e-4 absolute (values ~0.15):
    SSIM over nearly flat windows magnifies the warped images' differences
    (measured up to 6e-5 where a warped candidate wins on both sides), and
    the debug forward draws its automask noise (1e-5 standard deviation)
    from its own generator. The winning candidate agrees on 99% of the
    pixels."""
    import jax

    from baseboostdepth_tpu.training.step import make_debug_forward as jax_debug
    from baseboostdepth_tpu.training.step import make_eval_forward as jax_eval
    from baseboostdepth_tpu_torch.training.step import make_debug_forward, make_eval_forward

    cfg = STAGES["early_F2_direct"]
    kw = dict(height=H, width=W, F=cfg["F"], scales=cfg["scales"], trimin=True,
              incremental=False, partial=False, decomp=True, pose_error=5.5, dtype="float32")
    jst, tst = JaxStepStatic(**kw), StepStatic(**kw)
    batch = _batch(cfg["F"], cfg["f_max"], seed=11)
    state = init_state(tst, device="cpu")
    realistic_pose_bias_(state.pose_net)
    params, stats = to_flax(state.depth_net.state_dict(), state.pose_net.state_dict())
    jparams, jstats = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)

    images = batch["frames"][:, cfg["F"]].astype(np.float32) / 255.0
    jdepth = np.asarray(jax_eval(jst)(jparams, jstats, jnp.asarray(images)))
    tdepth = make_eval_forward(tst, device="cpu")(state.depth_net, images)
    assert tdepth.shape == (B, H, W)
    _close(tdepth.numpy(), jdepth, rtol=1e-4, what="eval depth")

    jd = jax_debug(jst)(jparams, jstats, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    td = make_debug_forward(tst, device="cpu")(state.depth_net, state.pose_net, batch,
                                               torch.Generator().manual_seed(0))
    assert set(td) == set(jd)
    for k in ("target", "disp", "depth", "warped"):
        assert tuple(td[k].shape) == jd[k].shape, k
        _close(td[k].numpy(), np.asarray(jd[k]), rtol=1e-4, atol=1e-5, what=k)
    _close(td["min_loss"].numpy(), np.asarray(jd["min_loss"]), rtol=0, atol=1e-4, what="min_loss")
    assert (td["winner"].numpy() == np.asarray(jd["winner"])).mean() > 0.99
