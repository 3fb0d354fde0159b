"""Port parity: photometric loss, loss assembly, augmentation and resizing of
baseboostdepth_tpu_torch against baseboostdepth_tpu, fp32 on the CPU.

Tolerances (absolute): losses and their gradients 1e-5 (float32 window sums
in another order, through a rational SSIM expression); color jitter and flip
1e-6 (elementwise, same formulas); resizes 1e-5 (weights built in another
precision, contracted in another order).

Some of this file's tests are in test_torch_port_resize.py (the bilinear resize, the LANCZOS pyramid), so that each file has at most
seven tests: a file with more queues ahead of tests/test_zoo_training.py,
the suite's longest (ROADMAP.md, "The time budget").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu import losses as jl
from baseboostdepth_tpu.data import augment as ja
from baseboostdepth_tpu.ops.ssim import reprojection_loss as j_reprojection_loss
from baseboostdepth_tpu.ops.ssim import ssim as j_ssim
from baseboostdepth_tpu_torch import losses as tl
from baseboostdepth_tpu_torch.data import augment as ta
from baseboostdepth_tpu_torch.ops import ssim as ts
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _imgs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + rng.standard_normal(shape).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("use_ssim", [True, False])
def test_reprojection_loss_values_and_grads_in_both_args(use_ssim):
    x, y = _imgs(0, (2, 12, 20, 3))
    x[0, :3, :3] = y[0, :3, :3]  # a patch where pred == target exactly
    ct = np.random.default_rng(1).random((2, 12, 20, 1)).astype(np.float32)

    def jf(a, b):
        return jnp.sum(j_reprojection_loss(a, b, use_ssim=use_ssim) * ct)

    jout = j_reprojection_loss(jnp.asarray(x), jnp.asarray(y), use_ssim=use_ssim)
    jgx, jgy = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    tout = ts.reprojection_loss(tx, ty, use_ssim=use_ssim)
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jgy), atol=ATOL)


def test_ssim_values():
    x, y = _imgs(2, (3, 9, 14, 3))
    np.testing.assert_allclose(
        ts.ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(j_ssim(jnp.asarray(x), jnp.asarray(y))), atol=ATOL,
    )


def test_slot_and_min_reprojection_losses_with_grads():
    rng = np.random.default_rng(3)
    B, S, H, W = 2, 4, 10, 16
    target, _ = _imgs(4, (B, H, W, 3))
    images = rng.random((B, S, H, W, 3)).astype(np.float32)
    err_images = rng.random((B, S - 1, H, W, 3)).astype(np.float32)
    sources = rng.random((B, S, H, W, 3)).astype(np.float32)
    valid = np.array([[1, 0, 1, 1], [1, 1, 0, 1]], bool)
    noise = (rng.standard_normal((B, 1, H, W)) * 1e-5).astype(np.float32)

    def jf(imgs, errs):
        wl = jl.slot_losses(jnp.asarray(target), imgs, jnp.asarray(valid))
        il = jl.slot_losses(jnp.asarray(target), jnp.asarray(sources), jnp.asarray(valid))
        el = jl.slot_losses(jnp.asarray(target), errs, jnp.asarray(valid[:, :-1]))
        return jnp.mean(jl.min_reprojection(wl, il, jnp.asarray(noise), el)), wl

    (jloss, jwl), (jgi, jge) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(images), jnp.asarray(err_images)
    )

    ti = torch.tensor(images, requires_grad=True)
    te = torch.tensor(err_images, requires_grad=True)
    tt = torch.from_numpy(target)
    tv = torch.from_numpy(valid)
    twl = tl.slot_losses(tt, ti, tv)
    til = tl.slot_losses(tt, torch.from_numpy(sources), tv)
    tel = tl.slot_losses(tt, te, tv[:, :-1])
    tloss = torch.mean(tl.min_reprojection(twl, til, torch.from_numpy(noise), tel))
    tloss.backward()
    np.testing.assert_allclose(twl.detach().numpy(), np.asarray(jwl), atol=ATOL)
    assert (twl.detach().numpy()[~valid] == tl._MASKED).all() and tl._MASKED == jl._MASKED
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=ATOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), atol=ATOL)


def test_min_reprojection_splits_ties_like_jax():
    w = np.array([[[[0.2]]], [[[0.5]]]], np.float32).reshape(1, 2, 1, 1)
    e = np.array([0.2], np.float32).reshape(1, 1, 1, 1)
    ident = np.full((1, 2, 1, 1), 0.9, np.float32)
    noise = np.zeros((1, 1, 1, 1), np.float32)
    jg = jax.grad(lambda a, b: jnp.sum(jl.min_reprojection(a, jnp.asarray(ident), jnp.asarray(noise), b)),
                  argnums=(0, 1))(jnp.asarray(w), jnp.asarray(e))
    tw_ = torch.tensor(w, requires_grad=True)
    te = torch.tensor(e, requires_grad=True)
    tl.min_reprojection(tw_, torch.from_numpy(ident), torch.from_numpy(noise), te).sum().backward()
    np.testing.assert_allclose(tw_.grad.numpy(), np.asarray(jg[0]), atol=1e-7)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg[1]), atol=1e-7)


def test_smooth_loss_and_normalized_disp():
    rng = np.random.default_rng(5)
    disp = (rng.random((2, 12, 20, 1)) + 0.1).astype(np.float32)
    disp[0, 2:5, 2:5] = 0.7  # equal neighbours: the abs gradient at exactly 0
    img = rng.random((2, 12, 20, 3)).astype(np.float32)

    def jf(d):
        return jl.smooth_loss(jl.normalized_disp(d), jnp.asarray(img))

    jv, jgd = jax.value_and_grad(jf)(jnp.asarray(disp))
    td = torch.tensor(disp, requires_grad=True)
    tv = tl.smooth_loss(tl.normalized_disp(td), torch.from_numpy(img))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), atol=ATOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgd), atol=ATOL)


def test_color_jitter_and_flip():
    rng = np.random.default_rng(6)
    B, NF, H, W = 3, 4, 10, 14
    img = rng.random((B, NF, H, W, 3)).astype(np.float32)
    img[0, 0, 0, 0] = (0.5, 0.5, 0.5)  # gray pixel: zero saturation / hue path
    params = ta.sample_jitter_params(np.random.default_rng(7), B, NF)
    params[0] = ja.sample_jitter_params(np.random.default_rng(8), 1, NF)[0]
    params[1, :, :3] = 1.0
    params[1, :, 3] = 0.0
    out_j = np.asarray(ja.color_jitter(jnp.asarray(img), jnp.asarray(params)))
    out_t = ta.color_jitter(torch.from_numpy(img), torch.from_numpy(params)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)

    hsv = np.array(ja.rgb_to_hsv(jnp.asarray(img)))
    np.testing.assert_allclose(ta.rgb_to_hsv(torch.from_numpy(img)).numpy(), hsv, atol=1e-6)
    np.testing.assert_allclose(ta.hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
                               np.asarray(ja.hsv_to_rgb(jnp.asarray(hsv))), atol=1e-6)

    frames = rng.integers(0, 256, (B, NF, H, W, 3), dtype=np.uint8)
    flip = np.array([True, False, True])
    np.testing.assert_array_equal(
        ta.apply_flip(torch.from_numpy(frames), torch.from_numpy(flip)).numpy(),
        np.asarray(ja.apply_flip(jnp.asarray(frames), jnp.asarray(flip))),
    )
    # same host-side draw from the same numpy generator
    np.testing.assert_array_equal(ta.sample_jitter_params(np.random.default_rng(1), 5, 3),
                                  ja.sample_jitter_params(np.random.default_rng(1), 5, 3))
