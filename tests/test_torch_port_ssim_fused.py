"""Port parity: the fused SSIM + L1 reprojection loss of
baseboostdepth_tpu_torch (`ops/ssim_cuda.py`) against the JAX package's
Pallas kernels run in interpret mode (as tests/test_ssim_pallas.py runs
them on the CPU).

On the CPU the port's kernel wrappers run their plain versions
(`ssim_fused_fwd_reference`, `ssim_fused_bwd_reference`); the CUDA kernels
are held to the same plain versions on the card by chip_smoke.py.
Tolerances: the loss map 1e-6 absolute (the same float32 expressions in the
same order; values in [0, 1]); the gradient into pred 1e-5 of its largest
entry (the box adjoint's sums taken in another order), on the whole and on
the edge rows and columns 0, 1, H-2, H-1, where the reflect fold acts.
EDGE_SHAPES are the small images on which the CUDA kernels' ragged paths
run (the minimum 2x2 image, strips and tiles cut short by H and W, rows
whose start is not 16-byte aligned): there the plain versions, which the
card holds the kernels to, are anchored to the interpret-mode Pallas
kernels too, without ties (the tied block would cover these images). Their
loss map is held to 2e-6, the file's bound against `ops/ssim.py`: pred
clipped to [0, 1] makes windows nearly flat, where SSIM's cancellation
(E[x^2] - mu^2) magnifies the one-ulp differences of JAX's contracted (FMA)
moments; measured 1.07e-6 at 2 of 630 pixels of the 9x70 correlated case.
Inputs where pred == target over whole windows hit the Pallas kernel's
subgradients (0 at a clip bound, sign(0) = 0), which the port keeps; away
from such ties the fused gradient equals autodiff of the port's plain
`ops/ssim.py` to 1e-4 of its largest entry, the JAX test's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.ops.ssim_pallas import reprojection_loss_fused as j_fused
from baseboostdepth_tpu_torch import losses as tl
from baseboostdepth_tpu_torch.ops import ssim as ts
from baseboostdepth_tpu_torch.ops import ssim_cuda as tsc

SHAPES = [(2, 24, 40), (3, 17, 29)]
N_MANY = 65537  # more images than a CUDA grid's z axis holds (65,535)
EDGE_SHAPES = [(1, 2, 2), (1, 3, 5), (1, 9, 70)]
KINDS = ["correlated", "uncorrelated", "anticorrelated"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, shape, kind, tie=True):
    """pred, target float32 [N, H, W, 3]; with `tie`, pred == target exactly
    on a block that holds whole 3x3 windows and touches the top-left
    corner, so the reflect fold meets the tie too."""
    rng = np.random.default_rng(seed)
    tgt = rng.random(shape + (3,), dtype=np.float32)
    if kind == "correlated":
        pred = np.clip(tgt + 0.1 * rng.standard_normal(tgt.shape), 0, 1).astype(np.float32)
    elif kind == "uncorrelated":
        pred = rng.random(tgt.shape, dtype=np.float32)
    else:  # drives SSIM towards -1, q towards its upper clip bound
        pred = (1.0 - tgt).astype(np.float32)
    if tie:
        pred[:, :6, :9] = tgt[:, :6, :9]
        pred[-1, 8:14, 12:20] = tgt[-1, 8:14, 12:20]
    return pred, tgt


def _jax_fused(pred, tgt, cot):
    out, vjp = jax.vjp(lambda p: j_fused(p, jnp.asarray(tgt), True), jnp.asarray(pred))
    (g,) = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(g)


def _port_fused(pred, tgt, cot):
    tp = torch.tensor(pred, requires_grad=True)
    tt = torch.tensor(tgt, requires_grad=True)
    out = tsc.reprojection_loss_fused(tp, tt)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), tp.grad.numpy(), tt.grad


def _assert_matches_pallas(pred, tgt, cot, out_atol=1e-6):
    """The port's loss map and gradient against the interpret-mode Pallas
    kernels', at the file's tolerances; returns the gradient and its bound."""
    shape = pred.shape[:3]
    jout, jg = _jax_fused(pred, tgt, cot)
    out, g, tgrad = _port_fused(pred, tgt, cot)

    assert out.shape == shape + (1,) and out.dtype == np.float32
    np.testing.assert_allclose(out, jout, rtol=0, atol=out_atol)
    assert tgrad is None  # the gradient flows into pred only
    atol = 1e-5 * np.abs(jg).max()
    np.testing.assert_allclose(g, jg, rtol=0, atol=atol)
    H, W = shape[1:]
    for edge in (0, 1, H - 2, H - 1):
        np.testing.assert_allclose(g[:, edge], jg[:, edge], rtol=0, atol=atol, err_msg=f"row {edge}")
    for edge in (0, 1, W - 2, W - 1):
        np.testing.assert_allclose(g[:, :, edge], jg[:, :, edge], rtol=0, atol=atol,
                                   err_msg=f"column {edge}")
    return g, atol


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_matches_pallas_kernels(shape, kind):
    pred, tgt = _inputs(sum(shape) + KINDS.index(kind), shape, kind)
    cot = np.random.default_rng(5).random(shape + (1,), dtype=np.float32)
    g, atol = _assert_matches_pallas(pred, tgt, cot)
    # the tied block: the Pallas subgradients (no SSIM or L1 term inside it)
    inner = g[:, 1:4, 1:7]
    assert np.abs(inner).max() <= atol, np.abs(inner).max()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_fused_matches_pallas_kernels_edge_shapes(shape, kind):
    pred, tgt = _inputs(sum(shape) + KINDS.index(kind), shape, kind, tie=False)
    cot = np.random.default_rng(7).random(shape + (1,), dtype=np.float32)
    g, _ = _assert_matches_pallas(pred, tgt, cot, out_atol=2e-6)
    assert np.abs(g).max() > 0


def test_fused_takes_more_images_than_a_grid_axis_holds():
    """N = 65,537 images of 2x2, more than a CUDA grid's z axis holds: the
    wrapper takes them (it once refused N > 65,535 on any device), and its
    loss map and gradient agree with the interpret-mode Pallas kernels on
    every 128th image and on the images around 65,535, at the file's
    tolerances (1e-6; 1e-5 of the largest gradient entry). The JAX function
    computes each image alone, so those images' inputs give those images'
    outputs. On the CPU this runs the plain version, which has no chunks:
    the CUDA launchers' two launches (65,535 images, then 2) are held to
    it on the card by chip_smoke.py::image_count_checks.
    Each image is a checkerboard (corners (0,0) and (1,1) in [0.7, 1], the
    others in [0, 0.3]), so every reflect-folded window has spread: on
    near-flat 2x2 images SSIM's cancellation (E[x^2] - mu^2) decides the
    last digits, and there the port and JAX differed by up to 7.2e-6 in
    the loss map while each was as far from a float64 computation of the
    same formula (6.3e-6 and 7.1e-6): float32 rounding on both sides, not
    a fault of either. About 3 s on one CPU worker."""
    shape = (N_MANY, 2, 2)
    rng = np.random.default_rng(17)
    tgt = rng.random(shape + (3,), dtype=np.float32) * np.float32(0.3)
    tgt[:, 0, 0] += np.float32(0.7)
    tgt[:, 1, 1] += np.float32(0.7)
    pred = np.clip(tgt + 0.1 * rng.standard_normal(tgt.shape), 0, 1).astype(np.float32)
    cot = np.random.default_rng(8).random(shape + (1,), dtype=np.float32)
    out, g, _ = _port_fused(pred, tgt, cot)
    assert out.shape == shape + (1,) and g.shape == shape + (3,)

    picked = np.r_[np.arange(0, N_MANY, 128), np.arange(65530, N_MANY)]
    jout, jg = _jax_fused(pred[picked], tgt[picked], cot[picked])
    np.testing.assert_allclose(out[picked], jout, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g[picked], jg, rtol=0, atol=1e-5 * np.abs(jg).max())
    assert np.abs(jg).max() > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_gradient_matches_autodiff_away_from_ties(shape):
    pred, tgt = _inputs(40 + sum(shape), shape, "correlated", tie=False)
    cot = np.random.default_rng(6).random(shape + (1,), dtype=np.float32)
    out, g, _ = _port_fused(pred, tgt, cot)

    tp = torch.tensor(pred, requires_grad=True)
    ref = ts.reprojection_loss(tp, torch.from_numpy(tgt))
    (ref * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out, ref.detach().numpy(), rtol=0, atol=2e-6)
    err = np.abs(g - tp.grad.numpy()).max() / np.abs(tp.grad.numpy()).max()
    assert err < 1e-4, err


def test_dispatch_and_argument_checks():
    pred, tgt = _inputs(1, (2, 8, 12), "correlated")
    p, t = torch.from_numpy(pred), torch.from_numpy(tgt)
    before = (tsc.ssim_fused_fwd.launches, tsc.ssim_fused_bwd.launches)
    fused = ts.reprojection_loss(p, t, impl="fused")
    np.testing.assert_array_equal(fused.numpy(), tsc.reprojection_loss_fused(p, t).numpy())
    # "auto" takes the kernels on CUDA tensors only; without SSIM every impl is L1
    np.testing.assert_array_equal(ts.reprojection_loss(p, t, impl="auto").numpy(),
                                  ts.reprojection_loss(p, t).numpy())
    np.testing.assert_array_equal(ts.reprojection_loss(p, t, use_ssim=False, impl="fused").numpy(),
                                  ts.reprojection_loss(p, t, use_ssim=False).numpy())
    tsc.ssim_fused_bwd(p, t, torch.ones(2, 8, 12, 1))
    assert (tsc.ssim_fused_fwd.launches, tsc.ssim_fused_bwd.launches) == before  # plain on CPU

    with pytest.raises(ValueError):
        ts.reprojection_loss(p, t, impl="pallas")
    with pytest.raises(TypeError):  # the kernels take three channels
        ts.reprojection_loss(p[..., :2], t[..., :2], impl="fused")
    with pytest.raises(TypeError):
        tsc.ssim_fused_fwd(p.double(), t)
    with pytest.raises(TypeError):
        tsc.ssim_fused_fwd(p, t[:, :4])
    with pytest.raises(TypeError):
        tsc.ssim_fused_bwd(p, t, torch.ones(2, 8, 12))
    with pytest.raises(ValueError):
        tsc.ssim_fused_fwd(p.transpose(1, 2).contiguous().transpose(1, 2), t)
    with pytest.raises(ValueError):
        tsc.ssim_fused_fwd(p[:, :1].contiguous(), t[:, :1].contiguous())


def test_slot_losses_photo_options():
    """slot_losses' impl and photo_fn reach the fused loss; the expanded
    target and the slot slices arrive contiguous."""
    rng = np.random.default_rng(3)
    B, S, H, W = 2, 3, 10, 14
    images = torch.from_numpy(rng.random((B, S + 1, H, W, 3), dtype=np.float32))[:, :S]
    target = torch.from_numpy(rng.random((B, H, W, 3), dtype=np.float32))
    valid = torch.tensor([[True, False, True], [True, True, True]])
    fused = tl.slot_losses(target, images, valid, impl="fused")
    via_fn = tl.slot_losses(target, images, valid, photo_fn=tsc.reprojection_loss_fused)
    plain = tl.slot_losses(target, images, valid)
    np.testing.assert_array_equal(fused.numpy(), via_fn.numpy())
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=0, atol=2e-6)
    assert float(fused[0, 1].min()) == tl._MASKED
