"""Port parity: the corner-plane warp of baseboostdepth_tpu_torch against the
JAX package's Pallas kernel run in interpret mode (as
tests/test_warp_pallas.py runs it on the CPU).

On the CPU the port's `corner_sweep` runs its plain version
(`corner_sweep_reference`); the CUDA kernel is held to the same plain version
on the card by chip_smoke.py. Tolerances: corner planes are integers and
must be exactly equal; the blended image 1e-6 absolute (fp32 blend of values
in [0, 1], same formula); grid gradients 1e-5 absolute.

Some of this file's tests are in test_torch_port_warp_plain.py (the plain bilinear warp against
F.grid_sample and JAX's XLA path), so that each file has at most
seven tests: a file with more queues ahead of tests/test_zoo_training.py,
the suite's longest (ROADMAP.md, "The time budget").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.ops import warp_pallas as wp
from baseboostdepth_tpu_torch.ops import sampling as tsampling
from baseboostdepth_tpu_torch.ops import warp_cuda as tw
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


SHAPES = [(2, 24, 128), (1, 30, 100), (3, 9, 45)]


def _inputs(seed, shape):
    """uint8 frames and a grid that leaves the image and hits its borders
    exactly (-1 and 1 map to x = 0 / W-1 and y = 0 / H-1)."""
    rng = np.random.default_rng(seed)
    N, H, W = shape
    img = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    grid = ((rng.random((N, H, W, 2)) * 2 - 1) * 1.2).astype(np.float32)
    pick = rng.random((N, H, W, 2))
    grid[pick < 0.08] = -1.0
    grid[pick > 0.92] = 1.0
    grid[:, 0, 0] = (-1.0, -1.0)
    grid[:, -1, -1] = (1.0, 1.0)
    return img, grid


def _clamped_coords(grid, H, W):
    x = np.clip((grid[..., 0] + np.float32(1.0)) * np.float32(0.5) * np.float32(W - 1), 0, W - 1)
    y = np.clip((grid[..., 1] + np.float32(1.0)) * np.float32(0.5) * np.float32(H - 1), 0, H - 1)
    return x.astype(np.float32), y.astype(np.float32)


def _jax_corners(img, x, y):
    """JAX's _corner_sweep (interpret mode) with bilinear_sample_corner_u8's
    padding, cropped back."""
    N, H, W, _ = img.shape
    _, Ho, Wo = x.shape
    packed = wp._pad_to(wp.pack_rgb(jnp.asarray(img)), wp._round_up(H + 1, wp.TILE_H),
                        wp._round_up(W + 1, wp.TILE_W))
    Hop = wp._round_up(Ho, wp.BLOCK_H if Ho >= wp.BLOCK_H else wp.TILE_H)
    Wop = wp._round_up(Wo, wp.TILE_W)
    xp = wp._pad_to(jnp.asarray(x), Hop, Wop)
    yp = wp._pad_to(jnp.asarray(y), Hop, Wop)
    return np.asarray(wp._corner_sweep(packed, xp, yp, True))[:, :, :Ho, :Wo]


@pytest.mark.parametrize("shape", SHAPES)
def test_corner_planes_exactly_equal(shape):
    img, grid = _inputs(sum(shape), shape)
    N, H, W = shape
    x, y = _clamped_coords(grid, H, W)
    assert (x == 0).any() and (x == W - 1).any() and (y == 0).any() and (y == H - 1).any()
    ref = _jax_corners(img, x, y)
    out = tw.corner_sweep(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    assert out.dtype == torch.int32 and tuple(out.shape) == (N, 4, H, W)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tw.pack_rgb(torch.from_numpy(img)).numpy(), np.asarray(wp.pack_rgb(jnp.asarray(img)))
    )


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_blend_and_grid_gradient_match_jax(shape):
    img, grid = _inputs(100 + sum(shape), shape)
    ct = np.random.default_rng(7).random(shape + (3,)).astype(np.float32)

    def jf(g):
        return jnp.sum(wp.bilinear_sample_corner_u8(jnp.asarray(img), g, interpret=True) * ct)

    jout = np.asarray(wp.bilinear_sample_corner_u8(jnp.asarray(img), jnp.asarray(grid), interpret=True))
    jgrad = np.asarray(jax.grad(jf)(jnp.asarray(grid)))

    tg = torch.tensor(grid, requires_grad=True)
    tout = tw.bilinear_sample_corner_u8(torch.from_numpy(img), tg)
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout, atol=1e-6)
    np.testing.assert_allclose(tg.grad.numpy(), jgrad, atol=1e-5)
    # the exact-border points carry the clip's 0.5 gradient at x = 0, y = 0
    border = (grid[..., 0] == -1.0) & (np.abs(jgrad[..., 0]) > 1e-3)
    assert border.any()


def test_dispatch_and_argument_checks():
    img, grid = _inputs(11, (1, 8, 16))
    x, y = _clamped_coords(grid, 8, 16)
    before = tw.corner_sweep.launches
    tw.corner_sweep(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    assert tw.corner_sweep.launches == before  # the CPU runs the plain version
    with pytest.raises(TypeError):
        tw.corner_sweep(torch.from_numpy(img).float(), torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(TypeError):
        tw.corner_sweep(torch.from_numpy(img), torch.from_numpy(x).double(), torch.from_numpy(y))
    with pytest.raises(ValueError):
        tw.corner_sweep(torch.from_numpy(img), torch.from_numpy(x).mT.contiguous().mT,
                        torch.from_numpy(y))
    # the step's default warp: the corner-plane warp of uint8 frames; float
    # sources take the float-planes kernel pair
    from baseboostdepth_tpu_torch.ops.warp_planes import bilinear_sample_planes

    assert tsampling.resolve_warp(torch.from_numpy(img)) is tw.bilinear_sample_corner_u8
    assert tsampling.resolve_warp(torch.from_numpy(img).float()) is bilinear_sample_planes
    if not torch.cuda.is_available():
        # entry points default to the card and never fall back to the CPU
        from baseboostdepth_tpu_torch.training.step import StepStatic, make_train_step

        with pytest.raises(RuntimeError):
            make_train_step(StepStatic())
