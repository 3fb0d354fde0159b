"""Port parity: the float-planes warp of baseboostdepth_tpu_torch
(`ops/warp_planes.py::bilinear_sample_planes`) against the JAX package's
`bilinear_sample_pallas`, whose Pallas kernel pair (`_fwd_kernel`,
`_bwd_kernel`) runs in interpret mode, as tests/test_warp_pallas.py runs it
on the CPU.

On the CPU the port's kernel wrappers run their plain versions
(`warp_planes_fwd_reference`, `warp_planes_bwd_reference`); the CUDA kernels
are held to the same plain versions on the card by chip_smoke.py.
Tolerances, those of the packed warp (tests/test_torch_port_warp_packed.py):
values 3e-7 absolute, since JAX's CPU compiler contracts the blend's
multiply-adds into fused multiply-adds and the port (like its CUDA kernel,
built without contraction) rounds each product; grid gradients 1e-6 of
their largest entry (the same per-channel formula, summed over the channels
in another order of rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from baseboostdepth_tpu.ops import warp_pallas as wp
from baseboostdepth_tpu_torch.ops import sampling as tsampling
from baseboostdepth_tpu_torch.ops import warp_planes as tp

# (lead, H, W, C, reach[, (Ho, Wo)]): the shapes of tests/test_warp_pallas.py
# -- C = 3 and C = 2, the odd 30x100 shape (not a multiple of the TPU's
# tiles), a leading slot axis -- with grids up to 1.15 outside [-1, 1]; then
# the shapes of the CUDA kernels' other paths: C = 1 and C = 4, W = 1, H = 1
# (Ho = 1), a width that is not a multiple of 4, an output grid of another
# size than the image. The new cases take about 3 s each on one CPU worker.
SHAPES = [((2,), 40, 256, 3, 1.15), ((3,), 16, 128, 2, 1.05), ((1,), 30, 100, 3, 1.1),
          ((2, 3), 16, 128, 3, 1.05), ((2,), 12, 36, 1, 1.1), ((2,), 10, 24, 4, 1.1),
          ((2,), 9, 1, 3, 1.1), ((2,), 1, 37, 3, 1.1), ((1,), 14, 30, 3, 1.1),
          ((2,), 20, 33, 3, 1.1, (11, 50))]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape_id(s):
    out = f"to{s[5][0]}x{s[5][1]}" if len(s) > 5 else ""
    return "x".join(map(str, (*s[0], *s[1:4]))) + out


def _inputs(seed, lead, H, W, C, reach, out=None):
    """Float images, a grid (of the image's size, or `out` = (Ho, Wo)) that
    leaves the image and hits its borders exactly (-1 and 1 map to x = 0 /
    W-1 and y = 0 / H-1), a cotangent."""
    Ho, Wo = out or (H, W)
    rng = np.random.default_rng(seed)
    img = rng.random(lead + (H, W, C)).astype(np.float32)
    grid = ((rng.random(lead + (Ho, Wo, 2)) * 2 - 1) * reach).astype(np.float32)
    pick = rng.random(lead + (Ho, Wo, 2))
    grid[pick < 0.04] = -1.0
    grid[pick > 0.96] = 1.0
    ct = rng.random(lead + (Ho, Wo, C)).astype(np.float32)
    return img, grid, ct


def _port(img, grid, ct):
    ti = torch.tensor(img, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    out = tp.bilinear_sample_planes(ti, tg)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), tg.grad.numpy(), ti.grad


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_planes_warp_matches_pallas_kernels(shape):
    lead, H, W, C, reach = shape[:5]
    Ho, Wo = shape[5] if len(shape) > 5 else (H, W)
    img, grid, ct = _inputs(H + W + C, lead, H, W, C, reach, (Ho, Wo))

    def jf(g):
        return wp.bilinear_sample_pallas(jnp.asarray(img), g, interpret=True)

    jout, vjp = jax.vjp(jf, jnp.asarray(grid))
    (jgrad,) = vjp(jnp.asarray(ct))
    jout, jgrad = np.asarray(jout), np.asarray(jgrad)

    out, grad, img_grad = _port(img, grid, ct)
    assert out.shape == lead + (Ho, Wo, C) and out.dtype == np.float32
    np.testing.assert_allclose(out, jout, rtol=0, atol=3e-7)
    np.testing.assert_allclose(grad, jgrad, rtol=0, atol=1e-6 * np.abs(jgrad).max())
    if W > 1:  # exact-border points carry the clip's 0.5 gradient at x = 0
        border = (grid[..., 0] == -1.0) & (np.abs(jgrad[..., 0]) > 1e-3)
        assert border.any()
    else:  # x = 0 whatever the grid says: no gradient in x
        assert not grad[..., 0].any() and not jgrad[..., 0].any()
    # the image receives no gradient, as from the TPU kernel's VJP
    assert img_grad is None


def test_planes_warp_matches_plain_bilinear_and_grid_sample():
    """Values against the plain gather (`ops.sampling.bilinear_sample`) and
    F.grid_sample(border, align_corners=True); the grid gradient against
    the plain gather's autodiff."""
    img, grid, ct = _inputs(5, (2,), 12, 20, 3, 1.2)
    ti, g1, g2 = (torch.tensor(a, requires_grad=True) for a in (img, grid, grid))
    a = tp.bilinear_sample_planes(ti, g1)
    b = tsampling.bilinear_sample(ti, g2)
    np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    (a * torch.from_numpy(ct)).sum().backward()
    (b * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(g1.grad.numpy(), g2.grad.numpy(), rtol=0,
                               atol=1e-6 * np.abs(g2.grad.numpy()).max())
    ref = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
                        mode="bilinear", padding_mode="border", align_corners=True)
    np.testing.assert_allclose(a.detach().numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5)


def test_planes_kernel_wrappers_against_each_other():
    """The backward wrapper is the forward's vector-Jacobian product in the
    coordinates: checked against autodiff of a float64 blend of the same
    corners, for C = 2."""
    img, grid, ct = _inputs(4, (2,), 7, 11, 2, 1.2)
    src = torch.from_numpy(img)
    x = torch.from_numpy(np.clip((grid[..., 0] + 1) * 0.5 * 10, 0, 10).astype(np.float32))
    y = torch.from_numpy(np.clip((grid[..., 1] + 1) * 0.5 * 6, 0, 6).astype(np.float32))
    gpx, gpy = tp.warp_planes_bwd(src, x, y, torch.from_numpy(ct))

    v00, v01, v10, v11, _, _ = tp._corners(src.double(), x, y)
    xd = x.double().requires_grad_(True)
    yd = y.double().requires_grad_(True)
    wx = (xd - torch.floor(xd))[..., None]
    wy = (yd - torch.floor(yd))[..., None]
    out = (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy
    (out * torch.from_numpy(ct).double()).sum().backward()
    np.testing.assert_allclose(gpx.numpy(), xd.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gpy.numpy(), yd.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.warp_planes_fwd(src, x, y).numpy(), out.detach().numpy(),
                               rtol=0, atol=1e-6)


def test_other_float_dtypes_compute_in_float32():
    """bf16 and float64 images are warped in float32 and cast back, as the
    JAX function casts the planes to float32 and the result to img.dtype."""
    img, grid, _ = _inputs(6, (1,), 8, 16, 3, 1.1)
    ref = tp.bilinear_sample_planes(torch.from_numpy(img), torch.from_numpy(grid))
    for dt in (torch.bfloat16, torch.float64):
        src = torch.from_numpy(img).to(dt)
        out = tp.bilinear_sample_planes(src, torch.from_numpy(grid))
        assert out.dtype == dt
        expect = tp.bilinear_sample_planes(src.float(), torch.from_numpy(grid)).to(dt)
        torch.testing.assert_close(out, expect, rtol=0, atol=0)
    assert ref.dtype == torch.float32


def test_dispatch_and_argument_checks():
    img, grid, ct = _inputs(11, (1,), 8, 16, 3, 1.1)
    src = torch.from_numpy(img)
    x = torch.from_numpy(np.clip((grid[..., 0] + 1) * 7.5, 0, 15).astype(np.float32))
    y = torch.from_numpy(np.clip((grid[..., 1] + 1) * 3.5, 0, 7).astype(np.float32))
    g = torch.from_numpy(ct)

    # float sources take the planes warp under every warp_impl of the step
    for impl in ("auto", "corner", "pallas"):
        assert tsampling.resolve_warp(src, impl) is tp.bilinear_sample_planes
        assert tsampling.resolve_warp(src.half(), impl) is tp.bilinear_sample_planes
    with pytest.raises(ValueError):  # the plain float gather is no warp of the step
        tsampling.resolve_warp(src, "xla")
    with pytest.raises(TypeError):  # integer sources other than uint8
        tsampling.resolve_warp(src.to(torch.int32), "auto")

    # both launch counters stay 0 on the CPU: the plain versions run
    before = (tp.warp_planes_fwd.launches, tp.warp_planes_bwd.launches)
    tp.warp_planes_fwd(src, x, y)
    tp.warp_planes_bwd(src, x, y, g)
    _port(img, grid, ct)
    assert (tp.warp_planes_fwd.launches, tp.warp_planes_bwd.launches) == before

    with pytest.raises(TypeError):  # the kernels read float32 images
        tp.warp_planes_fwd(src.double(), x, y)
    with pytest.raises(TypeError):
        tp.bilinear_sample_planes(torch.from_numpy((img * 255).astype(np.uint8)),
                                  torch.from_numpy(grid))
    with pytest.raises(TypeError):  # coordinates must be float32 [N, Ho, Wo]
        tp.warp_planes_fwd(src, x.double(), y)
    with pytest.raises(ValueError):
        tp.warp_planes_fwd(src, x, y[:, :4])
    with pytest.raises(TypeError):  # the cotangent must be [N, Ho, Wo, C]
        tp.warp_planes_bwd(src, x, y, g[..., :2])
    with pytest.raises(ValueError):  # no kernel launches on a view
        tp.warp_planes_fwd(src, x.mT.contiguous().mT, y)
    with pytest.raises(ValueError):
        tp.warp_planes_bwd(src, x, y, g.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):  # the grid's leading axes must match the image's
        tp.bilinear_sample_planes(src, torch.from_numpy(grid)[None])
