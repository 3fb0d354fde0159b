"""Port parity: the packed warp of baseboostdepth_tpu_torch
(`ops/warp_cuda.py::bilinear_sample_packed_u8`) against the JAX package's
`bilinear_sample_pallas_u8`, whose Pallas kernel pair runs in interpret mode
(as tests/test_warp_pallas.py runs it on the CPU), and against the port's
own corner-plane warp.

On the CPU the port's kernel wrappers run their plain versions
(`warp_packed_fwd_reference`, `warp_packed_bwd_reference`); the CUDA kernels
are held to the same plain versions on the card by chip_smoke.py.
Tolerances: values 3e-7 absolute. The gather is exact and the blend is the
same float32 expression in the same order, but JAX's CPU compiler contracts
its multiply-adds into fused multiply-adds and the port (like its CUDA
kernel, built without contraction) rounds each product: measured up to
1.8e-7, 1.5 units in the last place of 1.0. The grid gradient 1e-6 of its
largest entry (the same per-channel formula; measured up to 1.8e-7).
Against the port's corner-plane warp the values are exactly equal (same
gather, same blend) and the grid gradient agrees to 1e-6 of its largest
entry (measured up to 2.0e-7): autodiff of the blend rounds (1 - wy) g as
g - wy g.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.ops import warp_pallas as wp
from baseboostdepth_tpu_torch.ops import cuda_build
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


# (lead, H, W): not multiples of the TPU's (8, 128) tiles; one with a
# leading slot axis
SHAPES = [((2,), 20, 200), ((2, 3), 9, 45)]


def _inputs(seed, lead, H, W):
    """uint8 frames and a grid that leaves the image and hits its borders
    exactly (-1 and 1 map to x = 0 / W-1 and y = 0 / H-1)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, lead + (H, W, 3), dtype=np.uint8)
    grid = ((rng.random(lead + (H, W, 2)) * 2 - 1) * 1.2).astype(np.float32)
    pick = rng.random(lead + (H, W, 2))
    grid[pick < 0.08] = -1.0
    grid[pick > 0.92] = 1.0
    grid[..., 0, 0, :] = -1.0
    grid[..., -1, -1, :] = 1.0
    ct = rng.random(lead + (H, W, 3)).astype(np.float32)
    return img, grid, ct


def _port(fn, img, grid, ct):
    tg = torch.tensor(grid, requires_grad=True)
    out = fn(torch.from_numpy(img), tg)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), tg.grad.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, (*s[0], s[1], s[2]))))
def test_packed_warp_matches_pallas_kernels(shape):
    lead, H, W = shape
    img, grid, ct = _inputs(H + W, lead, H, W)

    def jf(g):
        return wp.bilinear_sample_pallas_u8(jnp.asarray(img), g, interpret=True)

    jout, vjp = jax.vjp(jf, jnp.asarray(grid))
    (jgrad,) = vjp(jnp.asarray(ct))
    jout, jgrad = np.asarray(jout), np.asarray(jgrad)

    out, grad = _port(tw.bilinear_sample_packed_u8, img, grid, ct)
    assert out.shape == lead + (H, W, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, jout, rtol=0, atol=3e-7)
    np.testing.assert_allclose(grad, jgrad, rtol=0, atol=1e-6 * np.abs(jgrad).max())
    # exact-border points carry the clip's 0.5 gradient at x = 0
    border = (grid[..., 0] == -1.0) & (np.abs(jgrad[..., 0]) > 1e-3)
    assert border.any()

    # the packed warp against the port's corner-plane warp
    cout, cgrad = _port(tw.bilinear_sample_corner_u8, img, grid, ct)
    np.testing.assert_array_equal(out, cout)
    np.testing.assert_allclose(grad, cgrad, rtol=0, atol=1e-6 * np.abs(cgrad).max())


def test_packed_kernel_wrappers_against_each_other():
    """The backward wrapper is the forward's vector-Jacobian product in the
    coordinates: checked against autodiff of the forward's plain version,
    a float64 blend of the same corners."""
    img, grid, ct = _inputs(4, (2,), 7, 11)
    frames = torch.from_numpy(img)
    x = torch.from_numpy(np.clip((grid[..., 0] + 1) * 0.5 * 10, 0, 10).astype(np.float32))
    y = torch.from_numpy(np.clip((grid[..., 1] + 1) * 0.5 * 6, 0, 6).astype(np.float32))
    gpx, gpy = tw.warp_packed_bwd(frames, x, y, torch.from_numpy(ct))

    corners = tw.corner_sweep(frames, x, y)
    xd = x.double().requires_grad_(True)
    yd = y.double().requires_grad_(True)
    vals = [((corners >> (8 * c)) & 0xFF).double() / 255.0 for c in range(3)]
    wx, wy = xd - torch.floor(xd), yd - torch.floor(yd)
    out = torch.stack([(v[:, 0] * (1 - wx) + v[:, 1] * wx) * (1 - wy)
                       + (v[:, 2] * (1 - wx) + v[:, 3] * wx) * wy for v in vals], dim=-1)
    (out * torch.from_numpy(ct).double()).sum().backward()
    np.testing.assert_allclose(gpx.numpy(), xd.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gpy.numpy(), yd.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.warp_packed_fwd(frames, x, y).numpy(), out.detach().numpy(),
                               rtol=0, atol=1e-6)


def test_dispatch_and_argument_checks():
    img, grid, ct = _inputs(11, (1,), 8, 16)
    frames = torch.from_numpy(img)
    x = torch.from_numpy(np.clip((grid[..., 0] + 1) * 7.5, 0, 15).astype(np.float32))
    y = torch.from_numpy(np.clip((grid[..., 1] + 1) * 3.5, 0, 7).astype(np.float32))
    g = torch.from_numpy(ct)

    # the step's warps: "auto" / "corner" -> corner planes, "pallas" -> packed
    assert tsampling.resolve_warp(frames, "auto") is tw.bilinear_sample_corner_u8
    assert tsampling.resolve_warp(frames, "corner") is tw.bilinear_sample_corner_u8
    assert tsampling.resolve_warp(frames, "pallas") is tw.bilinear_sample_packed_u8
    with pytest.raises(ValueError):  # the plain float gather is no warp of the step
        tsampling.resolve_warp(frames, "xla")
    # float sources: the float-planes pair
    from baseboostdepth_tpu_torch.ops.warp_planes import bilinear_sample_planes

    assert tsampling.resolve_warp(frames.float(), "pallas") is bilinear_sample_planes

    # both launch counters stay 0 on the CPU: the plain versions run
    before = (tw.warp_packed_fwd.launches, tw.warp_packed_bwd.launches)
    tw.warp_packed_fwd(frames, x, y)
    tw.warp_packed_bwd(frames, x, y, g)
    _port(tw.bilinear_sample_packed_u8, img, grid, ct)
    assert (tw.warp_packed_fwd.launches, tw.warp_packed_bwd.launches) == before

    with pytest.raises(TypeError):  # frames must be uint8
        tw.warp_packed_fwd(frames.float(), x, y)
    with pytest.raises(TypeError):
        tw.bilinear_sample_packed_u8(frames.float(), torch.from_numpy(grid))
    with pytest.raises(TypeError):  # coordinates must be float32 [N, Ho, Wo]
        tw.warp_packed_fwd(frames, x.double(), y)
    with pytest.raises(ValueError):
        tw.warp_packed_fwd(frames, x, y[:, :4])
    with pytest.raises(TypeError):  # the cotangent must be [N, Ho, Wo, 3]
        tw.warp_packed_bwd(frames, x, y, g[..., :2])
    with pytest.raises(ValueError):  # no kernel launches on a view
        tw.warp_packed_fwd(frames, x.mT.contiguous().mT, y)
    with pytest.raises(ValueError):
        tw.warp_packed_bwd(frames, x, y, g.transpose(1, 2).contiguous().transpose(1, 2))


def test_library_name_follows_sources_and_headers(tmp_path, monkeypatch):
    """A library is rebuilt when one of its sources or any shared header
    under csrc/ changes: its file name hashes them all."""
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    for name in ("a.cu", "b.cu", *cuda_build.COMMON_SOURCES):
        (tmp_path / name).write_text(f"// {name}\n")
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = cuda_build._lib_path("warp", ("a.cu",))
    assert first == cuda_build._lib_path("warp", ("a.cu",))
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("libwarp_")
    (tmp_path / "b.cu").write_text("// another library's source\n")
    assert cuda_build._lib_path("warp", ("a.cu",)) == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = cuda_build._lib_path("warp", ("a.cu",))
    assert second != first
    (tmp_path / "a.cu").write_text("// edited\n")
    assert cuda_build._lib_path("warp", ("a.cu",)) not in (first, second)
