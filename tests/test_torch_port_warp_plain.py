"""Port parity: the corner-plane warp against the plain bilinear warp and
F.grid_sample, and the plain bilinear warp against the JAX package's XLA
path. The setup and tolerances are test_torch_port_warp.py's, split from
it so that each file has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~10 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from baseboostdepth_tpu_torch.ops import sampling as tsampling
from baseboostdepth_tpu_torch.ops import warp_cuda as tw
from test_torch_port_warp import _inputs
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other port test files, at a lowered
    CPU priority (torch_port_helpers.lowered_priority)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def test_corner_warp_matches_plain_bilinear_and_grid_sample():
    img, grid = _inputs(3, (2, 16, 40))
    src = torch.from_numpy(img.astype(np.float32) / 255.0)
    g1 = torch.tensor(grid, requires_grad=True)
    g2 = torch.tensor(grid, requires_grad=True)
    a = tw.bilinear_sample_corner_u8(torch.from_numpy(img), g1)
    b = tsampling.bilinear_sample(src, g2)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    (a**2).sum().backward()
    (b**2).sum().backward()
    np.testing.assert_allclose(g1.grad.numpy(), g2.grad.numpy(), atol=1e-5)
    ref = F.grid_sample(src.permute(0, 3, 1, 2), torch.from_numpy(grid), mode="bilinear",
                        padding_mode="border", align_corners=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(a.detach().numpy(), ref.numpy(), atol=1e-5)


def test_plain_bilinear_matches_jax_xla_path():
    from baseboostdepth_tpu.ops.sampling import bilinear_sample as jbs

    rng = np.random.default_rng(9)
    img = rng.random((2, 3, 12, 20, 3)).astype(np.float32)
    _, grid = _inputs(10, (6, 12, 20))
    grid = grid.reshape(2, 3, 12, 20, 2)
    ct = rng.random((2, 3, 12, 20, 3)).astype(np.float32)

    jout, vjp = jax.vjp(jbs, jnp.asarray(img), jnp.asarray(grid))
    jgi, jgg = vjp(jnp.asarray(ct))
    ti = torch.tensor(img, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    tout = tsampling.bilinear_sample(ti, tg)
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jgg), atol=1e-5)
