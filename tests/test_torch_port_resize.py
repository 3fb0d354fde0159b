"""Port parity: the bilinear resize and the four-level LANCZOS pyramid of
the port against the JAX package on the CPU. The setup and tolerances are
test_torch_port_losses.py's, split from it so that each file has at most
seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~10 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.ops import resize as jr
from baseboostdepth_tpu_torch.ops import resize as tr
from test_torch_port_losses import ATOL
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


@pytest.mark.parametrize("size", [(24, 80), (96, 320), (30, 50)])
def test_resize_bilinear(size):
    x = np.random.default_rng(9).random((2, 48, 160, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tr.resize_bilinear(torch.from_numpy(x), *size).numpy(),
        np.asarray(jr.resize_bilinear(jnp.asarray(x), *size)), atol=ATOL,
    )
    np.testing.assert_array_equal(
        tr.upsample2x_nearest(torch.from_numpy(x)).numpy(),
        np.asarray(jr.upsample2x_nearest(jnp.asarray(x))),
    )


@pytest.mark.parametrize("shape", [(2, 64, 128, 3), (1, 50, 90, 3)])
def test_lanczos_pyramid_four_levels(shape):
    x = np.random.default_rng(10).random(shape).astype(np.float32)
    jp = jr.lanczos_pyramid(jnp.asarray(x), num_scales=4)
    tp = tr.lanczos_pyramid(torch.from_numpy(x), num_scales=4)
    assert len(tp) == 4
    for a, b in zip(jp, tp):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
