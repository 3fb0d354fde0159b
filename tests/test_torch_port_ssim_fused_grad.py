"""Port parity: the fused SSIM + L1 loss (ops/ssim_cuda.py) against the JAX
package's Pallas kernels on the last of EDGE_SHAPES, its gradient against
autodiff of the plain ops/ssim.py away from ties, and slot_losses' photo
options. The setup and the tolerances are test_torch_port_ssim_fused.py's,
split from it so that each file has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~10 s.
"""

import numpy as np
import pytest
import torch

from baseboostdepth_tpu_torch import losses as tl
from baseboostdepth_tpu_torch.ops import ssim as ts
from baseboostdepth_tpu_torch.ops import ssim_cuda as tsc
from test_torch_port_ssim_fused import (
    EDGE_IDS,
    EDGE_SHAPES,
    KINDS,
    SHAPES,
    _inputs,
    _port_fused,
    check_edge_shape,
)
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", EDGE_SHAPES[2:], ids=EDGE_IDS[2:])
def test_fused_matches_pallas_kernels_edge_shapes(shape, kind):
    check_edge_shape(shape, kind)

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
