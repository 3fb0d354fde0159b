"""Port parity: the fused SSIM + L1 loss (ops/ssim_cuda.py) against the JAX
package's Pallas kernels in interpret mode on the small images where the
CUDA kernels' ragged paths run (the first two of EDGE_SHAPES; the third is
in test_torch_port_ssim_fused_grad.py), and on more images than a CUDA
grid's z axis holds. The setup and the tolerances are
test_torch_port_ssim_fused.py's, split from it so that each file has at
most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~10 s.
"""

import numpy as np
import pytest
import torch

from test_torch_port_ssim_fused import (
    EDGE_IDS,
    EDGE_SHAPES,
    KINDS,
    N_MANY,
    _jax_fused,
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
@pytest.mark.parametrize("shape", EDGE_SHAPES[:2], ids=EDGE_IDS[:2])
def test_fused_matches_pallas_kernels_edge_shapes(shape, kind):
    check_edge_shape(shape, kind)

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
