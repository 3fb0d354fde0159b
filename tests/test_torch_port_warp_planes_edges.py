"""Port parity: the float-planes warp (ops/warp_planes.py) against the JAX
package's interpret-mode Pallas kernels at the last five of SHAPES (C = 4,
W = 1, H = 1, a width that is not a multiple of 4, an output grid of
another size), float dtypes other than float32, and the wrappers' dispatch
and argument checks. The setup and tolerances are
test_torch_port_warp_planes.py's, split from it so that each file has at
most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~25 s.
"""

import numpy as np
import pytest
import torch

from baseboostdepth_tpu_torch.ops import sampling as tsampling
from baseboostdepth_tpu_torch.ops import warp_planes as tp
from test_torch_port_warp_planes import SHAPES, _inputs, _port, _shape_id, check_against_pallas
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


@pytest.mark.parametrize("shape", SHAPES[5:], ids=_shape_id)
def test_planes_warp_matches_pallas_kernels(shape):
    check_against_pallas(shape)

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
