"""The display path of the port's inference CLIs on the CPU: the upsampling
to the display size against the JAX package's resize, and the colormaps
(data in utils/colormaps.py) against matplotlib's. Split from
test_torch_port_cli_eval.py so that each file has at most seven tests
(ROADMAP.md, "The time budget").

Single-worker time: ~3 s.
"""

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from baseboostdepth_tpu_torch.cli import infer
from baseboostdepth_tpu_torch.utils import colormap
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


@pytest.mark.parametrize("size", [(375, 1242), (20, 50), (100, 60)], ids=["up", "down", "mixed"])
def test_display_upsampling_matches_jax_resize(size):
    disp = np.random.default_rng(9).random((64, 128)).astype(np.float32)
    ours = infer.upsample_for_display(torch.from_numpy(disp), *size).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(disp), size, method="linear"))
    assert ours.shape == size
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("cmap", ["plasma", "magma"])
def test_colormap_matches_matplotlib(cmap):
    rng = np.random.default_rng(10)
    edge = [0.0, 1.0, 1 - 1e-7, -1e-7, -0.5, 1.5, np.nan, np.inf, -np.inf, 1 / 256, 255 / 256]
    for dtype in (np.float32, np.float64):
        x = np.concatenate([rng.random(989), edge]).astype(dtype).reshape(25, 40)
        ref = matplotlib.colormaps[cmap](x)[..., :3]
        np.testing.assert_array_equal(colormap(x, cmap, normalize=False), ref)
    y = rng.normal(size=(7, 9)).astype(np.float32)
    lo, hi = float(y.min()), float(y.max())
    np.testing.assert_array_equal(colormap(y, cmap),
                                  matplotlib.colormaps[cmap]((y - lo) / (hi - lo))[..., :3])
    with pytest.raises(ValueError):
        colormap(y, "viridis")
