"""Port parity: init_disp_bias on the md2 depth network against the JAX
package's, and the depth network at height 32 (the decoder's coarsest
stage one pixel high). The setup and tolerances are
test_torch_port_models.py's, split from it so that each file has at most
seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~10 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.training.step import init_disp_bias as jax_init_disp_bias
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.training.step import init_disp_bias
from test_torch_port_models import _close, nets
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


def test_init_disp_bias(nets):
    _, _, params, stats, td, _ = nets
    before = {k: v.clone() for k, v in td.state_dict().items()}
    ref, _ = from_jax({"depth": jax_init_disp_bias(params["depth"], -2.2), "pose": params["pose"]},
                      stats)
    init_disp_bias(td, -2.2)
    for k, v in td.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    td.load_state_dict(before)


def test_depth_net_at_height_32(nets):
    """At 32x64 the decoder's coarsest stage is 1 pixel high: jnp.pad's
    reflect padding repeats the row there, and the port's decoder does the
    same (torch's reflect padding refuses a length-1 axis)."""
    jd, _, params, stats, td, _ = nets
    x = np.random.default_rng(4).random((2, 32, 64, 3)).astype(np.float32)
    jout = jd.apply({"params": params["depth"], "batch_stats": stats["depth"]},
                    jnp.asarray(x), train=False)
    td.eval()
    with torch.no_grad():
        tout = td(torch.from_numpy(x))
    for a, b in zip(tout, jout):
        assert tuple(a.shape) == b.shape
        _close(a.numpy(), b)
