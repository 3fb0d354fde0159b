"""Port parity: SQLdepth's eval and debug forwards (metric depth at H/2)
against the JAX package's, 128x512 on the CPU. The setup and tolerances
are test_torch_port_zoo_step.py's, split from it so that each file has at
most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~30 s, JAX compiling most of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baseboostdepth_tpu.models.sql as jax_sql
from baseboostdepth_tpu_torch.training.step import init_state
from test_torch_port_zoo_step import CASES, _close, _statics
from tests.test_torch_port_zoos import NoDropTransformerLayer, depth_to_flax, pose_to_flax
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


def test_sql_eval_forwards_match_jax(monkeypatch):
    """The evaluators' forwards on an SQLdepth network (metric depth, no
    disp_to_depth, at H/2): evaluation/depth.py::make_disp_forward and the
    step's make_eval_forward against the JAX package's, eval mode, to 1e-4
    of the depth's largest magnitude (the forward tolerance of
    test_torch_port_zoos.py)."""
    from baseboostdepth_tpu.evaluation.depth import make_disp_forward as jax_disp_forward
    from baseboostdepth_tpu.training.step import make_eval_forward as jax_eval_forward
    from baseboostdepth_tpu_torch.evaluation.depth import make_disp_forward
    from baseboostdepth_tpu_torch.training.step import make_eval_forward

    monkeypatch.setattr(jax_sql, "TransformerLayer", NoDropTransformerLayer)
    cfg = CASES["sql"]
    jst, tst = _statics(cfg)
    state = init_state(tst, device="cpu")
    dp, ds = depth_to_flax(tst.zoo, state.depth_net.state_dict())
    pp, ps = pose_to_flax(state.pose_net.state_dict())
    params = jax.tree.map(jnp.asarray, {"depth": dp, "pose": pp})
    stats = jax.tree.map(jnp.asarray, {"depth": ds, "pose": ps})
    images = np.random.default_rng(6).uniform(0, 1, (1, cfg["H"], cfg["W"], 3)).astype(np.float32)
    ref = np.asarray(jax_disp_forward(jst)(params, stats, jnp.asarray(images)))
    assert ref.shape == (1, cfg["H"] // 2, cfg["W"] // 2)
    for name, out in (("make_disp_forward", make_disp_forward(tst, "cpu")(state.depth_net, images)),
                      ("make_eval_forward", make_eval_forward(tst, "cpu")(state.depth_net, images))):
        assert tuple(out.shape) == ref.shape, name
        _close(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(), what=name)
    np.testing.assert_array_equal(
        np.asarray(jax_eval_forward(jst)(params, stats, jnp.asarray(images))), ref)
