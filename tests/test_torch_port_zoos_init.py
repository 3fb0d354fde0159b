"""Port parity: models/convert.py::from_jax inverts the JAX package's
importers for md2 ResNet-50, CADepth and SQLdepth, and init_disp_bias
reaches every disparity head. The setup is test_torch_port_zoos.py's,
split from it so that each file has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~15 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baseboostdepth_tpu.models.sql as jax_sql
from baseboostdepth_tpu.models.cadepth import CADepthNet as JaxCADepthNet
from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
from baseboostdepth_tpu_torch.models.convert import from_jax
from test_torch_port_zoos import depth_to_flax, perturb_, pose_to_flax
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


@pytest.mark.parametrize("zoo", ["md2_rn50", "cadepth", "sql"])
def test_from_jax_round_trip(zoo):
    """The port's state_dict -> JAX's importers -> from_jax gives it back
    bit for bit, key for key; and a tree JAX initialises itself loads into
    the port's network with strict=True."""
    name = "md2" if zoo == "md2_rn50" else zoo
    gen = torch.Generator().manual_seed(8)
    net, pose = build_depth_net(name, 50, gen), build_pose_net(gen)
    perturb_(net, gen)
    dp, ds = depth_to_flax(name, net.state_dict())
    pp, ps = pose_to_flax(pose.state_dict())
    dsd, psd = from_jax({"depth": dp, "pose": pp}, {"depth": ds, "pose": ps})
    for own, back in ((net.state_dict(), dsd), (pose.state_dict(), psd)):
        assert set(own) == set(back)
        for k, v in own.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, back[k]), k

    h, w = (128, 512) if name == "sql" else (64, 128)
    if name == "sql":
        jnet = jax_sql.SQLDepthNet()
    elif name == "cadepth":
        jnet = JaxCADepthNet()
    else:
        from baseboostdepth_tpu.models import MD2DepthNet as JaxMD2DepthNet

        jnet = JaxMD2DepthNet(num_layers=50)
    v = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3))))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), v)
    jsd, _ = from_jax({"depth": zeros["params"], "pose": pp},
                      {"depth": zeros.get("batch_stats", {}), "pose": ps})
    net.load_state_dict(jsd, strict=True)


@pytest.mark.parametrize("zoo", ["md2", "cadepth", "sql"])
def test_init_disp_bias_reaches_every_disparity_head(zoo):
    """init_disp_bias sets the bias of every disparity head the JAX
    package's sets (each `dispconv` in its tree): md2's four, CADepth's four,
    none in SQLdepth; nothing else changes."""
    from baseboostdepth_tpu.training.step import init_disp_bias as jax_init_disp_bias
    from baseboostdepth_tpu_torch.training.step import init_disp_bias

    gen = torch.Generator().manual_seed(10)
    net, pose = build_depth_net(zoo, 18, gen), build_pose_net(gen)
    dp, ds = depth_to_flax(zoo, net.state_dict())
    pp, ps = pose_to_flax(pose.state_dict())
    before = {k: v.clone() for k, v in net.state_dict().items()}
    init_disp_bias(net, -2.2)
    ref, _ = from_jax({"depth": jax.tree.map(np.asarray, jax_init_disp_bias(dp, -2.2)),
                       "pose": pp}, {"depth": ds, "pose": ps})
    changed = [k for k, v in net.state_dict().items() if not torch.equal(v, before[k])]
    assert len(changed) == (0 if zoo == "sql" else 4)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
