"""Port parity: the align-corners resize, the CADepth and SQLdepth forwards and
the sql_large head against the JAX package, fp32 on the CPU. The setup,
sizes and tolerances are test_torch_port_zoos.py's, split from it so that
each file has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~40 s, JAX compiling most of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baseboostdepth_tpu.models.sql as jax_sql
from baseboostdepth_tpu.models.torch_import import sql_head_torch_to_flax
from baseboostdepth_tpu.ops.resize import resize_bilinear_align_corners as jax_resize_ac
from baseboostdepth_tpu_torch.models import build_pose_net
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.models.sql import SQLDepthNet, SQLHead, init_sql_
from baseboostdepth_tpu_torch.ops.resize import resize_bilinear_align_corners
from test_torch_port_zoos import (  # noqa: F401 (fixtures)
    _close,
    _images,
    _np,
    _zoo_nets,
    depth_to_flax,
    jax_sql_without_dropout,
    perturb_,
    pose_to_flax,
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


@pytest.mark.parametrize("case", ["upscale", "downscale", "identity"])
def test_resize_bilinear_align_corners_matches_jax(case):
    shape, size = {"upscale": ((2, 3, 5, 4), (7, 11)), "downscale": ((2, 9, 13, 4), (4, 6)),
                   "identity": ((2, 6, 8, 4), (6, 8))}[case]
    x = _images(shape, seed=3)
    ref = np.asarray(jax_resize_ac(jnp.asarray(x), *size))
    out = resize_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), *size)
    assert out.shape == (shape[0], shape[3], *size)
    # one weight from i * (H-1)/(h-1) here, from linspace in JAX: 1e-6
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("zoo,size", [("cadepth", (2, 64, 128)), ("sql", (1, 128, 512))])
def test_zoo_forward_matches_jax(zoo, size, jax_sql_without_dropout):
    """Eval mode (running statistics) and train mode (batch statistics and
    their update) at the same weights; each output to 1e-4 of its largest
    magnitude (SQL's metric depth reaches ~40, CADepth's disparities 1)."""
    net, jnet = _zoo_nets(zoo, seed=4)
    p, s = depth_to_flax(zoo, net.state_dict())
    x = _images((*size, 3), seed=5)
    xt = torch.from_numpy(x)

    @jax.jit  # one compile: eager flax dispatches op by op, 3-4x slower here
    def jax_forwards(p, s, x):
        return (jnet.apply({"params": p, "batch_stats": s}, x, train=False),
                jnet.apply({"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))

    jev, (jtr, mut) = jax_forwards(p, s, jnp.asarray(x))
    with torch.no_grad():
        net.eval()
        ev = net(xt)
        net.train()
        tr = net(xt)
    n = 1 if zoo == "sql" else 4
    for k in range(n):
        assert tuple(ev[k].shape) == jev[k].shape
        _close(ev[k].numpy(), jev[k], what=f"eval output {k}")
        _close(tr[k].numpy(), jtr[k], what=f"train output {k}")
    pose_p, pose_s = pose_to_flax(build_pose_net().state_dict())
    new_sd, _ = from_jax({"depth": p, "pose": pose_p},
                         {"depth": jax.tree.map(np.asarray, mut["batch_stats"]), "pose": pose_s})
    checked = 0
    for name, buf in net.state_dict().items():
        if "running_" in name:
            _close(buf.numpy(), new_sd[name].numpy(), what=name)
            checked += 1
    assert checked > 0


def test_sql_large_head_matches_jax(jax_sql_without_dropout):
    """The sql_large head (patch 20, 128 queries and bins) on a 160x320 map,
    8 x 16 = 128 patch tokens; sql_large cannot run at 640x192 (64 tokens),
    in either package. Metric depth to 1e-4 of its largest magnitude."""
    gen = torch.Generator().manual_seed(6)
    net = SQLDepthNet(large=True, dropout_rate=0.0)
    init_sql_(net, gen)
    perturb_(net.head, gen)
    head = net.head
    assert isinstance(head, SQLHead) and head.query_nums == 128
    x = np.random.default_rng(7).standard_normal((1, 160, 320, 32)).astype(np.float32)
    p = sql_head_torch_to_flax(_np(head.state_dict()))
    jhead = jax_sql.SQLHead(patch_size=20, dim_out=128, query_nums=128)
    ref = jax.jit(jhead.apply, static_argnames="train")({"params": p}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = head.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(out.permute(0, 2, 3, 1).numpy(), ref, what="sql_large depth")
    with pytest.raises(ValueError, match="128 patch tokens"):
        head(torch.zeros(1, 32, 96, 320))  # 4 x 16 = 64 tokens
