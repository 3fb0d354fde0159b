"""SQLdepth at its published width, and its attention dropout, against the
JAX package on the CPU (baseboostdepth_tpu/models/sql.py, unchanged).

The other SQL parity tests run at 128x512, batch 1, where the head sees
4 x 16 = 64 patch tokens, exactly its 64 queries. At 192x640 it sees
6 x 20 = 120 tokens and its queries are the first 64 of them: that path,
and a batch above 1, are held here. The JAX networks are initialised by
flax (PRNGKey 0); the port takes their parameters through
models/convert.py::from_jax.

  - SQLDepthNet in train mode (batch statistics) at 192x640, batch 2,
    dropout 0 on both sides (JAX: test_torch_port_zoos.py's
    NoDropTransformerLayer put in place by monkeypatch): the metric depth
    to 1e-4 of its largest entry, the updated BN statistics to 1e-4
    relative + 2e-4 of each tensor's largest entry, the ResNet-50 bounds of
    ROADMAP.md, C. [measured: depth 4.1e-5; statistics 1.0e-5 beyond the
    relative part]
  - The head alone, train mode, on a full-width decoder output (32 x 96 x
    320, batch 2, standard normal), dropout 0.1 on both sides and the same
    masks given to both: each layer's attention-dropout mask one [N, N]
    array (fed to flax through its `bernoulli` draw, which
    broadcast_dropout asks for at [1, 1, N, N], and to the port through
    models/sql.py::attention_keep), and the feed-forward dropouts'
    per-element masks (flax's nn.Dropout draws, the port's draw_local).
    The output and its gradient in the input to 1e-5 of their largest
    entries, float64 on both sides (both packages still take their
    softmaxes in float32 on purpose): in float32 a ReLU kink of the
    feed-forward layers can fall on either side in the two packages, and
    one flip moves the input gradient far beyond the bound.
    [measured: output 9.1e-7, input gradient 3.1e-6]
  - The port's attention mask alone: one [1, 1, N, N] mask a call, the
    same for every sample and head (two equal samples give equal outputs,
    and the weights are the softmax times that mask over 1 - p); its keep
    share within 1% of 0.9 over eight calls.

The whole train step at 192x640 is not held here: its JAX compile alone
would take most of a minute on one worker.

Single-worker time (one pytest process, one torch thread): ~35 s.
"""

import types

import flax.linen.attention as flax_attention
import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baseboostdepth_tpu.models.sql as jax_sql
from baseboostdepth_tpu_torch.models import build_pose_net, sql
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.models.sql import SQLDepthNet, SelfAttention
from test_torch_port_zoos import _images, jax_sql_without_dropout, pose_to_flax  # noqa: F401
from torch_port_helpers import lowered_priority

H, W, B = 192, 640, 2
N_TOKENS = (H // 2 // 16) * (W // 2 // 16)  # 120
P = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other port test files, at a lowered
    CPU priority (torch_port_helpers.lowered_priority)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def _within(actual, desired, rtol, floor, what):
    """Within rtol relative plus `floor` of the reference's largest entry."""
    desired = np.asarray(desired, np.float64)
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired, rtol=rtol,
                               atol=floor * np.abs(desired).max(), err_msg=what)
    return float(np.abs(np.asarray(actual, np.float64) - desired).max() / np.abs(desired).max())


@pytest.fixture(scope="module")
def jax_init():
    """The JAX SQLDepthNet's (params, batch_stats) as flax initialises them
    from PRNGKey 0 (the shapes do not depend on the input's size)."""
    variables = jax.jit(jax_sql.SQLDepthNet().init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 512, 3)), train=False)
    return jax.tree.map(np.asarray, (variables["params"], variables["batch_stats"]))


def _from_jax(params, stats):
    """The port's depth network state_dict from the JAX depth network's trees."""
    pose_p, pose_s = pose_to_flax(build_pose_net().state_dict())
    return from_jax({"depth": params, "pose": pose_p}, {"depth": stats, "pose": pose_s})[0]


def test_full_width_train_forward_matches_jax(jax_init, jax_sql_without_dropout):
    """Train mode at 192x640, batch 2 (120 tokens, the first 64 the
    queries), dropout 0: depth and the updated BN statistics (module
    docstring)."""
    params, stats = jax_init
    jnet = jax_sql.SQLDepthNet()
    x = _images((B, H, W, 3), seed=21)

    @jax.jit
    def forward(p, s, x):
        return jnet.apply({"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"])

    jout, mut = forward(params, stats, jnp.asarray(x))
    net = SQLDepthNet(dropout_rate=0.0)
    net.load_state_dict(_from_jax(params, stats))
    with torch.no_grad():
        out = net.train()(torch.from_numpy(x))
    assert tuple(out[0].shape) == jout[0].shape == (B, H // 2, W // 2, 1)
    print("depth", _within(out[0].numpy(), jout[0], 0.0, 1e-4, "depth"))
    new_sd = _from_jax(params, jax.tree.map(np.asarray, mut["batch_stats"]))
    worst, checked = 0.0, 0
    for name, buf in net.state_dict().items():
        if "running_" in name:
            ref = new_sd[name].numpy().astype(np.float64)
            beyond = np.abs(buf.numpy() - ref) - 1e-4 * np.abs(ref)
            worst = max(worst, float(beyond.max() / np.abs(ref).max()))
            _within(buf.numpy(), ref, 1e-4, 2e-4, name)
            checked += 1
    assert checked == sum(1 for k in new_sd if "running_" in k) > 100
    print("statistics beyond 1e-4 relative, of the largest entry", worst)


class _GivenMasks:
    """Keep masks handed out in order to both packages' draws: each
    layer's attention mask [N, N] and its three feed-forward masks, made
    with numpy from a seed."""

    def __init__(self, n, batch, dim, ff, layers=4, seed=31):
        rng = np.random.default_rng(seed)
        self.per_layer = [(rng.uniform(size=(n, n)) >= P,
                           rng.uniform(size=(batch, n, dim)) >= P,
                           rng.uniform(size=(batch, n, ff)) >= P,
                           rng.uniform(size=(batch, n, dim)) >= P) for _ in range(layers)]
        self.flat = [m for layer in self.per_layer for m in layer]

    def jax_draws(self):
        """A stand-in for jax.random in flax's attention and dropout modules:
        bernoulli hands out the next mask at the shape asked for."""
        queue = list(self.flat)

        def bernoulli(key, p=0.5, shape=None):
            mask = queue.pop(0)
            assert np.isclose(p, 1.0 - P)
            return jnp.asarray(np.broadcast_to(mask, shape))

        return types.SimpleNamespace(bernoulli=bernoulli), queue

    def port_draws(self):
        queue = list(self.flat)

        def attention_keep(n, p, generator, device):
            mask = queue.pop(0)
            assert mask.shape == (n, n) and p == P
            return torch.from_numpy(mask)[None, None]

        def draw_local(draw, shape, **kwargs):
            mask = queue.pop(0)
            assert mask.shape == tuple(shape)
            # a uniform draw that `>= p` turns into the mask
            return torch.from_numpy(np.where(mask, 1.0, 0.0))

        return attention_keep, draw_local, queue


def test_head_with_given_masks_matches_flax(jax_init, monkeypatch):
    """The head in train mode at dropout 0.1 with the same masks in both
    packages, float64 on both sides: output and input gradient to 1e-5 of
    their largest entries (module docstring)."""
    params, stats = jax_init
    jhead = jax_sql.SQLHead(dtype=jnp.float64)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((B, H // 2, W // 2, 32))
    cot = rng.standard_normal((B, H // 2, W // 2, 1))
    masks = _GivenMasks(N_TOKENS, B, 32, 512)

    draws, jqueue = masks.jax_draws()
    monkeypatch.setattr(flax_attention, "random", draws)
    monkeypatch.setattr(flax_stochastic, "random", draws)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params["head"])

        def jloss(x):
            out = jhead.apply({"params": p64}, x, train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)})
            return jnp.sum(out * cot), out

        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
        jout, jgrad = np.asarray(jout), np.asarray(jgrad)
    assert not jqueue and jgrad.dtype == np.float64  # the depth itself is float32 in both

    keep_fn, draw_fn, tqueue = masks.port_draws()
    monkeypatch.setattr(sql, "attention_keep", keep_fn)
    monkeypatch.setattr(sql, "draw_local", draw_fn)
    net = SQLDepthNet(dropout_rate=P)
    net.load_state_dict(_from_jax(params, stats))
    head = net.head.double().train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = head(xt)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert not tqueue
    print("output", _within(out.detach().permute(0, 2, 3, 1).numpy(), jout, 0.0, 1e-5, "out"))
    print("input gradient", _within(xt.grad.permute(0, 2, 3, 1).numpy(), jgrad, 0.0, 1e-5,
                                    "input gradient"))


def test_attention_mask_is_one_for_the_batch_and_the_heads(monkeypatch):
    """One [1, 1, N, N] keep mask a call: two equal samples give equal
    outputs, and the output is the attention of every sample and head with
    its softmax weights times that mask over 1 - p."""
    gen = torch.Generator().manual_seed(3)
    attn = SelfAttention(32, 4, P).train()
    with torch.no_grad():
        attn.in_proj_weight.normal_(0.0, 0.3, generator=gen)
    masks = []
    draw = sql.attention_keep
    monkeypatch.setattr(sql, "attention_keep",
                        lambda *a, **k: masks.append(draw(*a, **k)) or masks[-1])
    x = torch.randn((1, N_TOKENS, 32), generator=gen).expand(3, -1, -1)
    with torch.no_grad():
        out = attn(x, torch.Generator().manual_seed(4))
        assert len(masks) == 1 and masks[0].shape == (1, 1, N_TOKENS, N_TOKENS)
        assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
        q, k, v = (t.reshape(3, N_TOKENS, 4, 8).transpose(1, 2) for t in
                   torch.nn.functional.linear(x, attn.in_proj_weight,
                                              attn.in_proj_bias).chunk(3, dim=-1))
        weights = torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5, dim=-1)
        heads = (weights * masks[0] / (1.0 - P)) @ v  # [3, 4, N, 8]
        expect = attn.out_proj(heads.transpose(1, 2).reshape(3, N_TOKENS, 32))
    torch.testing.assert_close(out, expect)


def test_attention_keep_share():
    """The attention mask keeps 1 - p of its entries: over eight calls the
    share is within 1% of 0.9 (8 standard deviations of the share's
    spread at 115,200 draws); a generator of the same seed draws the same
    masks."""
    gen = torch.Generator().manual_seed(5)
    masks = [sql.attention_keep(N_TOKENS, P, gen, "cpu") for _ in range(8)]
    share = float(torch.cat(masks).float().mean())
    assert abs(share - (1.0 - P)) <= 0.01 * (1.0 - P), share
    again = torch.Generator().manual_seed(5)
    assert all(torch.equal(m, sql.attention_keep(N_TOKENS, P, again, "cpu")) for m in masks)
    assert not torch.equal(masks[0], masks[1])
