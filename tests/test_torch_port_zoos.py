"""Port parity: the ResNet-34/50 encoders, CADepth and SQLdepth of
baseboostdepth_tpu_torch against the flax modules of baseboostdepth_tpu,
fp32 on the CPU. The port's weights (its init from a seed, then BN scale,
bias and statistics and the zero biases moved off their initial values)
reach JAX through the JAX package's importers of reference torch
checkpoints, which works because the port's modules carry the reference's
names; models/convert.py::from_jax must invert those importers exactly.

Sizes: encoders and CADepth at 64x128, batch 2; SQLdepth at 128x512, batch
1 (its head needs >= 64 patch tokens at H/2); the sql_large head alone on a
160x320 map (128 tokens for its 128 queries). SQL runs with dropout rate 0
on both sides (the JAX side through a subclass of its TransformerLayer put
in place by monkeypatch; the two packages' dropout streams cannot agree).

Tolerances, each stated where it is used:
- forwards and BN statistics 1e-4 of each output's largest magnitude: the
  same float32 convolutions summed in another order through up to 50
  layers and BatchNorm (the md2 tests' bound);
- the encoders in train mode in float64 on both sides, 1e-10 / 1e-9 (why:
  the test's docstring);
- resize_bilinear_align_corners 1e-6 absolute: one interpolation weight
  computed as i * (H-1)/(h-1) by torch and by linspace by JAX.

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 70 s, JAX compiling most of it.

Some of this file's tests are in test_torch_port_zoos_forward.py (the resize, the zoo forwards, the
sql_large head) and test_torch_port_zoos_init.py (from_jax round trips,
init_disp_bias), so that each file has at most
seven tests: a file with more queues ahead of tests/test_zoo_training.py,
the suite's longest (ROADMAP.md, "The time budget").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baseboostdepth_tpu.models.sql as jax_sql
from baseboostdepth_tpu.models.cadepth import CADepthNet as JaxCADepthNet
from baseboostdepth_tpu.models.resnet import ResnetEncoder as JaxResnetEncoder
from baseboostdepth_tpu.models.resnet import encoder_channels as jax_encoder_channels
from baseboostdepth_tpu.models.torch_import import (
    cadepth_decoder_torch_to_flax,
    depth_decoder_torch_to_flax,
    diffnet_decoder_torch_to_flax,
    hrnet18_torch_to_flax,
    monovit_decoder_torch_to_flax,
    mpvit_torch_to_flax,
    pose_decoder_torch_to_flax,
    resnet_torch_to_flax,
    sql_encoder_torch_to_flax,
    sql_head_torch_to_flax,
)
from baseboostdepth_tpu_torch.models import build_depth_net
from baseboostdepth_tpu_torch.models.resnet import ResnetEncoder, encoder_channels, init_encoder_
from baseboostdepth_tpu_torch.models.sql import SQLDepthNet, init_sql_
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


class NoDropTransformerLayer(jax_sql.TransformerLayer):
    dropout: float = 0.0


@pytest.fixture()
def jax_sql_without_dropout(monkeypatch):
    monkeypatch.setattr(jax_sql, "TransformerLayer", NoDropTransformerLayer)


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def depth_to_flax(zoo, depth_sd):
    """A port depth network's state_dict -> the JAX zoo's (params, stats)."""
    d = _np(depth_sd)
    if zoo == "monovit":
        p, s = mpvit_torch_to_flax(sub(d, "encoder."))
        return ({"encoder": p, "decoder": monovit_decoder_torch_to_flax(sub(d, "decoder."))},
                {"encoder": s})
    if zoo == "diffnet":
        p, s = hrnet18_torch_to_flax(sub(d, "encoder."))
        return {"encoder": p, **diffnet_decoder_torch_to_flax(sub(d, "decoder."))}, {"encoder": s}
    if zoo in ("sql", "sql_large"):
        p, s = sql_encoder_torch_to_flax(sub(d, "encoder."))
        p["head"] = sql_head_torch_to_flax(sub(d, "head."))
        return p, s
    enc_p, enc_s = resnet_torch_to_flax(d, prefix="encoder.encoder.")
    if zoo == "cadepth":
        dec_p, dec_s = cadepth_decoder_torch_to_flax(sub(d, "decoder."))
        return {"encoder": enc_p, "decoder": dec_p}, {"encoder": enc_s, "decoder": dec_s}
    return ({"encoder": enc_p, "decoder": depth_decoder_torch_to_flax(sub(d, "decoder."))},
            {"encoder": enc_s})


def pose_to_flax(pose_sd):
    p = _np(pose_sd)
    enc_p, enc_s = resnet_torch_to_flax(p, prefix="encoder.encoder.")
    return {"encoder": enc_p, "decoder": pose_decoder_torch_to_flax(sub(p, "decoder."))}, \
        {"encoder": enc_s}


def perturb_(net, gen):
    """Move BN scale/bias/statistics and the zero biases off their initial
    values, so the conversion of every leaf is exercised."""
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("running_mean") or (name.endswith(".bias") and t.ndim == 1):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.05)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith(".weight") and t.ndim == 1:  # BN / LayerNorm scale
                t.copy_(torch.rand(t.shape, generator=gen) * 0.4 + 0.8)


def _close(actual, desired, rtol=1e-4, what=""):
    """Within rtol of the output's largest magnitude (forwards, statistics)."""
    desired = np.asarray(desired, np.float64)
    scale = max(np.abs(desired).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_layers", [18, 34, 50, 101, 152])
def test_encoder_channels(num_layers):
    assert encoder_channels(num_layers) == tuple(jax_encoder_channels(num_layers))
    assert ResnetEncoder(num_layers).num_ch_enc == encoder_channels(num_layers)


@pytest.mark.parametrize("num_layers", [34, 50])
def test_encoder_train_forward_stats_and_grads_match_jax(num_layers):
    """Eval mode in float32: the 5 taps to 1e-4 of their largest magnitude.
    Train mode in float64 on both sides (JAX under jax.enable_x64): the
    taps and the updated BN statistics to 1e-10 of their largest magnitude,
    and the gradients of sum(taps * random cotangents) in every parameter
    to 1e-9 relative L2 per tensor and 1e-9 of its largest entry per entry.

    Why train mode in float64: at batch 2 (16 values per channel at the
    last stage) batch-statistics BatchNorm and the ReLU kinks it spreads
    over whole channels make float32 ill-conditioned here. Measured against
    float64: JAX's float32 taps are off by up to 6.2e-4 of their largest
    magnitude (RN50, last tap; the port's by 1.6e-4), the port's float32
    gradients by up to 2.3% relative L2, JAX's float32 gradients by 0.5%
    even in eval mode (the port's 2e-6). The two packages in float64 agree
    to 1.3e-12."""
    gen = torch.Generator().manual_seed(num_layers)
    enc = ResnetEncoder(num_layers)
    init_encoder_(enc, gen)
    perturb_(enc, gen)
    p, s = resnet_torch_to_flax(_np(enc.state_dict()), prefix="encoder.")
    x = _images((2, 64, 128, 3), seed=1)

    jfeats = jax.jit(JaxResnetEncoder(num_layers=num_layers).apply, static_argnames="train")(
        {"params": p, "batch_stats": s}, jnp.asarray(x), train=False)
    with torch.no_grad():
        feats = enc.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (f, jf) in enumerate(zip(feats, jfeats)):
        _close(f.permute(0, 2, 3, 1).numpy(), jf, what=f"eval tap {i}")

    rng = np.random.default_rng(2)
    cots = [rng.standard_normal(f.shape) for f in jfeats]
    with jax.enable_x64(True):
        jnet = JaxResnetEncoder(num_layers=num_layers, dtype=jnp.float64)
        s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), s)

        def jloss(params):
            fs, mut = jnet.apply({"params": params, "batch_stats": s64},
                                 jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            return sum(jnp.sum(f * c) for f, c in zip(fs, cots)), (fs, mut["batch_stats"])

        (_, (jfeats, jstats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p))
        jfeats, jstats, jgrads = jax.tree.map(np.asarray, (jfeats, jstats, jgrads))
    enc64 = enc.double().train()
    feats = enc64(torch.from_numpy(x).double().permute(0, 3, 1, 2))
    sum((f * torch.from_numpy(c).permute(0, 3, 1, 2)).sum() for f, c in zip(feats, cots)).backward()
    for i, (f, jf) in enumerate(zip(feats, jfeats)):
        _close(f.detach().permute(0, 2, 3, 1).numpy(), jf, rtol=1e-10, what=f"train tap {i}")

    # the port's float64 gradients and statistics in JAX's layout (the
    # importer transposes without rounding)
    grads = {k: v.grad.numpy() for k, v in enc64.named_parameters()}
    tg, tstats = resnet_torch_to_flax({**_np(enc64.state_dict()), **grads}, prefix="encoder.")
    flat_t = jax.tree_util.tree_flatten_with_path(tg)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    assert len(flat_t) == len(flat_j) == len(list(enc64.parameters()))
    for path, g_t in flat_t:
        g = flat_j[path]
        np.testing.assert_allclose(g_t, g, rtol=0, atol=1e-9 * np.abs(g).max(),
                                   err_msg=f"grad {jax.tree_util.keystr(path)}")
        assert np.linalg.norm(g_t - g) <= 1e-9 * np.linalg.norm(g), jax.tree_util.keystr(path)
    for path, st_t in jax.tree_util.tree_flatten_with_path(tstats)[0]:
        st_j = dict(jax.tree_util.tree_flatten_with_path(jstats)[0])[path]
        # the port reduces its running statistics in float32 (models/resnet.py)
        _close(st_t, st_j, rtol=1e-6, what=f"stats {jax.tree_util.keystr(path)}")


def _zoo_nets(zoo, seed):
    gen = torch.Generator().manual_seed(seed)
    if zoo == "sql":
        net = SQLDepthNet(dropout_rate=0.0)
        init_sql_(net, gen)
        jnet = jax_sql.SQLDepthNet()
    else:
        net = build_depth_net(zoo, 50, gen)
        jnet = JaxCADepthNet()
    perturb_(net, gen)
    return net, jnet
