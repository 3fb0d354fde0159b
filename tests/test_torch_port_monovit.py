"""Port parity: MonoViT (models/monovit.py) against the flax modules of
baseboostdepth_tpu, on the CPU.

JAX sees a narrow MPViT only: widths (16, 32, 48, 64), 8 heads, paths
(2, 2, 2, 2), blocks (1, 2, 1, 1) -- two blocks in stage 1, so the path's
shared position encodings are applied twice and their gradients add up --
with the HR decoder on its five features, at 32x64, batch 2. The port's
weights (its init from a seed, BN statistics, norm scales and zero biases
moved off their initial values) reach JAX through the JAX package's own
importers of reference checkpoints (mpvit_torch_to_flax,
monovit_decoder_torch_to_flax), which works because the port's modules
carry the reference's names. Drop-path is off on both sides
(drop_path_rate=0): the two packages' random streams cannot agree; the
port's masks are tested on their own.

The full MPViT-small is held against tests/torch_mpvit_ref.py (torch
against torch, no JAX): its released-checkpoint key space loads strictly
into the port's encoder through the port's key map, and the five features
agree at 64x96 in eval mode.

Tolerances, each stated where it is used:
- eval forwards, float32: 1e-4 of each output's largest magnitude (the same
  float32 convolutions and products summed in another order; measured
  2.4e-7);
- train mode in float64 on both sides (JAX under jax.enable_x64), outputs,
  updated BN statistics and the gradients of sum(disps * cotangents): 1e-5
  relative L2 per tensor and 1e-5 of each tensor's largest entry per entry.
  Batch-statistics BatchNorm at batch 2 (2 values a channel at the last
  stage) is ill-conditioned in float32; float64 removes that, and what is
  left is the two float32 casts both packages make on purpose (the softmax
  of K, mpvit.py:163, and the disparity sigmoid), whose last bits XLA and
  torch round differently. Measured: outputs 1.2e-7 and BN statistics
  1.5e-7 of their largest; gradients up to 3.4e-6 of the tensor's largest
  entry and 1.8e-6 relative L2 (stage 3's conv path, 2 values a channel,
  amplifies the casts' rounding most). Gradients that
  vanish in exact arithmetic (a BN bias ahead of another batch-statistics
  BN) are float64 rounding noise on both sides: a floor of 1e-12 per
  entry;
- the full-size replica: 1e-5 of each feature's largest magnitude.

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 35 s, JAX compiling most of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import baseboostdepth_tpu.models.monovit as jax_monovit
from baseboostdepth_tpu.models.torch_import import (
    monovit_decoder_torch_to_flax,
    mpvit_torch_to_flax,
)
from baseboostdepth_tpu_torch.models.depth_decoder import init_decoder_
from baseboostdepth_tpu_torch.models.monovit import MonoViTDepthNet, MPViT, drop_path
from baseboostdepth_tpu_torch.models.torch_import import load_into, mpvit_key_map
from tests.test_torch_port_zoos import perturb_
from torch_port_helpers import lowered_priority

# gradients that vanish in exact arithmetic (a BN bias ahead of another
# batch-statistics BN, which removes any per-channel constant) are float64
# rounding noise on both sides (~1e-16): an absolute floor far above it
F64_FLOOR = 1e-12
NARROW = dict(embed_dims=(16, 32, 48, 64), num_path=(2, 2, 2, 2), num_layers=(1, 2, 1, 1),
              num_heads=(8, 8, 8, 8))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


class JaxNarrowMonoViT(fnn.Module):
    """MonoViTDepthNet's tree ({encoder, decoder}) over the narrow MPViT."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train: bool = False):
        feats = jax_monovit.MPViT(**NARROW, drop_path_rate=0.0, dtype=self.dtype,
                                  name="encoder")(x, train=train)
        return jax_monovit.HRDecoder(dtype=self.dtype, name="decoder")(feats)


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def monovit_to_flax(sd, config=NARROW):
    """A port MonoViTDepthNet state_dict (or a gradient dict under its
    parameter names) over the MPViT of `config` -> JAX's (params,
    batch_stats) for {encoder, decoder}."""
    d = _np(sd)
    enc = {k[8:]: v for k, v in d.items() if k.startswith("encoder.")}
    dec = {k[8:]: v for k, v in d.items() if k.startswith("decoder.")}
    p, s = mpvit_torch_to_flax(enc, num_path=config["num_path"], num_layers=config["num_layers"])
    return {"encoder": p, "decoder": monovit_decoder_torch_to_flax(dec)}, {"encoder": s}


def narrow_net(seed):
    gen = torch.Generator().manual_seed(seed)
    net = MonoViTDepthNet(**NARROW, drop_path_rate=0.0)
    init_decoder_(net, gen)
    perturb_(net, gen)
    return net


def _close(actual, desired, rtol, what="", floor=0.0):
    """Within rtol of the output's largest magnitude (plus `floor`)."""
    desired = np.asarray(desired, np.float64)
    scale = max(np.abs(desired).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired, rtol=rtol,
                               atol=rtol * scale + floor, err_msg=what)


def _close_l2(actual, desired, rtol, what="", floor=F64_FLOOR):
    """Per entry within rtol of the tensor's largest entry, and the whole
    tensor within rtol relative L2, each plus an absolute float64 floor
    (per entry; times sqrt(size) for the L2 norm)."""
    actual, desired = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    _close(actual, desired, rtol, what, floor)
    err, ref = np.linalg.norm(actual - desired), np.linalg.norm(desired)
    bound = rtol * ref + floor * np.sqrt(desired.size)
    assert err <= bound, f"{what}: |diff| {err:.3e} vs |ref| {ref:.3e}"


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_eval_forward_matches_jax():
    """Eval mode, float32: the four disparities to 1e-4 of their largest."""
    net = narrow_net(seed=0).eval()
    p, s = monovit_to_flax(net.state_dict())
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 64, 3)).astype(np.float32)
    jout = jax.jit(JaxNarrowMonoViT().apply, static_argnames="train")(
        {"params": p, "batch_stats": s}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert len(out) == 4
    for k, (o, jo) in enumerate(zip(out, jout)):
        assert tuple(o.shape) == jo.shape == (2, 32 >> k, 64 >> k, 1)
        assert o.dtype == torch.float32
        _close(o.numpy(), jo, rtol=1e-4, what=f"disp {k}")


def test_train_forward_stats_and_grads_match_jax():
    """Train mode in float64 on both sides: disparities, updated BN
    statistics and every parameter's gradient of sum(disps * cotangents),
    1e-5 (the module docstring says why)."""
    net = narrow_net(seed=2)
    p, s = monovit_to_flax(net.state_dict())
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 64, 3))
    rng = np.random.default_rng(4)
    cots = [rng.standard_normal((2, 32 >> k, 64 >> k, 1)) for k in range(4)]

    with jax.enable_x64(True):
        jnet = JaxNarrowMonoViT(dtype=jnp.float64)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        s64 = f64(s)

        def jloss(params):
            outs, mut = jnet.apply({"params": params, "batch_stats": s64}, jnp.asarray(x),
                                   train=True, mutable=["batch_stats"])
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, mut["batch_stats"])

        (_, (jouts, jstats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(f64(p))
        jouts, jstats, jgrads = jax.tree.map(np.asarray, (jouts, jstats, jgrads))

    net = net.double().train()
    outs = net(torch.from_numpy(x))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    for k, (o, jo) in enumerate(zip(outs, jouts)):
        _close_l2(o.detach().numpy(), jo, 1e-5, what=f"train disp {k}")

    grads = {k: v.grad for k, v in net.named_parameters()}
    gp, ts = monovit_to_flax({**net.state_dict(), **grads})
    flat_g, flat_jg = _flat(gp), _flat(jgrads)
    assert set(flat_g) == set(flat_jg)
    assert len(flat_jg) == len(list(net.parameters()))
    for k, g in flat_g.items():
        _close_l2(g, flat_jg[k], 1e-5, what=f"grad {k}")
    flat_s, flat_js = _flat(ts), _flat({"encoder": jstats["encoder"]})
    assert set(flat_s) == set(flat_js) and flat_s
    for k, v in flat_s.items():
        _close(v, flat_js[k], 1e-5, what=f"BN statistics {k}")


def test_drop_path_masks_come_from_the_generator():
    """Drop-path draws one mask entry per sample from the forward's
    generator: the same seed gives the same train-mode output, another
    seed another; eval mode draws nothing; a dropped sample's residual
    branch is zero, a kept one is scaled by 1/(1 - rate)."""
    x = torch.randn(64, 5, 3)
    y = drop_path(x, 0.5, True, torch.Generator().manual_seed(0))
    per_sample = y.reshape(64, -1)
    dropped = (per_sample == 0).all(dim=1)
    kept = torch.isclose(per_sample, 2.0 * x.reshape(64, -1)).all(dim=1)
    assert bool((dropped | kept).all()) and 10 < int(dropped.sum()) < 54
    assert torch.equal(drop_path(x, 0.5, False, None), x)
    assert torch.equal(drop_path(x, 0.0, True, None), x)

    gen = torch.Generator().manual_seed(5)
    net = MonoViTDepthNet(**{**NARROW, "num_layers": (2, 2, 2, 2)}, drop_path_rate=0.5)
    init_decoder_(net, gen)
    img = torch.rand(4, 32, 64, 3, generator=gen)
    rates = [blk.drop_rate for stage in net.encoder.mhca_stages
             for blk in stage.mhca_blks[0].MHCA_layers]
    np.testing.assert_allclose(rates, np.linspace(0, 0.5, 8))

    def run(seed):
        net.train()
        with torch.no_grad():
            return net(img, generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    net.eval()
    with torch.no_grad():
        e1 = net(img, generator=torch.Generator().manual_seed(7))[0]
        e2 = net(img, generator=torch.Generator().manual_seed(8))[0]
    assert torch.equal(e1, e2)


def test_full_mpvit_small_loads_the_replica_and_matches_it():
    """The released mpvit_small.pth key space (tests/torch_mpvit_ref.py,
    seeded, BN statistics moved off (0, 1)) loads strictly into the port's full MPViT-small through the
    key map, and the five features agree with the replica's at 64x96 in
    eval mode, 1e-5 of each feature's largest magnitude. Torch against
    torch: no JAX."""
    from tests.torch_mpvit_ref import mpvit_small

    with torch.random.fork_rng():
        torch.manual_seed(11)
        ref = mpvit_small()
    perturb_(ref, torch.Generator().manual_seed(11))
    ref.load_state_dict(ref.state_dict())  # one value under every shared alias
    ref.eval()
    enc = MPViT().eval()
    assert enc.num_ch_enc == (64, 128, 216, 288, 288)
    load_into(enc, mpvit_key_map(ref.state_dict()))
    x = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        feats, ref_feats = enc(x), ref(x)
    assert len(feats) == len(ref_feats) == 5
    for k, (f, rf) in enumerate(zip(feats, ref_feats)):
        assert f.shape == rf.shape
        _close(f.numpy(), rf.numpy(), 1e-5, what=f"feature {k}")
