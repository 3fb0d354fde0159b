"""Port parity: DIFFNet (models/diffnet.py) against the flax modules of
baseboostdepth_tpu, on the CPU.

The port's weights (its init from a seed, BN statistics and scales and the
zero biases moved off their initial values) reach JAX through the JAX
package's own importers of reference checkpoints (hrnet18_torch_to_flax,
diffnet_decoder_torch_to_flax), which works because the port's modules
carry the reference's names.

JAX sees HRNet-18 with stages 3 and 4 cut to one HighResolutionModule
each (through its module-level HRNET18_STAGES, put in place by
monkeypatch): every kind of block, branch and fusion is still there, and
JAX compiles a third of the network. JAX's importer reads the full module
count, so the cut modules are filled in from a full-size template for it
and taken out of its tree again.
- Eval mode at 64x128, batch 2, float32, with running statistics taken
  from one train-mode forward of the input (at the perturbed statistics
  alone the activations grow through the blocks until every disparity
  saturates at 0 or 1).
- Train mode in float64 on both sides (JAX under jax.enable_x64): outputs,
  updated BN statistics and every parameter's gradient of sum(disps *
  cotangents), at 64x128, batch 2.
- The full-size replicas (tests/torch_zoo_refs.py: make_hrnet18,
  make_diffnet_decoder, seeded) load strictly into the port's network
  through its key maps, and JAX's importers of the same state dicts,
  carried back by models/convert.py::from_jax, give the port's tensors bit
  for bit (numpy only, no JAX compile).

Tolerances: eval forwards 1e-4 of each output's largest magnitude (float32
convolutions summed in another order; measured 8.2e-6); float64 train mode 1e-5 of each tensor's largest entry per entry
and 1e-5 relative L2 per tensor (with test_torch_port_monovit.py's 1e-12
floor; no gradient vanishes here): what is left in float64 is the
disparity sigmoid, which both packages compute in float32 on purpose.
Measured: outputs 9.6e-8, BN statistics 5.0e-8, gradients 5.3e-7 of their
largest (a disparity head's bias).

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 40 s, JAX compiling most of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baseboostdepth_tpu.models.diffnet as jax_diffnet
from baseboostdepth_tpu.models.torch_import import (
    diffnet_decoder_torch_to_flax,
    hrnet18_torch_to_flax,
)
from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.models.depth_decoder import init_decoder_
from baseboostdepth_tpu_torch.models.diffnet import HRNET18_STAGES, DIFFNetDepthNet, HRNetEncoder
from baseboostdepth_tpu_torch.models.resnet import init_encoder_
from baseboostdepth_tpu_torch.models.torch_import import (
    decoder_key_map,
    hrnet_key_map,
    load_into,
)
from tests.test_torch_port_monovit import _close, _close_l2, _flat
from tests.test_torch_port_zoos import perturb_, pose_to_flax
from torch_port_helpers import lowered_priority

#: stages 3 and 4 with one HighResolutionModule each
CUT = {**HRNET18_STAGES, "stage3": {**HRNET18_STAGES["stage3"], "modules": 1},
       "stage4": {**HRNET18_STAGES["stage4"], "modules": 1}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def diffnet_to_flax(sd):
    """A port DIFFNetDepthNet state_dict (or gradients under its parameter
    names), full or cut, -> JAX's (params, batch_stats) trees."""
    d = _np(sd)
    enc = {k[8:]: v for k, v in d.items() if k.startswith("encoder.")}
    dec = {k[8:]: v for k, v in d.items() if k.startswith("decoder.")}
    template = _np(HRNetEncoder().state_dict())
    p, s = hrnet18_torch_to_flax({**template, **enc})
    for name in [n for n in p if n.startswith("stage")]:
        if not any(k.startswith(f"{name[:6]}.{name[8:]}.") for k in enc):
            del p[name], s[name]
    return {"encoder": p, **diffnet_decoder_torch_to_flax(dec)}, {"encoder": s}


def _net(seed, stages=HRNET18_STAGES):
    gen = torch.Generator().manual_seed(seed)
    net = DIFFNetDepthNet(stages)
    init_encoder_(net.encoder, gen)
    init_decoder_(net.decoder, gen)
    perturb_(net, gen)
    return net


def _calibrate_(net, x):
    """Running statistics = the batch statistics of one train-mode forward
    of x (momentum 1 for that forward)."""
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        net.train()(torch.from_numpy(x))
    for m in bns:
        m.momentum = 0.1


def test_eval_forward_matches_jax(monkeypatch):
    """Eval mode, float32: the four disparities, not saturated, to 1e-4 of
    their largest."""
    monkeypatch.setattr(jax_diffnet, "HRNET18_STAGES", CUT)
    net = _net(seed=0, stages=CUT)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    _calibrate_(net, x)
    net.eval()
    p, s = diffnet_to_flax(net.state_dict())
    jout = jax.jit(jax_diffnet.DIFFNetDepthNet().apply, static_argnames="train")(
        {"params": p, "batch_stats": s}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    for k, (o, jo) in enumerate(zip(out, jout)):
        assert tuple(o.shape) == jo.shape == (2, 64 >> k, 128 >> k, 1)
        assert o.dtype == torch.float32
        assert 0.01 < float(o.min()) and float(o.max()) < 0.99 and float(o.std()) > 0.01
        _close(o.numpy(), jo, 1e-4, what=f"disp {k}")


def test_train_forward_stats_and_grads_match_jax(monkeypatch):
    """Stages 3 and 4 cut to one module, train mode in float64 on both
    sides: disparities, updated BN statistics, every parameter's gradient,
    1e-5 (the module docstring says why)."""
    monkeypatch.setattr(jax_diffnet, "HRNET18_STAGES", CUT)
    net = _net(seed=2, stages=CUT)
    p, s = diffnet_to_flax(net.state_dict())
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 128, 3))
    rng = np.random.default_rng(4)
    cots = [rng.standard_normal((2, 64 >> k, 128 >> k, 1)) for k in range(4)]

    with jax.enable_x64(True):
        jnet = jax_diffnet.DIFFNetDepthNet(dtype=jnp.float64)
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
    gp, ts = diffnet_to_flax({**net.state_dict(), **grads})
    flat_g, flat_jg = _flat(gp), _flat(jgrads)
    assert set(flat_g) == set(flat_jg)
    assert len(flat_jg) == len(list(net.parameters()))
    for k, g in flat_g.items():
        _close_l2(g, flat_jg[k], 1e-5, what=f"grad {k}")
    flat_s, flat_js = _flat(ts), _flat({"encoder": jstats["encoder"]})
    assert set(flat_s) == set(flat_js) and flat_s
    for k, v in flat_s.items():
        _close(v, flat_js[k], 1e-5, what=f"BN statistics {k}")


def test_full_replicas_load_and_round_trip_through_jax():
    """make_hrnet18 / make_diffnet_decoder (seeded, BN statistics moved off
    (0, 1)) load strictly into the port's full DIFFNet through its key
    maps (the decoder's `decoder.*` ModuleList aliases dropped); JAX's
    importers of the same state dicts, carried back by from_jax, give every
    tensor of the port's network bit for bit, key for key."""
    from tests.torch_zoo_refs import make_diffnet_decoder, make_hrnet18

    with torch.random.fork_rng():
        torch.manual_seed(5)
        enc_ref, dec_ref = make_hrnet18(), make_diffnet_decoder()
    perturb_(enc_ref, torch.Generator().manual_seed(5))
    perturb_(dec_ref, torch.Generator().manual_seed(6))
    net = build_depth_net("diffnet")
    assert net.encoder.num_ch_enc == (64, 18, 36, 72, 144)
    load_into(net.encoder, hrnet_key_map(enc_ref.state_dict()))
    load_into(net.decoder, decoder_key_map(dec_ref.state_dict()))

    p, s = hrnet18_torch_to_flax(_np(enc_ref.state_dict()))
    dp = {"encoder": p, **diffnet_decoder_torch_to_flax(_np(dec_ref.state_dict()))}
    pp, ps = pose_to_flax(build_pose_net().state_dict())
    back, _ = from_jax({"depth": dp, "pose": pp}, {"depth": {"encoder": s}, "pose": ps})
    own = net.state_dict()
    assert set(own) == set(back)
    for k, v in own.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, back[k]), k
