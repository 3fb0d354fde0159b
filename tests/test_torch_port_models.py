"""Port parity: the md2 networks of baseboostdepth_tpu_torch against the
flax modules of baseboostdepth_tpu, fp32. The port's weights go to JAX
through the JAX package's importers of reference torch checkpoints, and
models/convert.py::from_jax must invert them exactly.

64x128 images (ResNet-18's depth is fixed, so the small size comes from the
image). Tolerance 1e-4 relative to each output's largest magnitude: the
same convolutions summed in another order through 20 layers and BatchNorm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu.models import MD2DepthNet as JaxMD2DepthNet
from baseboostdepth_tpu.models import PoseNet as JaxPoseNet
from baseboostdepth_tpu.models.torch_import import (
    depth_decoder_torch_to_flax,
    pose_decoder_torch_to_flax,
    resnet_torch_to_flax,
)
from baseboostdepth_tpu_torch.models import build_depth_net, build_pose_net
from baseboostdepth_tpu.training.step import init_disp_bias as jax_init_disp_bias
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.training.step import init_disp_bias

H, W = 64, 128
RTOL = 1e-4


def _close(actual, desired, rtol=RTOL):
    desired = np.asarray(desired, np.float64)
    scale = max(np.abs(desired).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired, rtol=rtol, atol=rtol * scale)


def to_flax(depth_sd, pose_sd):
    """Port state_dicts -> the JAX package's (params, batch_stats) trees, via
    its own importers of the reference's torch checkpoints
    (models/torch_import.py): the port's module names are the reference's."""
    d = {k: v.detach().numpy() for k, v in depth_sd.items()}
    p = {k: v.detach().numpy() for k, v in pose_sd.items()}

    def sub(sd, prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    de_p, de_s = resnet_torch_to_flax(d, prefix="encoder.encoder.")
    pe_p, pe_s = resnet_torch_to_flax(p, prefix="encoder.encoder.")
    params = {
        "depth": {"encoder": de_p, "decoder": depth_decoder_torch_to_flax(sub(d, "decoder."))},
        "pose": {"encoder": pe_p, "decoder": pose_decoder_torch_to_flax(sub(p, "decoder."))},
    }
    return params, {"depth": {"encoder": de_s}, "pose": {"encoder": pe_s}}


def _perturb_(net, gen):
    """Move BN scale/bias/statistics and the zero conv biases off their
    initial values, so the conversion of every leaf is exercised."""
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("running_mean") or (name.endswith(".bias") and t.ndim == 1):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.05)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith(".weight") and t.ndim == 1:  # BN scale
                t.copy_(torch.rand(t.shape, generator=gen) * 0.4 + 0.8)


@pytest.fixture(scope="module")
def nets():
    gen = torch.Generator().manual_seed(0)
    td, tp = build_depth_net(generator=gen), build_pose_net(generator=gen)
    _perturb_(td, gen)
    _perturb_(tp, gen)
    params, stats = to_flax(td.state_dict(), tp.state_dict())
    return JaxMD2DepthNet(num_layers=18), JaxPoseNet(), params, stats, td, tp


def test_from_jax_inverts_the_reference_importers(nets):
    _, _, params, stats, td, tp = nets
    depth_sd, pose_sd = from_jax(params, stats)
    for net, sd in ((td, depth_sd), (tp, pose_sd)):
        ref = net.state_dict()
        assert set(sd) == set(ref)
        for k, v in ref.items():
            assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("train", [False, True])
def test_depth_net(nets, train):
    jd, _, params, stats, td, _ = nets
    x = np.random.default_rng(2).random((2, H, W, 3)).astype(np.float32)
    jvars = {"params": params["depth"], "batch_stats": stats["depth"]}
    if train:
        jout, mut = jd.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        jout = jd.apply(jvars, jnp.asarray(x), train=False)
    td.train(train)
    before = {k: v.clone() for k, v in td.state_dict().items()}
    with torch.no_grad():
        tout = td(torch.from_numpy(x))
    assert len(tout) == len(jout) == 4
    for a, b in zip(tout, jout):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        _close(a.numpy(), b)
    if train:
        # one train-mode forward updates the running statistics as flax does
        # (momentum 0.9, biased batch variance)
        new_sd, _ = from_jax(
            {"depth": params["depth"], "pose": params["pose"]},
            {"depth": mut["batch_stats"], "pose": stats["pose"]},
        )
        for k, v in td.state_dict().items():
            if "running_" in k:
                _close(v.numpy(), new_sd[k].numpy())
        td.load_state_dict(before)
    else:
        for k, v in td.state_dict().items():
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("train", [False, True])
def test_pose_net(nets, train):
    _, jp, params, stats, _, tp = nets
    x = np.random.default_rng(3).random((3, H, W, 6)).astype(np.float32)
    jvars = {"params": params["pose"], "batch_stats": stats["pose"]}
    if train:
        (ja, jt), mut = jp.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ja, jt = jp.apply(jvars, jnp.asarray(x), train=False)
    tp.train(train)
    before = {k: v.clone() for k, v in tp.state_dict().items()}
    with torch.no_grad():
        ta, tt = tp(torch.from_numpy(x))
    assert tuple(ta.shape) == (3, 3) and ta.dtype == torch.float32
    _close(ta.numpy(), ja)
    _close(tt.numpy(), jt)
    if train:
        _, new_sd = from_jax(params, {"depth": stats["depth"], "pose": mut["batch_stats"]})
        for k, v in tp.state_dict().items():
            if "running_" in k:
                _close(v.numpy(), new_sd[k].numpy())
        tp.load_state_dict(before)


def test_state_dict_names_follow_the_reference(nets):
    """Keys a published encoder.pth / depth.pth / pose.pth would carry."""
    _, _, _, _, td, tp = nets
    dkeys, pkeys = set(td.state_dict()), set(tp.state_dict())
    for k in ("encoder.encoder.conv1.weight", "encoder.encoder.bn1.running_var",
              "encoder.encoder.layer2.0.downsample.0.weight",
              "encoder.encoder.layer4.1.bn2.weight",
              "decoder.decoder.0.conv.conv.weight", "decoder.decoder.13.conv.bias"):
        assert k in dkeys, k
    assert tuple(tp.state_dict()["encoder.encoder.conv1.weight"].shape) == (64, 6, 7, 7)
    assert "decoder.net.3.weight" in pkeys


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
