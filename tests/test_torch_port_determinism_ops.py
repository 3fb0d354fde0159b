"""Fault C5 (ROADMAP.md, C): the deterministic forms that replace torch's
reflect pad and bilinear resizes, against the JAX package, and the
deterministic mode's lifetime around a training step.

- `ops/pad.py::reflect_pad1` against `jnp.pad(mode="reflect")`, values and
  VJPs, at generic shapes and where H or W is 1 or 2 (jnp.pad repeats a
  length-1 axis), float32: values exactly (a copy), VJPs within 1e-6
  relative + 1e-7 (up to four cotangents summed in another order).
- `ops/resize.py::resize_bilinear` (the disparity upsample at each scale's
  size, and the pose network's half-size pairs) against the JAX package's
  `resize_bilinear` (jax.image.resize), and
  `resize_bilinear_align_corners` against the JAX package's gather form
  (NHWC there, NCHW here), values and VJPs, float32 on inputs and
  cotangents of order 1: values within 1e-6 relative + 4e-6 (the tap
  positions rounded to float32 in other ways: JAX takes linspace, torch a
  scale times the index), VJPs within 1e-6 relative + 1e-5 (an input pixel
  sums up to 64 cotangents at 8x, in another order).
- The same two resizes against torch's F.interpolate, the form they
  replace: float32 values within 4e-6; bf16 (SQLdepth's decoder under
  autocast) in bf16 out, within one bf16 rounding (2^-8 relative).
- A train step on the CPU runs with torch's deterministic algorithms,
  cuDNN's deterministic mode, no cuDNN benchmark, TF32 off, torch's NaN
  fill of new tensors off and cuBLAS's workspace setting; afterwards every
  flag is what the caller had, also when the step raises.
- Two runs of three steps from one seed end bit-equal: parameters, Adam's
  state, BN statistics, losses.

Inputs are numpy draws from fixed seeds. Single-worker time (one pytest
process, one torch thread, Intel Xeon): about 15 s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch.utils.deterministic as torch_deterministic

from baseboostdepth_tpu.ops import resize as jax_resize
from baseboostdepth_tpu_torch import device as device_mod
from baseboostdepth_tpu_torch.ops.pad import reflect_pad1
from baseboostdepth_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_align_corners
from baseboostdepth_tpu_torch.training import step as step_mod
from baseboostdepth_tpu_torch.training.batch import synthetic_batch
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, make_train_step
from torch_port_helpers import lowered_priority

PAD_SHAPES = ((2, 3, 6, 9), (1, 2, 1, 5), (1, 2, 4, 1), (2, 1, 1, 1), (1, 3, 2, 2), (3, 7, 3))
# (in h, in w, out h, out w): each decoder scale's disparity to 48x160,
# SQLdepth's H/2 map to H, the pose pairs to half size, odd sizes
RESIZES = ((6, 20, 48, 160), (12, 40, 48, 160), (24, 80, 48, 160), (24, 80, 48, 160),
           (48, 160, 24, 80), (7, 13, 20, 9))
ALIGN_RESIZES = ((3, 10, 6, 20), (6, 20, 12, 40), (5, 7, 11, 3), (1, 4, 3, 8))
VALUE_ATOL, VJP_ATOL = 4e-6, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def _vjp_torch(fn, x, g):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    y.backward(torch.tensor(g))
    return y.detach().numpy(), xt.grad.numpy()


def _vjp_jax(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def test_reflect_pad1_matches_jnp_pad():
    rng = np.random.default_rng(0)
    for shape in PAD_SHAPES:
        x = rng.standard_normal(shape).astype(np.float32)
        padded = shape[:-2] + (shape[-2] + 2, shape[-1] + 2)
        g = rng.standard_normal(padded).astype(np.float32)
        pad = [(0, 0)] * (len(shape) - 2) + [(1, 1), (1, 1)]
        y, dx = _vjp_torch(reflect_pad1, x, g)
        jy, jdx = _vjp_jax(lambda v: jnp.pad(v, pad, mode="reflect"), x, g)
        np.testing.assert_array_equal(y, jy, err_msg=f"{shape}")
        np.testing.assert_allclose(dx, jdx, rtol=1e-6, atol=1e-7, err_msg=f"{shape}")


def test_resize_bilinear_matches_jax():
    rng = np.random.default_rng(1)
    for h, w, H, W in RESIZES:
        x = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
        g = rng.standard_normal((2, H, W, 3)).astype(np.float32)
        y, dx = _vjp_torch(lambda v: resize_bilinear(v, H, W), x, g)
        jy, jdx = _vjp_jax(lambda v: jax_resize.resize_bilinear(v, H, W), x, g)
        np.testing.assert_allclose(y, jy, rtol=1e-6, atol=VALUE_ATOL, err_msg=f"{(h, w, H, W)}")
        np.testing.assert_allclose(dx, jdx, rtol=1e-6, atol=VJP_ATOL, err_msg=f"{(h, w, H, W)}")


def test_resize_bilinear_align_corners_matches_jax():
    rng = np.random.default_rng(2)
    for h, w, H, W in ALIGN_RESIZES:
        x = rng.standard_normal((2, 4, h, w)).astype(np.float32)
        g = rng.standard_normal((2, 4, H, W)).astype(np.float32)
        y, dx = _vjp_torch(lambda v: resize_bilinear_align_corners(v, H, W), x, g)
        jy, jdx = _vjp_jax(lambda v: jax_resize.resize_bilinear_align_corners(
            v.transpose(0, 2, 3, 1), H, W).transpose(0, 3, 1, 2), x, g)
        np.testing.assert_allclose(y, jy, rtol=1e-6, atol=VALUE_ATOL, err_msg=f"{(h, w, H, W)}")
        np.testing.assert_allclose(dx, jdx, rtol=1e-6, atol=VJP_ATOL, err_msg=f"{(h, w, H, W)}")


def test_resizes_match_f_interpolate():
    """The forms they replace: float32 to 4e-6; bf16 under autocast (the
    SQL decoder's) in bf16 out, within one bf16 rounding; channels-last in,
    channels-last out."""
    rng = np.random.default_rng(3)
    for h, w, H, W in RESIZES:
        x = torch.tensor(rng.uniform(0, 1, (2, h, w, 1)).astype(np.float32))
        ref = F.interpolate(x.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                            align_corners=False).permute(0, 2, 3, 1)
        torch.testing.assert_close(resize_bilinear(x, H, W), ref, rtol=0, atol=VALUE_ATOL)
    for h, w, H, W in ALIGN_RESIZES:
        x = torch.tensor(rng.standard_normal((2, 8, h, w)).astype(np.float32))
        ref = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=True)
        torch.testing.assert_close(resize_bilinear_align_corners(x, H, W), ref, rtol=0,
                                   atol=VALUE_ATOL)
        xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = resize_bilinear_align_corners(xb, H, W)
        ref = F.interpolate(xb.float(), size=(H, W), mode="bilinear", align_corners=True)
        assert got.dtype == torch.bfloat16
        assert got.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(got.float(), ref, rtol=2.0**-8, atol=VALUE_ATOL)


def _small_step():
    st = StepStatic(height=32, width=64, F=2, scales=(0, 1, 2, 3), dtype="float32")
    batch = synthetic_batch(st.F, 2, st.height, st.width, seed=5)
    return st, batch


def _flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32,
            torch_deterministic.fill_uninitialized_memory)


def _set_flags(flags):
    torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cuda.matmul.allow_tf32,
     torch_deterministic.fill_uninitialized_memory) = flags[2:]


def test_train_step_runs_deterministic_and_restores_flags(monkeypatch):
    st, batch = _small_step()
    state = init_state(st, device="cpu")
    step = make_train_step(st, device="cpu")
    # unset inside the test, as the caller had it after it
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    seen = []
    loss_forward = step_mod.loss_forward

    def spy(*args, **kwargs):
        seen.append((_flags(), os.environ.get("CUBLAS_WORKSPACE_CONFIG")))
        return loss_forward(*args, **kwargs)

    monkeypatch.setattr(step_mod, "loss_forward", spy)
    before = _flags()
    # a caller's own settings, the opposite of the mode's, come back after
    # the step; the mode's own settings hold inside it
    callers = (False, True, False, True, True, True)
    try:
        _set_flags(callers)
        step(state, batch, generator=torch.Generator().manual_seed(0))
        assert _flags() == callers
        assert seen == [((True, False, True, False, False, False),
                         device_mod.CUBLAS_WORKSPACE_CONFIG)]

        def boom(*args, **kwargs):
            raise RuntimeError("boom")

        monkeypatch.setattr(step_mod, "loss_forward", boom)
        with pytest.raises(RuntimeError, match="boom"):
            step(state, batch)
        assert _flags() == callers
    finally:
        _set_flags(before)
    assert _flags() == before


def test_train_steps_repeat_bit_for_bit():
    st, batch = _small_step()

    def run():
        state = init_state(st, seed=3, device="cpu")
        step = make_train_step(st, device="cpu")
        gen = torch.Generator().manual_seed(4)
        losses = [step(state, batch, generator=gen)["loss"] for _ in range(3)]
        return losses, state.state_dict()

    (la, a), (lb, b) = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for net in ("depth_net", "pose_net"):
        assert a[net].keys() == b[net].keys()
        for k in a[net]:
            assert torch.equal(a[net][k], b[net][k]), f"{net}.{k}"
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), f"adam {i}.{k}"
