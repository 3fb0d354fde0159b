"""Fault C5 (ROADMAP.md, C): the port's training step reaches no op that
has no deterministic CUDA implementation, for md2 at each step option.

One training step (`make_train_step`, forward, backward and Adam, on the
CPU) of md2 ResNet-18 at 32x64 (64x128 with pose_input_scale=0.5), batch
2, float32, runs under a TorchDispatchMode that records every ATen op it
dispatches, the backward's included; the test holds the ops against the
ones torch documents as having no deterministic CUDA form (tests/torch_port_helpers.py,
`NO_DETERMINISTIC_CUDA`, from torch 2.13.0's docstring of
`torch.use_deterministic_algorithms`). At 32x64 the coarsest decoder stage
has height 1, so the length-1 pad is reached too. On the card the same
step runs under `device.deterministic()`, where torch raises on any such
op, and chip_smoke.py's determinism phase runs it twice, bit-equal.

The CPU runs the plain versions of the hand-written kernels, whose ops the
card does not run; none of them is on the list either. The BatchNorm on
the card takes other ops (ops/batch_norm.py); chip_smoke.py covers them.
What the recording found at the parent commit, and what this holds gone:
reflection_pad2d_backward (every decoder conv, CADepth's DEM, the plain
SSIM), replication_pad2d_backward (the length-1 pad),
upsample_bilinear2d_backward (the disparity upsample, SQLdepth's and
DIFFNet's align-corners resize) and cumsum (SQLdepth's bin edges).
max_pool2d_with_indices_backward, avg_pool2d_backward,
upsample_nearest2d_backward and scatter_add (torch.gather's backward) are
on no list: their CUDA forms are deterministic under the flag.

The zoos are in test_torch_port_determinism_zoos.py, the ops that replace
torch's and the flags' lifetime in test_torch_port_determinism_ops.py
(seven tests a file at most).

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 15 s.
"""

import pytest
import torch

from baseboostdepth_tpu_torch.training.batch import synthetic_batch
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state, make_train_step
from torch_port_helpers import OpRecorder, lowered_priority

EARLY = dict(F=2, scales=(0, 1, 2, 3), incremental=False, partial=False)
LATE = dict(F=3, scales=(0,), incremental=True, partial=True)
FUSED = dict(photo_impl="fused", warp_impl="pallas")

MD2_OPTIONS = {
    "early_default": dict(**EARLY),
    "late_default": dict(**LATE),
    "early_fused_packed": dict(**EARLY, **FUSED),
    "late_fused_packed": dict(**LATE, **FUSED),
    "early_float_frames": dict(**EARLY, float_frames=True),
    "late_two_call": dict(**LATE, merged_warp=False),
    # 64x128: the pose network's pairs at round(H * 0.5 / 32) * 32 x ...
    "late_pose_half": dict(**LATE, pose_input_scale=0.5, height=64, width=128),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def recorded_step(height, width, batch=2, float_frames=False, **fields) -> OpRecorder:
    """One train step of StepStatic(**fields) at height x width on the CPU,
    its ops recorded."""
    st = StepStatic(height=height, width=width, trimin=True, decomp=True, dtype="float32",
                    **fields)
    state = init_state(st, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in synthetic_batch(st.F, batch, height, width, 1).items()}
    if float_frames:
        b["frames"] = b["frames"].float() / 255.0
    step = make_train_step(st, device="cpu")
    with OpRecorder() as rec:
        metrics = step(state, b, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"])
    return rec


@pytest.mark.parametrize("case", list(MD2_OPTIONS))
def test_md2_step_has_no_nondeterministic_op(case):
    rec = recorded_step(**{"height": 32, "width": 64, "zoo": "md2", **MD2_OPTIONS[case]})
    assert "convolution_backward" in rec.ops  # the backward was recorded
    assert not rec.refused, f"ops without a deterministic CUDA form: {sorted(rec.refused)}"
