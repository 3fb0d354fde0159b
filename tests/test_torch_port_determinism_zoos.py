"""Fault C5 (ROADMAP.md, C): the training step of every zoo reaches no op
that has no deterministic CUDA implementation.

test_torch_port_determinism.py's recording (its docstring says what and
why) for md2 ResNet-50, CADepth at its two-call warp schedule, MonoViT and
DIFFNet at the early stage (F=2, scales 0-3) at 64x128, and SQLdepth at
scale 0 and 128x512 (its head needs 64 patch tokens), batch 2, float32.

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 35 s.
"""

import pytest
import torch

from test_torch_port_determinism import EARLY, recorded_step
from torch_port_helpers import lowered_priority

ZOOS = {
    "md2_rn50": dict(zoo="md2", num_layers=50, height=64, width=128, **EARLY),
    "cadepth_two_call": dict(zoo="cadepth", num_layers=50, height=64, width=128,
                             merged_warp=False, **EARLY),
    "sql": dict(zoo="sql", num_layers=50, height=128, width=512, F=1, scales=(0,)),
    "monovit": dict(zoo="monovit", height=64, width=128, **EARLY),
    "diffnet": dict(zoo="diffnet", height=64, width=128, **EARLY),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("zoo", list(ZOOS))
def test_zoo_step_has_no_nondeterministic_op(zoo):
    rec = recorded_step(**ZOOS[zoo])
    assert "convolution_backward" in rec.ops  # the backward was recorded
    assert not rec.refused, f"ops without a deterministic CUDA form: {sorted(rec.refused)}"
