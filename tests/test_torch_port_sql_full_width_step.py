"""SQLdepth's whole train step at its published width, 192x640, against the
JAX package's on the CPU: the first curriculum stage's step (F=2, direct
poses, scale 0, the stereo slot), batch 2, float32, dropout 0 on both
sides, from the port's init carried to JAX by the JAX package's importers,
on test_torch_port_zoo_step.py's smooth textured frames (both samples with
temporal frames, so that the pose network has a gradient).

Held to test_torch_port_zoo_step.py's ResNet-50 bounds (ROADMAP.md, C):
the loss to 1e-6 relative; gradients per entry 1e-4 relative + 2e-5 + 6e-2
of the tensor's largest entry, per tensor 6e-2 relative L2 (the pose
network the standard 3e-2); BN statistics 1e-4 relative + 2e-4 of the
largest entry. On top, each network part's gradient norm (the encoder, the
decoder, the transformer, the rest of the head, bins_regressor,
convert_to_prob, the pose network) to 2e-2 of JAX's: the per-tensor bound
over a part's tensors, halved, since a part sums many tensors whose
float32 differences do not line up. [measured: part norms up to 7.9e-4
of JAX's (the encoder), the head's parts and the pose network's up to
2.3e-4]

The late stage (F=7, 14 pose pairs and 8 warp slots a sample) is left out
at this width: the early step alone takes ~45 s of the file's minute.

Single-worker time (one pytest process, one torch thread): ~50 s.
"""

import numpy as np
import pytest
import torch

from test_torch_port_zoo_step import check_zoo_step
from torch_port_helpers import lowered_priority

FULL = dict(zoo="sql", num_layers=50, H=192, W=640, B=2, F=2, scales=(0,), incremental=False,
            partial=False, f_max=(2, 1), deep=True)
PARTS = (("depth.encoder.encoder.", "encoder"), ("depth.encoder.decoder.", "decoder"),
         ("depth.head.transformer_encoder.", "transformer"),
         ("depth.head.bins_regressor.", "bins_regressor"),
         ("depth.head.convert_to_prob.", "convert_to_prob"), ("depth.head.", "head_other"),
         ("pose.", "pose"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other port test files, at a lowered
    CPU priority (torch_port_helpers.lowered_priority)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def _part(name):
    return next(part for prefix, part in PARTS if name.startswith(prefix))


def test_full_width_first_step_matches_jax(monkeypatch):
    """The early-stage step at 192x640, batch 2 (120 patch tokens, the first
    64 the queries): loss, gradients, BN statistics, and each part's
    gradient norm (module docstring)."""
    state, gd, gp = check_zoo_step(FULL, monkeypatch)
    port, ref = {}, {}
    for net, m, g_ref in (("depth", state.depth_net, gd), ("pose", state.pose_net, gp)):
        for n, p in m.named_parameters():
            part = _part(f"{net}.{n}")
            port[part] = port.get(part, 0.0) + float(p.grad.double().pow(2).sum())
            ref[part] = ref.get(part, 0.0) + float(g_ref[n].double().pow(2).sum())
    assert set(ref) == {part for _, part in PARTS} and all(v > 0 for v in ref.values())
    rel = {k: abs(np.sqrt(port[k]) - np.sqrt(ref[k])) / np.sqrt(ref[k]) for k in ref}
    print("part gradient norms, relative to JAX's:", rel)
    assert max(rel.values()) <= 2e-2, rel
