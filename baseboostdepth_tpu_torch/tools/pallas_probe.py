"""The capability probes of `tools/pallas_probe.py` on the GPU: its seven
kernels (a trivial scale, row and column gathers, a flattened wide gather,
a dynamic row slice) through the CUDA kernels of `ops/probe_cuda.py`.

    python -m baseboostdepth_tpu_torch.tools.pallas_probe

The inputs come from `np.random.default_rng(0)` in the JAX tool's order and
at its shapes, so the two tools see the same arrays; each probe's result
must equal the JAX tool's numpy reference exactly. Each probe prints the
JAX tool's label and OK or FAIL. Unlike the JAX tool, this one exits
non-zero when any probe fails or raises. `main(device="cpu")` runs the
kernels' plain versions.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.ops import probe_cuda


@dataclass
class Probe:
    name: str  # the JAX tool's probe function
    label: str  # the label it prints
    op: str  # the probe_cuda wrapper: probe_<op>
    args: Tuple[np.ndarray, ...]
    expected: np.ndarray  # the JAX tool's numpy reference


def probe_cases() -> list:
    """The seven probes, their inputs drawn from np.random.default_rng(0)
    probe by probe (source, then indices) as the JAX tool draws them."""
    rng = np.random.default_rng(0)
    cases = []

    x = rng.random((256, 512)).astype(np.float32)
    cases.append(Probe("trivial", "trivial", "scale", (x,), x * 2))

    for name, label, rows in (("sublane_gather", "sublane take_along_axis (64->8)", 64),
                              ("sublane_gather_same", "sublane gather 8x128 (in-tile)", 8)):
        src = rng.random((rows, 128)).astype(np.float32)
        idx = rng.integers(0, rows, (8, 128)).astype(np.int32)
        cases.append(Probe(name, label, "gather_rows", (src, idx),
                           np.take_along_axis(src, idx, axis=0)))

    for name, label, cols in (("lane_gather", "lane take_along_axis (128 wide)", 128),
                              ("lane_gather_wide", "lane gather 640 wide", 640)):
        src = rng.random((8, cols)).astype(np.float32)
        idx = rng.integers(0, cols, (8, cols)).astype(np.int32)
        cases.append(Probe(name, label, "gather_cols", (src, idx),
                           np.take_along_axis(src, idx, axis=1)))

    src = rng.random((64, 128)).astype(np.float32)
    idx = rng.integers(0, 64 * 128, (8, 128)).astype(np.int32)
    flat = src.reshape(1, -1)
    cases.append(Probe("gather_2d_flat", "flattened wide lane gather", "gather_cols", (flat, idx),
                       np.take_along_axis(np.broadcast_to(flat, (8, 64 * 128)), idx, axis=1)))

    src = rng.random((64, 128)).astype(np.float32)
    cases.append(Probe("dyn_slice", "dynamic row slice", "row_slice",
                       (src, np.array([17], np.int32)), src[17:25]))
    return cases


def run_probe(case: Probe, device) -> np.ndarray:
    """The probe's wrapper on `case.args` moved to `device`, as numpy."""
    fn = getattr(probe_cuda, f"probe_{case.op}")
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in case.args))
    return out.cpu().numpy()


def probe(name: str, fn) -> bool:
    """Print `name` and OK or FAIL; a probe that raises is reported and
    counts as failed."""
    try:
        ok = bool(fn())
    except Exception as e:  # noqa: BLE001 -- the report names any failure
        msg = str(e).replace("\n", " ")[:180]
        print(f"{name:34s} FAIL {type(e).__name__}: {msg}")
        return False
    print(f"{name:34s} {'OK  ' if ok else 'FAIL'} {ok}")
    return ok


def main(device="cuda") -> int:
    """Run the seven probes; return the number that failed."""
    device = require_device(device)
    failed = 0
    for case in probe_cases():
        ok = probe(case.label, lambda c=case: np.array_equal(run_probe(c, device), c.expected))
        failed += not ok
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
