"""Device selection shared by the entry points, and the deterministic mode
every training step runs in."""

from __future__ import annotations

import contextlib
import os
import subprocess

import torch
import torch.utils.deterministic as torch_deterministic

# cuBLAS's deterministic workspace setting (torch's reproducibility notes).
# cuBLAS reads it when a handle is made: a process that calls cuBLAS before
# its first training step sets it before that call (chip_smoke.py does).
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def require_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device, raising if it is a CUDA device and
    no GPU is present (entry points never fall back to the CPU silently)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions of the kernels"
        )
    return device


def describe(device: torch.device) -> str:
    """What a measurement ran on: for a GPU its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (a card may be set below its maximum and then runs slower), else
    the device type."""
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


@contextlib.contextmanager
def deterministic():
    """Inside the block, training on the GPU is a function of its inputs and
    seeds, bit for bit, as XLA makes the JAX package's: torch takes its
    deterministic algorithms and raises on an op that has none
    (`torch.use_deterministic_algorithms`), cuDNN takes deterministic
    algorithms without benchmarking, cuBLAS its deterministic workspace
    (`CUBLAS_WORKSPACE_CONFIG`, set unless the environment sets it), and
    float32 matrix products run in float32, not TF32 (the step's geometry
    and resize matrices; the JAX package asks for HIGHEST). torch's NaN
    fill of every new tensor under its deterministic mode
    (`torch.utils.deterministic.fill_uninitialized_memory`) stays off: it
    guards ops that leave outputs unwritten, every op of the step writes
    all of its output (chip_smoke.py holds each kernel to its plain
    version), and on one H100 the fill cost a md2 step 1,300-1,800 more
    launches and 7-12 more device ms (PERF.md, §6). Every flag is
    process-wide and comes back to what it was when the block ends, so a
    caller's own settings (a test's, a tool's) hold outside it. There is no
    way to turn this off for the step: the JAX package has none."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark, matmul.allow_tf32,
             torch_deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark, matmul.allow_tf32 = True, False, False
    torch_deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.deterministic, cudnn.benchmark, matmul.allow_tf32 = saved[2:5]
        torch_deterministic.fill_uninitialized_memory = saved[5]
