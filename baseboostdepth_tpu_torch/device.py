"""Device selection shared by the entry points."""

from __future__ import annotations

import subprocess

import torch


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
