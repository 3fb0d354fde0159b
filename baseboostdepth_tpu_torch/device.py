"""Device selection shared by the entry points."""

from __future__ import annotations

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
