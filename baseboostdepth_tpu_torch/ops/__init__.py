"""Hot-path ops: bilinear warping, SSIM, resizing.

Two elementwise helpers keep the JAX package's gradients where torch's
built-ins choose another subgradient:

- `clip` is `jnp.clip`: at exactly a bound the gradient is 0.5, as for
  `minimum(maximum(x, lo), hi)` with ties split (`torch.clamp` passes 1.0).
  Identity-pose warp slots land exactly on x = 0 and x = W-1, so the
  difference reaches the depth and pose gradients.
- `absolute` is `jnp.abs`: its gradient at exactly 0 is +1 (`torch.abs`
  passes 0). A warped pixel that equals the target exactly hits it.
"""

from __future__ import annotations

import torch


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip semantics, gradient included (0.5 at an exact bound)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def absolute(x: torch.Tensor) -> torch.Tensor:
    """jnp.abs semantics, gradient included (+1 at exactly 0)."""
    return torch.where(x >= 0, x, -x)
