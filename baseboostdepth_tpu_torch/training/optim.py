"""Optimizer and LR schedule, the counterpart of
`baseboostdepth_tpu/training/optim.py`.

Reference: Adam lr=1e-4 with MultiStepLR milestones [11,13,15,16,17,18,19]
gamma=0.4 (trainer.py:106-112). The reference steps its scheduler at the
START of every epoch, so milestone m takes effect during 0-indexed epoch
m-1: the boundary sits at step (m-1) * steps_per_epoch, and the rate is
scaled from that step on (optax.piecewise_constant_schedule semantics).
The MonoViT two-group AdamW is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def multistep_lr(
    base_lr: float, milestones: Sequence[int], gamma: float, steps_per_epoch: int
) -> Callable[[int], float]:
    """step count -> learning rate."""
    boundaries = {max(0, m - 1) * steps_per_epoch: gamma for m in milestones}

    def schedule(count: int) -> float:
        v = base_lr
        for b, scale in sorted(boundaries.items()):
            if count >= b:
                v *= scale
        return v

    return schedule


def make_optimizer(
    params,
    learning_rate: float = 1e-4,
    milestones: Sequence[int] = (11, 13, 15, 16, 17, 18, 19),
    gamma: float = 0.4,
    steps_per_epoch: int = 1,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (optax.adam defaults: b1 0.9, b2 0.999, eps 1e-8) under the
    MultiStep schedule. Call scheduler.step() after every optimizer step."""
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    sched = multistep_lr(1.0, milestones, gamma, steps_per_epoch)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)
