"""Optimizer and LR schedule, the counterpart of
`baseboostdepth_tpu/training/optim.py`.

Reference: Adam lr=1e-4 with MultiStepLR milestones [11,13,15,16,17,18,19]
gamma=0.4 (trainer.py:106-112). The reference steps its scheduler at the
START of every epoch, so milestone m takes effect during 0-indexed epoch
m-1: the boundary sits at step (m-1) * steps_per_epoch, and the rate is
scaled from that step on (optax.piecewise_constant_schedule semantics).

MonoViT trains with AdamW in two groups (trainer.py:106-109): the depth
encoder at `vit_encoder_lr`, everything else at the base rate, both under
the MultiStep schedule. The JAX package builds it as
optax.multi_transform of two optax.adamw, so its defaults hold here:
weight decay 1e-4 (torch.optim.AdamW's default is 1e-2) on every parameter,
BN scales and biases included (optax masks none), betas 0.9 / 0.999, eps
1e-8. torch's decoupled decay p * (1 - lr * wd) is optax's
-lr * wd * p on the same p.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

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


def make_vit_optimizer(
    encoder_params: Iterable[torch.Tensor],
    other_params: Iterable[torch.Tensor],
    learning_rate: float = 1e-4,
    vit_encoder_lr: float = 5e-5,
    milestones: Sequence[int] = (11, 13, 15, 16, 17, 18, 19),
    gamma: float = 0.4,
    steps_per_epoch: int = 1,
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """MonoViT's two-group AdamW (optax.adamw defaults: b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4): group 0 the depth encoder's parameters at
    `vit_encoder_lr`, group 1 the rest at `learning_rate`, both under the
    MultiStep schedule. Call scheduler.step() after every optimizer step."""
    opt = torch.optim.AdamW(
        [{"params": list(encoder_params), "lr": vit_encoder_lr},
         {"params": list(other_params), "lr": learning_rate}],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    sched = multistep_lr(1.0, milestones, gamma, steps_per_epoch)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)
