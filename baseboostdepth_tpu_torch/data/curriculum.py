"""The baseline-boosting curriculum, a copy of
`baseboostdepth_tpu/data/curriculum.py`: pure host-side sampling logic that
consumes the same numpy RNG draws in the same order.

Reproduces the reference's per-epoch / per-sample frame-window selection
(mono_dataset.py:61-66 epoch schedule, :90-108 per-sample filter):

  epoch < switch: F = 2 (trimin) / 1,  cutoff = 0.1 + 0.04 * epoch
  epoch >= switch: F = 7 (trimin) / 5, cutoff = 0.15 * epoch - 0.9

  per sample: f = largest offset with f <= F and f * baseline <= cutoff,
  then clipped by a random 'mini' shrink (30% chance of 1..6) and by frame
  existence at the sequence boundaries; samples ending with f == 0 are
  stereo-only, and under tri-min any sample with f <= 2 also gets the
  stereo candidate (encoded later by the slot table).

Chained ("incremental") posing activates when cutoff > 0.5 (reference
trainer.py:346), which given the schedule means exactly the epochs >= switch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class Stage:
    epoch: int
    F: int  # max temporal offset this epoch (reference to_use)
    cutoff: float  # boosting weight (reference cutt_off)
    scales: tuple  # loss scales this epoch (trainer.py:208-212)
    incremental_active: bool  # cutoff > 0.5 gate (trainer.py:346)


def stage_for_epoch(epoch: int, trimin: bool, switch_epoch: int = 10, sql: bool = False) -> Stage:
    if epoch < switch_epoch:
        F = 2 if trimin else 1
        cutoff = 0.1 + 0.04 * epoch
    else:
        F = 7 if trimin else 5
        cutoff = 0.15 * epoch - 0.9
    scales = (0,) if (epoch >= switch_epoch or sql) else (0, 1, 2, 3)
    return Stage(epoch, F, cutoff, scales, cutoff > 0.5)


def sample_f_max(
    baseline: float,
    stage: Stage,
    rng: np.random.Generator,
    exists: Optional[Callable[[int], bool]] = None,
) -> int:
    """Per-sample max frame offset.

    Args:
      baseline: per-sample motion magnitude (5th split-file column).
      exists: offset -> bool; frame availability at sequence boundaries
        (None = everything available).
    Returns f in [0, stage.F]; 0 means stereo-only.
    """
    if baseline <= 0:
        f = stage.F
    else:
        f = min(stage.F, int(math.floor(stage.cutoff / baseline + 1e-9)))
    f = max(0, f)

    # random window shrink: 30% chance of mini in 1..6 (mono_dataset.py:99)
    mini = int(rng.integers(1, 7)) if rng.random() > 0.7 else 0
    hard_cap = 7 - mini

    if exists is not None:
        limit_pos = 0
        for i in range(1, hard_cap + 1):
            if exists(i):
                limit_pos = i
        limit_neg = 0
        for i in range(1, hard_cap + 1):
            if exists(-i):
                limit_neg = i
        limit = min(limit_pos, limit_neg)
    else:
        limit = hard_cap

    return min(f, limit)
