"""Training entry point (reference train.py): seed, build the Trainer, run.

    python -m baseboostdepth_tpu_torch.cli.train --data.kt_path KITTI_RAW \
        [--data.splits_dir splits] [--section.field value ...]

Trains on the GPU; `main(argv, device="cpu")` runs the same loop on the CPU
with the kernels' plain versions.
"""

from __future__ import annotations

import random
import sys

import numpy as np

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.training.trainer import Trainer


def build_trainer(argv=None, device="cuda") -> Trainer:
    """Parse `--section.field value` overrides, seed the host RNGs (the
    reference's determinism hooks, train.py:8-23; the networks' init and the
    step noise take explicit seeds) and build the Trainer, which restores
    the latest checkpoint of its log directory."""
    cfg = Config.from_args(argv)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    return Trainer(cfg, device=device)


def main(argv=None, device="cuda") -> Trainer:
    trainer = build_trainer(argv, device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
