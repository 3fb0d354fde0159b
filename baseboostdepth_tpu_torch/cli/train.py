"""Training entry point (reference train.py): seed, build the Trainer, run.

    python -m baseboostdepth_tpu_torch.cli.train --data.kt_path KITTI_RAW \
        [--data.splits_dir splits] [--section.field value ...]

Trains on one GPU; `main(argv, device="cpu")` runs the same loop on the CPU
with the kernels' plain versions.

Data parallelism, one process per GPU (the JAX trainer spans every local
chip from one process):

    python -m torch.distributed.run --nproc_per_node 4 \
        -m baseboostdepth_tpu_torch.cli.train --dist.enabled True ...

joins the group from torch.distributed.run's environment; on hosts that
announce nothing, give each process `--dist.coordinator host:port` (or an
init URL such as file:///shared/rdv), `--dist.num_processes` and
`--dist.process_id`. `--optim.batch_size` stays the global batch.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch.distributed

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.parallel import initialize_distributed
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
    """Train. With `--dist.enabled` the process joins the group first (NCCL
    on a GPU, gloo on the CPU; `device` becomes this process's GPU) and
    leaves it when training ends."""
    cfg = Config.from_args(argv)
    if not cfg.dist.enabled:
        trainer = build_trainer(argv, device)
        trainer.train()
        return trainer
    device = initialize_distributed(cfg.dist.coordinator, cfg.dist.num_processes,
                                    cfg.dist.process_id, device)
    try:
        trainer = build_trainer(argv, device)
        trainer.train()
    finally:
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
