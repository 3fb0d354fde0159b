"""Multi-process data parallelism, one GPU per process: the counterpart of
`baseboostdepth_tpu/parallel/` (see sharding.py). The JAX package spans
every local chip from one process; the port runs one process per GPU,
launched by `torch.distributed.run` (cli/train.py with `--dist.enabled`).
"""

from baseboostdepth_tpu_torch.parallel.sharding import (  # noqa: F401
    all_reduce_mean,
    all_reduce_sum,
    average_gradients_,
    broadcast_int,
    broadcast_state_,
    draw_local,
    initialize_distributed,
    is_initialized,
    is_lead,
    local_rows,
    rank,
    world_size,
)
