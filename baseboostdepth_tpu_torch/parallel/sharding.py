"""Data parallelism over processes, one GPU each: the counterpart of
`baseboostdepth_tpu/parallel/sharding.py`.

The JAX package shards the batch over a 1-D 'data' mesh and replicates the
state, and GSPMD turns every batch reduction (BatchNorm statistics, the
gradient, the metrics) into a cross-device psum, so a W-device step equals
the one-device step on the same global batch. Here the same contract is
kept by hand, PyTorch's way:
- one process per GPU in a `torch.distributed` process group (NCCL on the
  card, gloo on the CPU), `initialize_distributed`;
- each rank loads its own rows of every global batch (`local_rows`, the
  loader's `process_index` / `process_count`, the counterpart of
  `shard_batch`);
- parameters and buffers start equal (`broadcast_state_`, the counterpart
  of `replicate`) and stay equal: every rank applies the same averaged
  gradient (`average_gradients_`);
- BatchNorm reduces its statistics over the global batch
  (ops/batch_norm.py: one `all_reduce_sum` of its sums forward, one
  all-reduce of its backward's sums);
- random draws of a batch's leading shape are made at the global shape and
  sliced (`draw_local`), so the W-process run draws what the one-process
  run draws.

With no process group (or a world of one) every helper is the identity and
no collective runs.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

#: bytes of float32 gradients per all_reduce call of `average_gradients_`
GRAD_BUCKET_BYTES = 25 * 2**20


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> torch.device:
    """Join the process group and return this process's device.

    With `coordinator` ("host:port" of process 0, or an init URL such as
    "file:///shared/rdv") the group is `tcp://coordinator` (or that URL)
    with the given world size and rank; without it, `env://` from
    `torch.distributed.run`'s RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT.
    A CUDA device pins the process to `cuda:LOCAL_RANK` (LOCAL_RANK from the
    environment, else the rank: one host) over NCCL; the CPU takes gloo.
    Raises when LOCAL_RANK names no device: a run never shrinks to fewer
    GPUs than it was launched for.
    """
    device = torch.device(device)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("dist.coordinator needs dist.num_processes and dist.process_id")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank_ = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
        rank_ = int(process_id if process_id is not None else os.environ["RANK"])
    kwargs = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank_))
        count = torch.cuda.device_count()
        if local >= count:
            raise ValueError(f"initialize_distributed: LOCAL_RANK {local} but only {count} "
                             "CUDA device(s) on this host")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
        kwargs["device_id"] = device
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_,
                            **kwargs)
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_lead() -> bool:
    return rank() == 0


def _comm_device() -> torch.device:
    """Where the group's small host-side collectives run: the pinned GPU for
    NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows [r*B/W, (r+1)*B/W) of a global tensor's leading
    (batch) axis: the loader's slicing contract."""
    W = world_size()
    if W == 1:
        return x
    if x.shape[0] % W:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over {W} processes")
    n = x.shape[0] // W
    r = rank()
    return x[r * n:(r + 1) * n]


def draw_local(draw: Callable[..., torch.Tensor], shape: Sequence[int], **kwargs) -> torch.Tensor:
    """`draw(shape, **kwargs)` (torch.rand, torch.randn, ...) for a tensor
    whose leading axis is this rank's batch: drawn at the global batch and
    cut to this rank's rows, so every rank advances its generator as the
    one-process run does and gets the rows that run gives its samples."""
    W = world_size()
    if W == 1:
        return draw(tuple(shape), **kwargs)
    return local_rows(draw((shape[0] * W, *shape[1:]), **kwargs))


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the cotangents over ranks: every
    rank's loss depends on every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Autograd-aware sum of `x` over the ranks (one all_reduce forward, one
    backward). `all_reduce_sum.calls` counts the forward calls."""
    all_reduce_sum.calls += 1
    return _AllReduceSum.apply(x)


all_reduce_sum.calls = 0


def _buckets(tensors: Sequence[torch.Tensor], cap_bytes: int) -> List[List[torch.Tensor]]:
    """Consecutive groups of tensors of one dtype and device, each under
    `cap_bytes` unless one tensor alone is larger."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if (not out or size + nbytes > cap_bytes or out[-1][0].dtype != t.dtype
                or out[-1][0].device != t.device):
            out.append([])
            size = 0
        out[-1].append(t)
        size += nbytes
    return out


def _flat(bucket: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in bucket])


def _unflat_(bucket: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    offset = 0
    for t in bucket:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def gradient_buckets(params: Iterable[nn.Parameter]) -> List[List[torch.Tensor]]:
    """The gradients `average_gradients_` reduces, in its buckets."""
    return _buckets([p.grad for p in params if p.grad is not None], GRAD_BUCKET_BYTES)


@torch.no_grad()
def average_gradients_(params: Iterable[nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks: the gradients are
    flattened into buckets of GRAD_BUCKET_BYTES, one all_reduce each, then
    divided by W. The losses are plain means with equal shares per rank, so
    this mean of local gradients is the gradient of the global batch."""
    W = world_size()
    if W == 1:
        return
    for bucket in gradient_buckets(params):
        flat = _flat(bucket)
        dist.all_reduce(flat)
        _unflat_(bucket, flat.div_(W))


@torch.no_grad()
def broadcast_state_(modules: Iterable[nn.Module]) -> None:
    """Copy rank 0's parameters and buffers to every rank (after init, a
    pretrained load and a restore), so the replicas start equal."""
    if world_size() == 1:
        return
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    for bucket in _buckets(tensors, GRAD_BUCKET_BYTES):
        flat = _flat(bucket)
        dist.broadcast(flat, 0)
        _unflat_(bucket, flat)


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (float32, one all_reduce for
    all of them), each returned on its own device in its own shape."""
    W = world_size()
    if W == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(_comm_device(), torch.float32)
                      for t in tensors])
    dist.all_reduce(flat)
    flat /= W
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.device))
        offset += t.numel()
    return out


def broadcast_int(value: int) -> int:
    """Rank 0's `value` on every rank."""
    if world_size() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, 0)
    return int(t.item())
