"""Several processes, one device each: the port's counterpart of
`jax.distributed.initialize`, `jax.process_index` and `jax.process_count` as
the repository's `train.py` and `eval/offline.py` use them.

The processes are started by `torchrun`, which sets `RANK`, `WORLD_SIZE`,
`LOCAL_RANK` (and `LOCAL_WORLD_SIZE`, the processes of this host) and the
rendezvous address. `init` joins them into one process group: NCCL on CUDA,
one card per process (`cuda:LOCAL_RANK`), gloo on the CPU. A caller that
has set up the default process group itself (the CPU tests, with a file
store) keeps it.

Without a process group every helper here is the one-process case and makes
no collective: `rank()` 0, `world()` 1, `all_reduce_sum` the identity.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
TIMEOUT = datetime.timedelta(minutes=10)


def init(device_type: str) -> torch.device:
    """Join the process group `torchrun` describes; returns this rank's
    device. Exits with a message when the environment is not torchrun's or,
    on CUDA, asks for more processes on this host than it has cards."""
    if not dist.is_initialized():
        missing = [k for k in ENV if k not in os.environ]
        if missing:
            raise SystemExit(
                f"--distributed needs the environment torchrun sets ({', '.join(missing)} "
                f"missing): launch with `torchrun --nproc_per_node=N -m ...`")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device_type == "cuda":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", 1)))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise SystemExit(f"--distributed: {local_world} processes on this "
                             f"host but {cards} CUDA cards visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                timeout=TIMEOUT,
                                device_id=device if device.type == "cuda" else None)
    return device


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def _summed(t: torch.Tensor) -> torch.Tensor:
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """out = sum over ranks of t; d t = sum over ranks of d out (each
    rank's output feeds its own loss, and all of them depend on every
    rank's t)."""

    @staticmethod
    def forward(ctx, t):
        return _summed(t)

    @staticmethod
    def backward(ctx, g):
        return _summed(g)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable; `t` itself in a world
    of one."""
    if world() == 1:
        return t
    return _AllReduceSum.apply(t)


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    if world() == 1:
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj)
    return out
