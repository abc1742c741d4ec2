"""Process-group set-up (counterpart of ddp_practice_tpu/parallel/dist.py).

The reference rendezvouses hosts through its framework's distributed
runtime; the port follows torchrun's environment contract (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, with `MASTER_ADDR`/`MASTER_PORT` for the `env://` store), or
takes an explicit `init_method` (`tcp://host:port`, `file://path`) with a
rank and world size. NCCL joins CUDA ranks, gloo CPU ranks. World size 1
needs no process group: `initialize` then does nothing, exactly like
running without DDP.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as tdist


def initialize(device: torch.device, *, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the process group when the world has more than one rank;
    idempotent. Arguments override the torchrun environment."""
    if tdist.is_initialized():
        return
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if device.type == "cuda":
        torch.cuda.set_device(local_rank(rank))
    tdist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=init_method or "env://", world_size=world, rank=rank)


def local_rank(rank: int = 0) -> int:
    """The card this rank drives: torchrun's `LOCAL_RANK`, else (an
    explicit rendezvous, ranks numbered host by host) `rank` modulo the
    cards this host has, so ranks sharing a host never share a card."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def threaded() -> bool:
    """Whether the world's ranks are threads of this process
    (parallel/threads.py `run_ranks`)."""
    return tdist.is_initialized() and tdist.get_backend() == "threaded"


def host_processes() -> int:
    """The processes the world spans: 1 for ranks as threads of one
    process (the whole corpus is addressable there, as in the
    reference's single process driving several devices), else the world
    size."""
    return 1 if threaded() else process_count()


def is_main_process() -> bool:
    """The rank-0 gate for side effects (prints, files)."""
    return process_index() == 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """In-place SUM over every rank (a no-op on one)."""
    if process_count() > 1:
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return t


def shutdown() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()
