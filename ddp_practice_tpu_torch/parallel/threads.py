"""Ranks as threads of one process, over torch's threaded process group.

Several ranks cannot share one card over NCCL (it refuses a duplicate
GPU), so a run that holds one card, and the CPU tests, run a sharded
world as threads: `run_ranks(fn, world)` starts `world` threads, each
joins a "threaded" process group (torch's in-process backend: a
collective is a copy between the threads' tensors, done by rank 0's
thread) and calls `fn(rank)`. Everything above the process group (the
mesh, the tensor-parallel collectives, DDP, FSDP2, the sharded
checkpoint) runs unchanged, as under torchrun.

What the threaded group needs:

- thread isolation (`_set_thread_isolation_mode`): each thread keeps its
  own default group; without it the ranks share one and hang;
- autograd without its device threads (`_install_threaded_pg` turns them
  off), so each rank's backward, and the collectives in it, run on the
  rank's own thread;
- on the cards, a fence of every visible card around each collective
  (`_fenced_work`): rank 0's thread copies every rank's tensors on its
  own current stream while the other ranks may have queued their inputs
  on theirs (FSDP2 gathers on a stream of its own), so the copies wait
  for all queued work and finish before any rank reads them.

A rank that raises wakes the others (`ProcessLocalGroup.exception_handle`:
they leave their collectives), every thread is joined under `timeout`
seconds, and the process leaves the threaded world before the error (or
the timeout) is raised, so a later caller in the process sees the
default world again.
"""

from __future__ import annotations

import datetime
import sys
import threading
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as tdist

_FENCED: set = set()


def _fence() -> None:
    """Wait for every visible card's queued work (ranks may hold
    different cards: `--devices N`)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _fenced_work(work):
    def run(self, data):
        _fence()
        work(self, data)
        _fence()
    return run


def _fence_collectives(module) -> None:
    """Wrap every collective's `work` of the threaded group in the
    device fence (once per process)."""
    for name in dir(module):
        cls = getattr(module, name)
        if (isinstance(cls, type) and "work" in vars(cls)
                and cls not in _FENCED):
            cls.work = _fenced_work(cls.work)
            _FENCED.add(cls)


def run_ranks(fn: Callable[[int], object], world: int, *,
              timeout: Optional[float] = 300.0) -> List[object]:
    """[fn(0), ..., fn(world - 1)], each on its own thread inside a
    threaded process group of `world` ranks. Raises the first rank's
    error, or TimeoutError when a rank has not finished in `timeout`
    seconds (None: no deadline, as a training run through the CLI)."""
    from torch.testing._internal.distributed import multi_threaded_pg as mt

    _fence_collectives(mt)
    results: list = [None] * world
    errors: list = []
    # init_process_group wraps sys.excepthook to prefix each rank: put
    # the process's own back afterwards
    hook = sys.excepthook
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    mt._install_threaded_pg()
    store = tdist.HashStore()

    def worker(rank: int) -> None:
        tdist.init_process_group(
            "threaded", rank=rank, world_size=world, store=store,
            timeout=datetime.timedelta(seconds=timeout or 86400 * 365))
        try:
            results[rank] = fn(rank)
        except BaseException as exc:        # surfaced after the join
            errors.append((rank, exc, sys.exc_info()[2]))
            mt.ProcessLocalGroup.exception_handle(exc)
        finally:
            try:
                if tdist.is_initialized():
                    tdist.destroy_process_group()
            except AttributeError:
                # torch 2.11's thread-local world lacks the `comms` list
                # its destroy_process_group walks; the world is the
                # thread's own and goes with it
                pass

    threads = [threading.Thread(target=worker, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(world)]
    try:
        for t in threads:
            t.start()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        stuck = [t.name for t in threads if t.is_alive()]
        if stuck:
            mt.ProcessLocalGroup.exception_handle(TimeoutError())
            for t in threads:
                t.join(5.0)
    finally:
        mt.ProcessLocalGroup.reset()
        mt._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        sys.excepthook = hook
    real = [e for e in errors if not isinstance(e[1], SystemExit)]
    if real:
        rank, exc, tb = min(real, key=lambda e: e[0])
        raise RuntimeError(f"rank {rank} failed: {exc!r}").with_traceback(
            tb) from exc
    if stuck:
        raise TimeoutError(f"ranks {stuck} did not finish in {timeout} s")
    if errors:
        raise RuntimeError(f"ranks left their collectives: {errors}")
    return results
