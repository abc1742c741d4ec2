"""Batched, sharded, deterministic data loader (a copy of the JAX-free
part of ddp_practice_tpu/data/loader.py: `DataLoader` and the numpy
gather; the same (seed, epoch) gives the same batches). The device side
of the reference's prefetch is `Trainer._device_batches` (train/loop.py):
pinned host batches copied with `non_blocking=True`, `prefetch` ahead;
`prefetch_chunked` is its K-steps-a-call form (one copy a chunk).
The batch gather is the reference's choice of backend: "native" (the C++
gather, data/native_loader.py; raises when it cannot be built or
loaded), "python" (numpy fancy indexing) or "auto" (native where it
builds, else numpy: the two give the same bytes).

Replaces the reference's `DataLoader(num_workers=4, pin_memory=True)` +
`DistributedSampler` stack (origin_main.py:91-107, ddp_main.py:127-156).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, Optional

import numpy as np

from ddp_practice_tpu_torch.data import native_loader
from ddp_practice_tpu_torch.data.datasets import Dataset
from ddp_practice_tpu_torch.data.sharding import ShardSpec, epoch_indices, pad_to_multiple


class DataLoader:
    """Iterates dicts of numpy arrays: image, label, weight.

    One instance per process; each process sees only its slice of every
    global batch. `set_epoch` mirrors the reference's reshuffle contract
    (ddp_main.py:160).
    """

    def __init__(
        self,
        dataset: Dataset,
        *,
        global_batch_size: int,
        shard: Optional[ShardSpec] = None,
        seed: int = 3407,
        shuffle: bool = True,
        drop_last: bool = False,
        backend: str = "auto",
    ):
        self.dataset = dataset
        self.global_batch_size = int(global_batch_size)
        self.shard = shard or ShardSpec()
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self._gather = _make_gather(backend, dataset)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    @property
    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return -(-n // self.global_batch_size)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def epoch_plan(self) -> tuple:
        """The epoch's GLOBAL batch plan as (indices, weights) grids of
        shape (steps, global_batch) — the exact order __iter__ walks, before
        per-process slicing. Device-resident training feeds these grids
        straight to make_resident_train_step/make_resident_eval_step: the
        sampler semantics (seed/epoch permutation, wrap-padding with zero
        eval weights) stay in this one place."""
        order, weights = self._epoch_order()
        b = self.global_batch_size
        return (
            order.reshape(-1, b).astype(np.int32),
            weights.reshape(-1, b),
        )

    def _epoch_order(self) -> tuple:
        n = len(self.dataset)
        order = epoch_indices(n, seed=self.seed, epoch=self._epoch, shuffle=self.shuffle)
        if self.drop_last:
            usable = (n // self.global_batch_size) * self.global_batch_size
            return order[:usable], np.ones(usable, dtype=np.float32)
        return pad_to_multiple(order, self.global_batch_size)

    def __iter__(self) -> Iterator[dict]:
        order, weights = self._epoch_order()
        sl = self.shard.local_slice(self.global_batch_size)
        for start in range(0, len(order), self.global_batch_size):
            gidx = order[start : start + self.global_batch_size]
            gw = weights[start : start + self.global_batch_size]
            lidx, lw = gidx[sl], gw[sl]
            images, labels = self._gather(lidx)
            yield {"image": images, "label": labels, "weight": lw}


def prefetch_chunked(iterator, num_steps: int, to_device: Callable, *,
                     size: int = 2):
    """Prefetch for K-steps-a-call training (train/steps.py
    `make_chunked_train_step`), the counterpart of the reference's
    data/loader.py:202: groups of `num_steps` host batches are stacked
    on a leading axis and sent to the device as ONE copy a leaf, `size`
    items ahead (`to_device`: a host dict to a device dict, e.g. pinned
    and non-blocking). The epoch's tail that does not fill a group comes
    as single batches. Yields ("chunk", stacked) and ("single", batch)."""

    def host_items():
        buf = []
        for batch in iterator:
            buf.append(batch)
            if len(buf) == num_steps:
                yield "chunk", {k: np.stack([b[k] for b in buf])
                                for k in buf[0]}
                buf = []
        for batch in buf:
            yield "single", batch

    staged = collections.deque()
    for tag, batch in host_items():
        staged.append((tag, to_device(batch)))
        if len(staged) > max(size, 1):
            yield staged.popleft()
    while staged:
        yield staged.popleft()


def _make_gather(backend: str, dataset: Dataset):
    """fn(indices) -> (images, labels) of `backend` (auto | native |
    python)."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown loader backend {backend!r} (auto | "
                         "native | python)")
    if backend == "native":
        return native_loader.NativeGather(native_loader.require(), dataset)
    if backend == "auto":
        gather = native_loader.make_gather(dataset)
        if gather is not None:
            return gather
    return lambda idx: (dataset.images[idx], dataset.labels[idx])
