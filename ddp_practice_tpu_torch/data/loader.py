"""Batched, sharded, deterministic data loader (a copy of the JAX-free
part of ddp_practice_tpu/data/loader.py: `DataLoader` and the numpy
gather; the same (seed, epoch) gives the same batches). The device side
of the reference's prefetch is `Trainer._device_batches` (train/loop.py):
pinned host batches copied with `non_blocking=True`, `prefetch` ahead.
The native C++ gather backend is ROADMAP A2: any backend but "auto"
raises, and "auto" is the numpy gather.

Replaces the reference's `DataLoader(num_workers=4, pin_memory=True)` +
`DistributedSampler` stack (origin_main.py:91-107, ddp_main.py:127-156).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

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


def _make_gather(backend: str, dataset: Dataset):
    """fn(indices) -> (images, labels): the numpy gather."""
    if backend != "auto":
        raise NotImplementedError(
            f"loader backend {backend!r} is not ported yet (ROADMAP A2: "
            "native_loader); 'auto' is the numpy gather")
    return lambda idx: (dataset.images[idx], dataset.labels[idx])
