"""Deterministic epoch shuffling and per-process sharding (a copy of
ddp_practice_tpu/data/sharding.py: the port imports nothing of the JAX
package, and the same (seed, epoch) must give the same indices).

Reproduces the reference's `DistributedSampler` + `set_epoch` semantics
(ddp_main.py:130-142,160) a single global permutation keyed on
(seed, epoch) — so every process agrees on the epoch's order without
communication — then a strided per-process shard. Where the reference's
sampler silently pads eval shards with duplicates (double-counted in its
reduced accuracy, SURVEY §2.5), we carry an explicit per-sample weight so
padded entries contribute zero to eval counts: eval is exact here.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def epoch_indices(n: int, *, seed: int, epoch: int, shuffle: bool = True) -> np.ndarray:
    """Global sample order for one epoch, identical on every process.

    Keyed on (seed, epoch) like the reference's `sampler.set_epoch(epoch)`
    reshuffle (ddp_main.py:160).
    """
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    return rng.permutation(n).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Which contiguous slice of each global batch this process owns.

    The reference shards with rank-strided indices (DistributedSampler);
    here each process owns a *contiguous* slice of every global batch (the
    reference's contract, kept so both packages give a rank the same
    rows). Sample→process assignment
    differs from the reference, but the distributional contract (disjoint
    shards, union = dataset, reshuffled per epoch) is identical.
    """

    process_index: int = 0
    num_processes: int = 1

    def __post_init__(self):
        if not 0 <= self.process_index < self.num_processes:
            raise ValueError(
                f"process_index {self.process_index} outside "
                f"[0, {self.num_processes})")

    def local_slice(self, global_batch: int) -> slice:
        if global_batch % self.num_processes != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{self.num_processes} processes"
            )
        per = global_batch // self.num_processes
        return slice(self.process_index * per, (self.process_index + 1) * per)


def pad_to_multiple(indices: np.ndarray, multiple: int) -> tuple:
    """Pad index array (wrapping, like DistributedSampler) to a multiple.

    Returns (padded_indices, weights) where weights are 1.0 for real samples
    and 0.0 for padding — used by eval to stay exact where the reference
    double-counts (SURVEY §2.5).
    """
    n = len(indices)
    remainder = n % multiple
    if remainder == 0:
        return indices, np.ones(n, dtype=np.float32)
    pad = multiple - remainder
    reps = int(np.ceil(pad / max(n, 1)))
    padded = np.concatenate([indices, np.tile(indices, reps)[:pad]])
    weights = np.concatenate(
        [np.ones(n, dtype=np.float32), np.zeros(pad, dtype=np.float32)]
    )
    return padded, weights
