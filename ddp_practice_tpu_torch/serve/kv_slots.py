"""Slot-based KV-cache pool: the memory layer of continuous batching
(counterpart of ddp_practice_tpu/serve/kv_slots.py).

The pool is the decode cache of a model (models/lm.py `init_cache`),
allocated once at `(max_slots, max_len)`; the batch dimension of every
cache tensor is a slot index. All slots share one write cursor (the
per-block `cache_index`, a host int). A request admitted while the cursor
is `cur` has its prompt prefilled at positions `[cur - w, cur)` (w = the
padded bucket width) in a batch-1 scratch cache whose rows are then
copied into the pool at the slot index; `attn_start = cur - prompt_len`
masks everything earlier. RoPE positions are relative, so the shift is
invisible. Stale K/V of a previous occupant is never visible: the copy
overwrites the slot's whole row.
"""

from __future__ import annotations

from typing import List, Optional

import torch


def _leaves(cache: dict, path=()):
    for key, value in cache.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def set_cursor(cache: dict, value: int) -> dict:
    """Set every scalar write-cursor leaf (the per-block `cache_index`,
    and `pos_index` for learned positions) to `value`, in place."""
    for key, leaf in list(cache.items()):
        if isinstance(leaf, dict):
            set_cursor(leaf, value)
        elif not isinstance(leaf, torch.Tensor):
            cache[key] = int(value)
    return cache


def read_cursor(cache: dict) -> int:
    """The shared write cursor (any scalar leaf: they advance together)."""
    for _, leaf in _leaves(cache):
        if not isinstance(leaf, torch.Tensor):
            return int(leaf)
    raise ValueError("cache has no scalar cursor leaf — not a decode cache")


def write_slot(pool: dict, scratch: dict, slot: int) -> dict:
    """Copy a batch-1 scratch cache into `pool` at row `slot`, in place.
    Scalar cursor leaves keep the pool's value: the scratch prefill ends
    exactly at the pool cursor, so admissions never move the pool clock."""
    for key, leaf in pool.items():
        if isinstance(leaf, dict):
            write_slot(leaf, scratch[key], slot)
        elif isinstance(leaf, torch.Tensor):
            leaf[slot].copy_(scratch[key][0])
    return pool


class SlotAllocator:
    """Host-side free list over the pool's slot indices. Freed slots go
    to the BACK of the list, so reuse order is deterministic."""

    def __init__(self, max_slots: int) -> None:
        if max_slots <= 0:
            raise ValueError("max_slots must be positive")
        self.max_slots = max_slots
        self._free: List[int] = list(range(max_slots))
        self._used: set = set()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop(0)
        self._used.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        self._used.remove(slot)
        self._free.append(slot)

    @property
    def num_used(self) -> int:
        return len(self._used)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def used_slots(self) -> List[int]:
        return sorted(self._used)

