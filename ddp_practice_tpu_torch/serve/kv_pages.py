"""Paged KV-cache pool: block-granular memory for continuous batching
(counterpart of ddp_practice_tpu/serve/kv_pages.py).

- The pool is a decode cache whose batch dimension is a BLOCK index:
  every `cached_key`/`cached_value` leaf is `(num_blocks, block_size,
  h*hd)`, and an int8 cache model pools its per-(head, position) fp32
  scales as `(num_blocks, h, block_size)` scale pages. Leaf names are the
  flat cache's, so `decode_apply` threads the pool unchanged.
- Each slot owns a host-side page-table row: position `p` of a slot lives
  in pool block `page_table[slot, p // block_size]` at row
  `p % block_size`. Positions are slot-local, starting at 0: there is no
  shared clock, so nothing drains and nothing rewinds.
- Blocks are refcounted (`BlockAllocator`): a block may be held by several
  slots (shared prompt prefix, fork siblings) and by the radix prefix
  cache; `free` is a deref. A slot about to write into a shared block
  first copies it into a private one (`copy_block`, the copy-on-write
  primitive).
- `RadixPrefixCache` maps FULL prompt blocks at canonical slot-local
  positions to pool blocks; admission re-uses matched blocks outright and
  prefills only the suffix. Sharing needs canonical positions, so the
  prefix-cache admission path right-pads (attn_start 0).
- Block 0 is the GARBAGE block: never allocated, never refcounted, never
  shared. Retired slots' page-table rows point at it, so the batched
  decode step can write for every batch row without a freed slot ever
  touching a live request's pages.

The allocator and the radix tree are host-pure copies of the reference's.
The device helpers update the pool tensors IN PLACE (the pool is the
whole serving memory; a functional copy per admission would double it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ddp_practice_tpu_torch.inference import make_cache

# pool block index reserved as the write target of retired slots; the
# allocator never hands it out, refcounts it, or copies into it
GARBAGE_BLOCK = 0


class BlockAllocator:
    """Host-side refcounted free list over the pool's block indices.

    Freed blocks go to the BACK of the free list, so allocation order is
    deterministic. `alloc(n)` is all-or-nothing. `alloc` hands blocks out
    at refcount 1, `ref` adds a holder, `free` drops one; a block returns
    to the free list only when its last holder lets go. Block 0
    (GARBAGE_BLOCK) is outside the economy: alloc never returns it and
    ref/free refuse it."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks <= 1:
            raise ValueError(
                f"need at least 2 blocks (block {GARBAGE_BLOCK} is the "
                f"garbage block), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(1, num_blocks))
        self._refs: Dict[int, int] = {}
        # refcount-transition hook, called as on_refcount(block, count)
        # after every ref/free: the radix cache keeps its evictable count
        # O(1) through it
        self.on_refcount = None

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """n blocks at refcount 1, or None if fewer than n are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = self._free[:n]
        del self._free[:n]
        for b in blocks:
            assert b != GARBAGE_BLOCK, "garbage block leaked into free list"
            self._refs[b] = 1
        return blocks

    def ref(self, blocks: Sequence[int]) -> None:
        """Add one holder to each block (prefix-cache hit, fork)."""
        for b in blocks:
            if b == GARBAGE_BLOCK:
                raise ValueError(
                    f"block {GARBAGE_BLOCK} is the garbage block — it can "
                    f"never be shared or refcounted"
                )
            if b not in self._refs:
                raise ValueError(f"block {b} is not allocated")
            self._refs[b] += 1
            if self.on_refcount is not None:
                self.on_refcount(b, self._refs[b])

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one holder per block; a block with no holders left
        returns to the BACK of the free list."""
        for b in blocks:
            if b == GARBAGE_BLOCK:
                raise ValueError(
                    f"block {GARBAGE_BLOCK} is the garbage block — retired "
                    f"page-table rows point at it, it is never allocated "
                    f"or freed"
                )
            if b not in self._refs:
                raise ValueError(f"block {b} is not allocated")
            self._refs[b] -= 1
            count = self._refs[b]
            if count == 0:
                del self._refs[b]
                self._free.append(b)
            if self.on_refcount is not None:
                self.on_refcount(b, count)

    def refcount(self, block: int) -> int:
        """Current holder count (0 = free; the garbage block reads 0)."""
        return self._refs.get(block, 0)

    @property
    def num_used(self) -> int:
        return len(self._refs)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_shared(self) -> int:
        """Blocks held by more than one holder."""
        return sum(1 for c in self._refs.values() if c > 1)


class _RadixNode:
    """One full block of the radix tree: `tokens` is the block_size-token
    edge label, `block` the pool block holding those positions' K/V."""

    __slots__ = ("tokens", "block", "children", "parent", "last_use")

    def __init__(self, tokens: Tuple[int, ...], block: int, parent) -> None:
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent = parent
        self.last_use = 0


class RadixPrefixCache:
    """Block-granular radix tree mapping prompt prefixes to pool blocks.

    Depth-i nodes hold slot-local positions [i*block_size, (i+1)*bs) of a
    previously served prompt; only FULL blocks are cached. The tree holds
    one allocator reference per node, so cached blocks survive their
    request's release; `evict` drops LRU leaves whose blocks have no other
    holder, leaf first, so nothing a slot still attends through is ever
    reclaimed."""

    def __init__(self, allocator: BlockAllocator, block_size: int) -> None:
        self.allocator = allocator
        self.block_size = block_size
        self._root = _RadixNode((), GARBAGE_BLOCK, None)
        self._clock = 0          # LRU tick, bumped per touch
        self._nodes = 0
        self.hit_tokens = 0      # cumulative matched / recomputed tokens
        self.miss_tokens = 0
        self.edit_seq = 0        # structural-change counter
        # block -> its LEAF node, and the leaves whose block only the tree
        # holds (refcount 1): evictable() is their count
        self._leaf_index: Dict[int, _RadixNode] = {}
        self._evictable: set = set()
        allocator.on_refcount = self._on_refcount

    def __len__(self) -> int:
        return self._nodes

    # ------------------------------------------ evictable bookkeeping
    def _on_refcount(self, block: int, count: int) -> None:
        if block in self._leaf_index:
            if count == 1:
                self._evictable.add(block)
            else:
                self._evictable.discard(block)

    def _leaf_gained(self, node: "_RadixNode") -> None:
        if node is self._root:
            return
        self._leaf_index[node.block] = node
        if self.allocator.refcount(node.block) == 1:
            self._evictable.add(node.block)

    def _leaf_lost(self, node: "_RadixNode") -> None:
        self._leaf_index.pop(node.block, None)
        self._evictable.discard(node.block)

    def _chunks(self, tokens: Sequence[int]):
        bs = self.block_size
        for i in range(len(tokens) // bs):
            yield tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def _walk(self, tokens: Sequence[int]) -> list:
        """Nodes along the longest cached block-chunk prefix, in order
        (no side effects)."""
        node = self._root
        out: list = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            node = child
            out.append(node)
        return out

    def _clamp_full(self, items: list, tokens: Sequence[int]) -> list:
        """Drop trailing matched items until at least ONE token is left to
        prefill (admission must produce the last prompt token's logits).
        Shared by `match`, `peek` and `ref_prefix` so the gate, the
        admission and the room-making pin agree on the matched length."""
        while items and len(items) * self.block_size >= len(tokens):
            items.pop()
        return items

    def peek(self, tokens: Sequence[int]) -> int:
        """Read-only longest cached prefix in TOKENS (no LRU stamp, no
        refs, no hit/miss accounting): the admission gate's probe."""
        clamped = self._clamp_full(self._walk(tokens), tokens)
        return len(clamped) * self.block_size

    def ref_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Pin the cached prefix chain of `tokens` (refs every matched
        block, no LRU stamp, no accounting) and return it; the caller
        must `allocator.free()` the list to drop the pins."""
        blocks = self._clamp_full(
            [n.block for n in self._walk(tokens)], tokens)
        self.allocator.ref(blocks)
        return blocks

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens`: (blocks, matched_tokens).
        Leaves at least one token uncached; the caller owns a reference
        on each returned block."""
        self._clock += 1
        nodes = self._walk(tokens)
        blocks: List[int] = []
        for node in nodes:
            node.last_use = self._clock
            blocks.append(node.block)
        blocks = self._clamp_full(blocks, tokens)
        matched = len(blocks) * self.block_size
        self.allocator.ref(blocks)
        self.hit_tokens += matched
        self.miss_tokens += len(tokens) - matched
        return blocks, matched

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Cache `tokens`' full blocks, where `blocks[i]` holds positions
        [i*bs, (i+1)*bs). Chunks already present keep their existing
        block; new nodes take one tree reference on the caller's block.
        Returns the number of nodes added."""
        self._clock += 1
        node = self._root
        added = 0
        for i, chunk in enumerate(self._chunks(tokens)):
            child = node.children.get(chunk)
            if child is None:
                b = int(blocks[i])
                if b == GARBAGE_BLOCK:
                    raise ValueError(
                        "garbage block can never enter the prefix cache"
                    )
                self.allocator.ref([b])
                if not node.children:
                    self._leaf_lost(node)  # interior now, not evictable
                child = _RadixNode(chunk, b, node)
                node.children[chunk] = child
                self._nodes += 1
                added += 1
                self._leaf_gained(child)
            child.last_use = self._clock
            node = child
        if added:
            self.edit_seq += 1
        return added

    def evictable(self) -> int:
        """Blocks `evict` could free right now (O(1))."""
        return len(self._evictable)

    def _evictable_walk(self) -> int:
        """The full-tree definition of `evictable()` — the oracle the
        incremental counter is tested against."""
        return sum(
            1 for n in self._iter_nodes()
            if not n.children and self.allocator.refcount(n.block) == 1
        )

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def evict(self, n_blocks: int) -> int:
        """Drop up to `n_blocks` LRU unreferenced LEAF nodes (repeatedly:
        an evicted leaf may expose its parent). Returns blocks freed."""
        freed = 0
        while freed < n_blocks and self._evictable:
            victims = sorted(
                (self._leaf_index[b] for b in self._evictable),
                key=lambda n: n.last_use,
            )
            for v in victims:
                if freed >= n_blocks:
                    break
                del v.parent.children[v.tokens]
                self._leaf_lost(v)
                if not v.parent.children:
                    self._leaf_gained(v.parent)
                self.allocator.free([v.block])
                self._nodes -= 1
                freed += 1
        if freed:
            self.edit_seq += 1
        return freed

    def clear(self) -> int:
        """Evict everything evictable; returns blocks freed."""
        return self.evict(self._nodes)


# ------------------------------------------------------------------ device
def _pool_leaves(cache: dict, path=()):
    """(path, tensor) for every tensor leaf of a cache tree; the scalar
    cursor leaves (`cache_index`) are skipped."""
    for key, value in cache.items():
        if isinstance(value, dict):
            yield from _pool_leaves(value, path + (key,))
        elif isinstance(value, torch.Tensor):
            yield path + (key,), value


def _lookup(cache: dict, path):
    for key in path:
        cache = cache[key]
    return cache


def _is_scale_leaf(path) -> bool:
    """Scale pages ((nb, h, bs), positions on axis 2) vs K/V leaves
    ((nb, bs, h*hd), positions on axis 1), told apart by NAME
    (`cached_key_scale` / `cached_value_scale`)."""
    return "scale" in path[-1]


def make_paged_cache(model, num_blocks: int, block_size: int,
                     device=None) -> dict:
    """Block-pool cache for `model`: the flat cache's tree and leaf names
    with the batch dimension read as the block index — K/V leaves
    `(num_blocks, block_size, h*hd)`, int8 scale pages `(num_blocks, h,
    block_size)`. The scalar cursor leaves stay for tree parity; the
    paged path never advances them."""
    return make_cache(model, num_blocks, block_size, device)


def scatter_prompt_blocks(pool: dict, scratch: dict, block_ids,
                          width: int, block_size: int) -> dict:
    """Scatter a batch-1 contiguous scratch cache into pool blocks, in
    place. `scratch` holds a prefilled prompt at positions [0, width);
    chunk i lands in pool block `block_ids[i]`, and a trailing partial
    chunk writes only its real rows. Scale pages chunk along their
    position axis (2). One indexed write per leaf."""
    leaves = list(_pool_leaves(pool))
    device = leaves[0][1].device
    pos = torch.arange(width)
    blk = torch.as_tensor(list(block_ids), dtype=torch.long)[
        pos // block_size].to(device)
    off = (pos % block_size).to(device)
    for path, p in leaves:
        s = _lookup(scratch, path)
        if _is_scale_leaf(path):
            # advanced indices on axes 0 and 2: the written value is
            # (width, h), positions first
            p[blk, :, off] = s[0, :, :width].transpose(0, 1).to(p.dtype)
        else:
            p[blk, off] = s[0, :width].to(p.dtype)
    return pool


def rewind_block_tail(blocks: BlockAllocator, table_row, nblk: int,
                      floor: int) -> int:
    """Return a page-table row's tail blocks [floor, nblk) to the pool and
    point those entries back at the garbage block — the block half of a
    length rewind (speculative verify's rejected tail, a chunked prefill's
    last chunk). Returns the new block count."""
    if nblk <= floor:
        return nblk
    tail = [int(b) for b in table_row[floor:nblk]]
    assert GARBAGE_BLOCK not in tail, "garbage block in a live tail"
    blocks.free(tail)
    table_row[floor:nblk] = GARBAGE_BLOCK
    return floor


def copy_block(pool: dict, src: int, dst: int) -> dict:
    """Copy pool block `src` into `dst` in every tensor leaf, in place —
    the copy-on-write primitive. Copying from or into the garbage block
    is a caller bug; the engine asserts it on the host first."""
    for _, p in _pool_leaves(pool):
        p[dst].copy_(p[src])
    return pool
