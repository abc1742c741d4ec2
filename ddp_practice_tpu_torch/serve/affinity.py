"""Prefix-affinity routing: N per-replica radix caches as ONE fleet memory.

(Host-pure Python: a copy of ddp_practice_tpu/serve/affinity.py with its
imports pointed at the port's health states: the port imports nothing of
the reference package.)

The radix cache (serve/kv_pages.py) made shared-prefix prefill
cheap *per replica*; the router's least-loaded dispatch then sprayed
each prefix family across every replica, so the fleet paid K x N cache
bytes for K prefixes and the per-replica hit rate collapsed as the
fleet grew. This module closes the loop, SGLang-style (RadixAttention's
cache-aware scheduling) with the vLLM paged block as the unit of reuse:

* `DigestPublisher` — worker side. A compact fingerprint of the warm
  radix tree: one 64-bit rolling hash per cached block-aligned prefix
  (node hash extends its parent's, so a depth-d entry names the whole
  d-block prefix, not one chunk). Depth-capped, size-bounded (MRU), and
  DELTA-encoded against the last emitted frame so steady-state
  heartbeats carry a handful of ints, with a periodic full frame as the
  resync path for receivers that missed deltas. Rides the `_kv_summary`
  heartbeat payload and the poll/push frames.
* `DigestView` — receiver side. Applies frames idempotently (same
  version = no-op, base mismatch = stale-until-next-full, epoch change
  = restart detected, state dropped). A stale or cold view is simply
  unusable for scoring — it can cost a cache MISS, never correctness,
  because routing is a hint and the worker's own radix match is the
  ground truth.
* `AffinityPolicy` — the router's pluggable dispatch scorer. Hashes the
  incoming prompt's block-aligned prefixes the same way, scores every
  candidate by expected matched tokens from its digest, and dispatches
  by the blended score `affinity_tokens - load_penalty * load`, with an
  imbalance cap so a hot family can never starve a replica, rendezvous
  (HRW) placement for first-seen families (sticky across autoscaler
  grow/shrink: membership changes move only the families that hash to
  the changed replica), and clean fallback to the least-loaded order
  when digests are absent or cold.
* `LeastLoadedPolicy` — the least-loaded order behind the same seam: HEALTHY
  before DEGRADED, then least-loaded, then stable id. The control arm
  of `fleet_bench --cache-aware`, and the Router default when
  `RouterConfig.cache_aware` is off.

Everything here is host-pure (no device work), deterministic, and wire-safe:
digests are plain ints/lists in JSON frames.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ddp_practice_tpu_torch.serve.health import HealthState

# FNV-1a, 64-bit: stable across processes (unlike Python's salted
# hash()), cheap, and EXTENDABLE — hashing chunk c from parent state h
# yields the hash of the concatenated prefix, which is exactly what a
# radix path is.
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1

# digest shape bounds (wire-size control, not correctness): depth-cap
# the tree walk — past ~32 blocks the marginal prefix is this request's
# private tail, not a shared family — and MRU-bound the entry count.
DIGEST_MAX_DEPTH = 32
DIGEST_MAX_ENTRIES = 512
# a full (non-delta) frame at least every N frame() calls: the resync
# beat for receivers whose delta chain broke (missed heartbeat, late
# join). Worst-case cold time is N heartbeats, then exact again.
DIGEST_FULL_EVERY = 8

_epoch_counter = 0


def hash_extend(parent: int, chunk: Sequence[int]) -> int:
    """Roll `chunk`'s tokens into `parent`'s hash state. The radix
    invariant: hash of a depth-d node = hash_extend applied d times
    down the path, so worker (tree walk) and router (prompt walk)
    compute identical names for identical block-aligned prefixes."""
    h = parent
    for t in chunk:
        h ^= int(t) & _MASK
        h = (h * _FNV_PRIME) & _MASK
    return h


def prompt_prefix_hashes(prompt: Sequence[int], block_size: int,
                         max_depth: int = DIGEST_MAX_DEPTH) -> List[int]:
    """Rolling hashes of `prompt`'s block-aligned prefixes, shallowest
    first: out[d] names prompt[:(d+1)*block_size]. Matches what
    DigestPublisher publishes for a radix path of the same tokens."""
    out: List[int] = []
    h = _FNV_OFFSET
    bs = int(block_size)
    if bs <= 0:
        return out
    for d in range(min(max_depth, len(prompt) // bs)):
        h = hash_extend(h, prompt[d * bs:(d + 1) * bs])
        out.append(h)
    return out


def rendezvous_pick(family: int, ids: Sequence[int]) -> Optional[int]:
    """Highest-random-weight (rendezvous) choice of replica id for a
    prefix family: max over mix(family, id). Stable under membership
    churn — adding a replica moves only the families that now hash
    highest on it; removing one re-homes exactly its own families."""
    best = None
    best_w = -1
    for i in ids:
        w = hash_extend(family, (0x9E3779B9, int(i)))
        if w > best_w or (w == best_w and (best is None or i < best)):
            best, best_w = i, w
    return best


# --------------------------------------------------------------- publisher
class DigestPublisher:
    """Worker-side digest of a RadixPrefixCache, delta-encoded frames.

    `frame()` is cheap to call per heartbeat: the tree is re-walked only
    when `radix.edit_seq` moved (insert/evict structural edges), and the
    version bumps only when the bounded hash set actually changed.
    Frames are self-describing: `{"v", "epoch", "bs", "n"}` plus either
    `"full": [hashes]` or `"base", "adds", "dels"` (the delta from
    version v-1). `epoch` names this publisher incarnation — a worker
    restart starts a fresh tree AND a fresh epoch, so a receiver can
    never blend two lifetimes into one view."""

    def __init__(self, radix, *, max_depth: int = DIGEST_MAX_DEPTH,
                 max_entries: int = DIGEST_MAX_ENTRIES,
                 full_every: int = DIGEST_FULL_EVERY) -> None:
        global _epoch_counter
        _epoch_counter += 1
        self.radix = radix
        self.max_depth = max_depth
        self.max_entries = max_entries
        self.full_every = max(1, full_every)
        self.epoch = f"{os.getpid()}.{_epoch_counter}"
        self._set: frozenset = frozenset()
        self._version = 0
        self._adds: List[int] = []
        self._dels: List[int] = []
        self._last_edit: Optional[int] = None
        self._calls_since_full = 0
        self._sent_full = False

    def _build(self) -> frozenset:
        """Walk the tree (depth-capped), rolling each node's hash off
        its parent's; MRU-bound the result by LRU stamp so a huge warm
        cache publishes its HOT families, not its history."""
        radix = self.radix
        out: Dict[int, int] = {}
        root = radix._root
        stack: List[Tuple[object, int, int]] = [
            (child, _FNV_OFFSET, 1) for child in root.children.values()
        ]
        while stack:
            node, parent_h, depth = stack.pop()
            h = hash_extend(parent_h, node.tokens)
            last = out.get(h)
            if last is None or node.last_use > last:
                out[h] = node.last_use
            if depth < self.max_depth:
                for child in node.children.values():
                    stack.append((child, h, depth + 1))
        if len(out) > self.max_entries:
            keep = sorted(out.items(), key=lambda kv: -kv[1])
            out = dict(keep[:self.max_entries])
        return frozenset(out)

    def frame(self) -> dict:
        edit = getattr(self.radix, "edit_seq", None)
        if edit is None or edit != self._last_edit:
            cur = self._build()
            self._last_edit = edit
            if cur != self._set:
                self._version += 1
                self._adds = sorted(cur - self._set)
                self._dels = sorted(self._set - cur)
                self._set = cur
        base = {"v": self._version, "epoch": self.epoch,
                "bs": self.radix.block_size, "n": len(self._set)}
        self._calls_since_full += 1
        if (not self._sent_full
                or self._calls_since_full >= self.full_every):
            self._calls_since_full = 0
            self._sent_full = True
            base["full"] = sorted(self._set)
            return base
        base["base"] = self._version - 1
        base["adds"] = self._adds
        base["dels"] = self._dels
        return base


# ------------------------------------------------------------------ view
class DigestView:
    """Receiver-side digest state for ONE replica, fed by frames.

    Apply rules (in order): a None frame or epoch change resets; a
    frame at our version is a freshness touch; a full frame replaces;
    a delta whose base is our version applies; anything else marks the
    view STALE until the next full frame. Stale/cold views simply drop
    out of scoring — the documented failure mode is a cache miss."""

    def __init__(self) -> None:
        self.hashes: set = set()
        self.version: Optional[int] = None
        self.epoch: Optional[str] = None
        self.block_size: Optional[int] = None
        self.updated_at: Optional[float] = None
        self.stale = True

    def reset(self) -> None:
        self.hashes = set()
        self.version = None
        self.epoch = None
        self.block_size = None
        self.updated_at = None
        self.stale = True

    def apply(self, frame: Optional[dict], now: float) -> None:
        if not frame:
            self.reset()
            return
        epoch = frame.get("epoch")
        if epoch != self.epoch:
            # a new publisher incarnation (worker restart): the old
            # hashes describe a tree that no longer exists
            self.reset()
            self.epoch = epoch
        v = frame.get("v")
        self.block_size = frame.get("bs", self.block_size)
        if "full" in frame:
            self.hashes = set(frame["full"])
            self.version = v
            self.stale = False
            self.updated_at = now
        elif v == self.version and self.version is not None:
            self.updated_at = now  # unchanged re-emit: still fresh
        elif (self.version is not None
                and frame.get("base") == self.version):
            self.hashes.difference_update(frame.get("dels", ()))
            self.hashes.update(frame.get("adds", ()))
            self.version = v
            self.stale = False
            self.updated_at = now
        else:
            # broke the delta chain (missed frames / joined mid-stream):
            # unusable until the publisher's periodic full frame
            self.stale = True

    def usable(self, now: float, max_age_s: float) -> bool:
        return (not self.stale and self.block_size
                and self.updated_at is not None
                and now - self.updated_at <= max_age_s)

    def expected_hit_tokens(self, hashes: Sequence[int]) -> int:
        """Deepest published prefix level matched by the prompt's
        rolling hashes, in TOKENS. The walk stops at the first gap —
        radix paths are prefix-closed, so a missing level means deeper
        entries (hash collisions aside) belong to other families."""
        if not self.hashes or self.block_size is None:
            return 0
        depth = 0
        for h in hashes:
            if h not in self.hashes:
                break
            depth += 1
        return depth * self.block_size


# -------------------------------------------------------------- policies
def least_loaded_key(h):
    """The least-loaded sort key: HEALTHY before DEGRADED, then
    least-loaded, then stable id."""
    return (h.health.state is HealthState.DEGRADED, h.load, h.id)


class LeastLoadedPolicy:
    """The pre-affinity dispatch order behind the pluggable seam.
    `order()` returns (candidates in preference order, decision per
    handle id, expected-hit-tokens per handle id)."""

    def order(self, cands: list, prompt: Sequence[int],
              now: float) -> Tuple[list, Dict[int, str], Dict[int, int]]:
        ordered = sorted(cands, key=least_loaded_key)
        return ordered, {h.id: "fallback" for h in ordered}, {}

    def forget(self, replica_id: int) -> None:
        pass


class AffinityPolicy:
    """Cache-aware dispatch: blended affinity/load score over digests.

    Per candidate: expected matched tokens from its DigestView minus
    `load_penalty` tokens per unit of load. The best blended score wins
    — UNLESS its load exceeds the fleet minimum by more than
    `imbalance_cap` requests, in which case load wins outright (a hot
    family can never starve a replica). First-seen families (digests
    warm, prompt unknown) go to their rendezvous home so the cache
    warms where future traffic will land. No usable digest anywhere =
    the least-loaded order, byte-for-byte."""

    def __init__(self, *, load_penalty: float = 32.0,
                 imbalance_cap: float = 4.0,
                 max_age_s: float = 10.0,
                 max_depth: int = DIGEST_MAX_DEPTH) -> None:
        self.load_penalty = load_penalty
        self.imbalance_cap = imbalance_cap
        self.max_age_s = max_age_s
        self.max_depth = max_depth
        self.views: Dict[int, DigestView] = {}

    def forget(self, replica_id: int) -> None:
        """Invalidate one replica's digest (router kill / restart /
        retirement): its next full frame rebuilds the view; until then
        it scores 0 — a miss at worst, never a wrong answer."""
        self.views.pop(replica_id, None)

    def order(self, cands: list, prompt: Sequence[int],
              now: float) -> Tuple[list, Dict[int, str], Dict[int, int]]:
        fallback = sorted(cands, key=least_loaded_key)
        usable: Dict[int, DigestView] = {}
        for h in cands:
            kv = getattr(h, "kv_summary", None)
            frame = kv.get("digest") if isinstance(kv, dict) else None
            view = self.views.setdefault(h.id, DigestView())
            view.apply(frame, now)
            if view.usable(now, self.max_age_s):
                usable[h.id] = view
        if not usable:
            # digests absent or cold everywhere: exactly the old order
            return fallback, {h.id: "fallback" for h in cands}, {}
        # per-candidate expected hit, hashing the prompt once per
        # distinct block size (fleets are homogeneous in practice)
        hashes_by_bs: Dict[int, List[int]] = {}
        exp: Dict[int, int] = {}
        for h in cands:
            view = usable.get(h.id)
            if view is None:
                exp[h.id] = 0
                continue
            bs = int(view.block_size)
            if bs not in hashes_by_bs:
                hashes_by_bs[bs] = prompt_prefix_hashes(
                    prompt, bs, self.max_depth)
            exp[h.id] = view.expected_hit_tokens(hashes_by_bs[bs])
        loads = {h.id: h.load for h in cands}
        min_load = min(loads.values())
        # DEGRADED replicas keep their back-of-the-line seat: score
        # only the healthy pool unless nothing healthy remains
        pool = [h for h in cands
                if h.health.state is not HealthState.DEGRADED] or cands
        winner = max(pool, key=lambda h: (
            exp[h.id] - self.load_penalty * loads[h.id],
            -loads[h.id], -h.id,
        ))
        decision = "affinity"
        if exp[winner.id] <= 0:
            # nobody has this family warm: sticky rendezvous placement
            # so repeats land where THIS one warms the cache
            any_bs = next(iter(hashes_by_bs), None)
            family_hashes = hashes_by_bs.get(any_bs, [])
            if not family_hashes:
                # prompt shorter than one block: nothing to be sticky
                # about, and nothing to cache — load decides
                return fallback, {h.id: "load" for h in cands}, exp
            home = rendezvous_pick(family_hashes[0],
                                   sorted(h.id for h in pool))
            winner = next(h for h in pool if h.id == home)
        if loads[winner.id] - min_load > self.imbalance_cap:
            # the imbalance cap: a warm-but-swamped replica loses to
            # the least-loaded order (the family re-warms elsewhere)
            return fallback, {h.id: "load" for h in cands}, exp
        decisions = {h.id: "load" for h in cands}
        decisions[winner.id] = decision
        ordered = [winner] + [h for h in fallback if h is not winner]
        return ordered, decisions, exp


# ------------------------------------------------------------ kv summary
def kv_summary(engine, publisher: Optional[DigestPublisher] = None) -> dict:
    """The KV/radix occupancy dict riding every heartbeat (and, via the
    in-process handle, every dispatch): blocks in use/shared, hit/miss
    token counters, and — when a publisher is attached — the prefix
    digest frame cache-aware routing scores against. ONE builder for
    the worker and the in-process handle, so the Router sees identical
    shapes on both sides of the RPC seam. Zeros for a slot engine (no
    paged pool), matching ServeMetrics.on_tick's getattr guards."""
    blocks = getattr(engine, "blocks", None)
    radix = getattr(engine, "radix", None)
    hit = getattr(radix, "hit_tokens", 0) if radix is not None else 0
    miss = getattr(radix, "miss_tokens", 0) if radix is not None else 0
    out = {
        "blocks_used": blocks.num_used if blocks is not None else 0,
        "blocks_shared": blocks.num_shared if blocks is not None else 0,
        # minus the garbage block, same accounting as the gauges
        "blocks_total": (blocks.num_blocks - 1
                         if blocks is not None else 0),
        "evictable": radix.evictable() if radix is not None else 0,
        "hit_tokens": hit,
        "miss_tokens": miss,
        "prefix_hit_rate": hit / (hit + miss) if hit + miss else 0.0,
    }
    if radix is not None:
        out["block_size"] = radix.block_size
        if publisher is not None:
            out["digest"] = publisher.frame()
    return out
