"""Continuous-batching engine core (counterpart of
ddp_practice_tpu/serve/engine.py: `EngineConfig`, `_sample_step`,
`warm_engine`, `_EngineBase`, `SlotEngine` and `PagedEngine`).

Two engines share one interface (`admit_gate` / `admit` / `step_burst` /
`release` / `compile_stats`), and the scheduler drives either:

- `SlotEngine`, over the shared-cursor slot pool (serve/kv_slots.py):
  `admit` runs a request's prompt, LEFT-padded to a bucket width, through
  a batch-1 scratch cache positioned to end at the pool cursor, then
  copies the scratch rows and the next-token logits into the pool at the
  slot;
- `PagedEngine`, over the paged block pool (serve/kv_pages.py): per-slot
  page tables and slot-local positions, prefix sharing, copy-on-write,
  block-aware preemption, chunked prefill and speculative decoding.

`step_burst` runs `decode_burst` single-token steps over every slot:
sample one token per slot from the carried logits, apply the model at
s=1, carry the new logits. Free slots ride along emitting pad tokens. The
host reads the burst's tokens back once, at its end.

Greedy decode is token-identical to the one-shot generator
(inference.make_generate_fn): both run the same `decode_apply`. Sampling
is per slot: each slot carries its own `torch.Generator`, seeded from the
request's seed at admission, so a request's tokens do not depend on what
else shares the batch.

The reference's XLA workarounds (`_await_dispatch`, `_decode_donate`)
have no counterpart: PyTorch runs eagerly on one stream and the pools are
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ddp_practice_tpu_torch.inference import (
    decode_apply,
    make_cache,
    sample_logits,
    sample_logits_batch,
)
from ddp_practice_tpu_torch.serve.kv_pages import (
    GARBAGE_BLOCK,
    BlockAllocator,
    RadixPrefixCache,
    copy_block,
    make_paged_cache,
    rewind_block_tail,
    scatter_prompt_blocks,
)
from ddp_practice_tpu_torch.serve.kv_slots import (
    SlotAllocator,
    set_cursor,
    write_slot,
)
from ddp_practice_tpu_torch.serve.spec import DraftSource, PromptLookupDraft
from ddp_practice_tpu_torch.utils.trace import (
    ENGINE_LANE,
    NULL_SPAN as _NULL,
    SLOT_LANE_BASE,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving knobs; field for field the reference's EngineConfig."""

    max_slots: int = 4
    # pool positions per slot; 0 = the model's max_len
    max_len: int = 0
    # LEFT-pad prompt widths; the largest bucket is also the base cursor
    prompt_buckets: Tuple[int, ...] = (8, 16, 32, 64)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: Optional[int] = None
    pad_id: int = 0
    # decode steps per dispatch (multi-step scheduling); 1 = exact
    # token-granular scheduling
    decode_burst: int = 1
    # ---- PagedEngine knobs (ignored by SlotEngine) ----
    block_size: int = 16
    num_blocks: int = 0
    max_blocks_per_slot: int = 0
    prefix_cache: bool = False
    # ---- speculative decoding (PagedEngine only, greedy only) ----
    spec_decode: bool = False
    spec_k: int = 4
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # ---- per-slot sampling: (temperature, top_k, top_p) per slot ----
    per_slot_sampling: bool = False
    # ---- chunked prefill (PagedEngine + prefix_cache only) ----
    prefill_chunk: int = 0


def _sample_step(cfg: EngineConfig, last_logits, active, generators,
                 sampling=None):
    """One sampling step: per-slot generators, greedy fast path, pad
    tokens for free slots. `sampling` is None (params from cfg) or a
    triple of per-slot host arrays (temperature, top_k, top_p)."""
    if sampling is not None:
        temp, tk, tp = sampling
        toks = sample_logits_batch(last_logits, generators,
                                   temperature=temp, top_k=tk, top_p=tp)
    elif cfg.temperature == 0.0:
        toks = sample_logits(last_logits, None, temperature=0.0)
    else:
        toks = torch.cat([
            sample_logits(last_logits[i:i + 1], g,
                          temperature=cfg.temperature, top_k=cfg.top_k,
                          top_p=cfg.top_p)
            if g is not None else torch.argmax(last_logits[i:i + 1], -1)
            for i, g in enumerate(generators)
        ])
    return torch.where(active, toks.long(),
                       torch.full_like(toks.long(), cfg.pad_id))


def warm_engine(engine, widths=None) -> None:
    """One admit per bucket width in play and one decode burst each (a
    chunk-admitted prompt's chunks run first), one verify dispatch when
    speculation is on, then release and rewind: the reference's warmup
    recipe. Eager PyTorch has no programs to compile, but this also loads
    the CUDA kernels and warms the allocator outside any timed window."""
    for w in widths or engine.buckets:
        slot = engine.admit([1] * w,
                            max_positions=engine.config.decode_burst)
        while getattr(engine, "is_prefilling", lambda s: False)(slot):
            engine.prefill_step(slot)
        engine.step_burst()
        engine.release(slot)
    if getattr(engine, "drafter", None) is not None:
        # an all-ones prompt makes the lookup drafter propose a full
        # window; the warm dispatch's counters belong to no request
        slot = engine.admit([1] * engine.buckets[0],
                            max_positions=engine.config.spec_k + 1)
        drafts, draft_lens, _ = engine.propose_drafts()
        engine.step_verify(drafts, draft_lens)
        engine.release(slot)
        engine.spec_drafted_tokens = 0
        engine.spec_accepted_tokens = 0
        engine.spec_dispatches = 0
    engine.reset_epoch()


class _EngineBase:
    """What the slot and paged engines share: the prompt-bucket map, slot
    accounting over a SlotAllocator at `self.allocator`, the token-granular
    `step()` veneer over `step_burst`, per-slot sampling params, and the
    optional tracer (per-dispatch prefill / decode-burst lane spans plus
    `torch.profiler.record_function` regions named with the dispatch's
    trace-ids)."""

    tracer = None
    replica = 0
    burst_seq = 0
    last_burst_active = 0

    def set_tracer(self, tracer, replica: int = 0) -> None:
        self.tracer = tracer
        self.replica = replica

    def _dispatch_ids(self) -> list:
        return [self._slot_trace.get(s, f"slot{s}")
                for s in np.flatnonzero(self._active)]

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest bucket width holding `prompt_len` (raises if none)."""
        for w in self.buckets:
            if prompt_len <= w:
                return w
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.buckets[-1]}"
        )

    def fits_prompt(self, prompt_len: int) -> bool:
        try:
            self.bucket_for(prompt_len)
            return True
        except ValueError:
            return False

    def _sampling_args(self):
        if not self.config.per_slot_sampling:
            return None
        return (self._temp, self._topk, self._topp)

    def _set_sampling(self, slot: int, sampling) -> None:
        """Record a slot's (temperature, top_k, top_p) at admit; None
        fields fall back to the config. Overrides without
        per_slot_sampling raise rather than sample at the wrong params."""
        cfg = self.config
        t, k, p = sampling if sampling is not None else (None, None, None)
        t = cfg.temperature if t is None else float(t)
        k = cfg.top_k if k is None else int(k)
        p = cfg.top_p if p is None else float(p)
        if not cfg.per_slot_sampling and (
                t != cfg.temperature or k != cfg.top_k
                or p != cfg.top_p):
            raise ValueError(
                "per-request sampling params need "
                "EngineConfig.per_slot_sampling=True"
            )
        self._temp[slot] = t
        self._topk[slot] = k
        self._topp[slot] = p

    @property
    def num_active(self) -> int:
        return self.allocator.num_used

    @property
    def num_free(self) -> int:
        return self.allocator.num_free

    def step(self) -> np.ndarray:
        """One decode step for the whole pool; tokens (max_slots,).
        Requires decode_burst=1."""
        if self.config.decode_burst != 1:
            raise RuntimeError("step() needs decode_burst=1")
        return self.step_burst()[0]

    def compile_stats(self) -> dict:
        """Kept for interface parity with the reference, whose values are
        jit cache sizes. Eager PyTorch has no jit cache: here the values
        count the distinct prefill widths and decode shapes this engine
        has run, the static-shape observable that must stay constant
        however many requests churn through."""
        return {
            "prefill_compiles": len(self._prefill_shapes),
            "decode_compiles": len(self._decode_shapes),
        }


class SlotEngine(_EngineBase):
    """Slot-granular admission + batched single-token decode over a
    shared-cursor pool. WHAT to admit/release and WHEN is the scheduler's
    job (serve/scheduler.py); this class owns the device state (cache
    pool, last logits, attention starts, per-slot generators). Host
    traffic per burst is one readback of its tokens and finite flags."""

    def __init__(self, model, config: EngineConfig = EngineConfig()) -> None:
        if getattr(model, "pos_emb", None) != "rope":
            raise ValueError(
                "SlotEngine needs pos_emb='rope' — slot admission "
                "left-aligns prompts at arbitrary cache offsets, which "
                "only relative positions survive (models/lm.py attn_start)"
            )
        if not config.prompt_buckets:
            raise ValueError("prompt_buckets must be non-empty")
        if config.spec_decode:
            raise ValueError(
                "spec_decode needs PagedEngine — the verify window is a "
                "paged prefill through per-slot page tables, which the "
                "shared-cursor slot pool cannot express"
            )
        if config.prefill_chunk:
            raise ValueError(
                "prefill_chunk needs PagedEngine with prefix_cache — "
                "chunks append at canonical slot-local positions "
                "through the page table, which the shared-cursor slot "
                "pool cannot express"
            )
        if config.decode_burst < 1:
            raise ValueError("decode_burst must be >= 1")
        self.model = model
        self.config = config
        self.device = model.tok_embed.weight.device
        self.max_len = config.max_len or model.max_len
        self.buckets = tuple(sorted(set(config.prompt_buckets)))
        self.base_cursor = self.buckets[-1]
        if self.base_cursor >= self.max_len:
            raise ValueError(
                f"largest prompt bucket {self.base_cursor} leaves no decode "
                f"headroom in max_len {self.max_len}"
            )
        s = config.max_slots
        self.allocator = SlotAllocator(s)
        self.cursor = self.base_cursor  # mirrors every cache_index leaf
        self._cache = set_cursor(
            make_cache(model, s, self.max_len, self.device), self.base_cursor
        )
        self._last_logits = torch.zeros((s, model.vocab_size),
                                        dtype=model.dtype, device=self.device)
        self._attn_starts = torch.zeros((s,), dtype=torch.int32,
                                        device=self.device)
        self._gens = [None] * s
        self._active = np.zeros((s,), bool)
        self._temp = np.full((s,), config.temperature, np.float32)
        self._topk = np.full((s,), config.top_k, np.int32)
        self._topp = np.full((s,), config.top_p, np.float32)
        self.last_finite = np.ones((1, s), bool)
        self._slot_trace: dict = {}
        self._prefill_shapes: set = set()
        self._decode_shapes: set = set()
        # single-token model applications run, warmup included: the
        # denominator of the decode-kernel launch count (chip_smoke.py)
        self.decode_steps = 0

    # ------------------------------------------------------------ device
    @torch.no_grad()
    def _prefill_admit(self, tokens, start: int, attn_start: int, slot: int):
        """tokens (1, w) left-padded; start = cursor - w."""
        scratch = set_cursor(make_cache(self.model, 1, self.max_len,
                                        self.device), start)
        starts = torch.tensor([attn_start], dtype=torch.int32,
                              device=self.device)
        scratch, logits = decode_apply(self.model, scratch, tokens,
                                       attn_start=starts)
        write_slot(self._cache, scratch, slot)
        self._last_logits[slot] = logits[0, -1].to(self._last_logits.dtype)
        self._attn_starts[slot] = attn_start
        self._prefill_shapes.add(tuple(tokens.shape))

    @torch.no_grad()
    def _decode_burst(self):
        """`decode_burst` single-token steps; returns (tokens, finite),
        both (K, max_slots), on the device."""
        cfg = self.config
        active = torch.as_tensor(self._active, device=self.device)
        sampling = self._sampling_args()
        toks_k, finite_k = [], []
        for _ in range(cfg.decode_burst):
            # per-slot finite flag on the sampling input: a non-finite row
            # marks only its own slot (attention is per row)
            finite_k.append(torch.isfinite(self._last_logits).all(dim=-1))
            toks = _sample_step(cfg, self._last_logits, active, self._gens,
                                sampling)
            _, logits = decode_apply(self.model, self._cache, toks[:, None],
                                     attn_start=self._attn_starts)
            self._last_logits = logits[:, -1]
            toks_k.append(toks)
            self.decode_steps += 1
        self._decode_shapes.add((self._last_logits.shape[0],
                                 cfg.decode_burst))
        return torch.stack(toks_k), torch.stack(finite_k)

    # -------------------------------------------------------------- host
    @property
    def headroom(self) -> int:
        """Decode positions left before the pool cursor hits max_len."""
        return self.max_len - self.cursor

    def admit_gate(self, prompt_len: int, needed_positions: int,
                   prompt: Optional[Sequence[int]] = None) -> str:
        """"ok" = admit now; "later" = after a drain + `make_room`
        rewind; "never" = can never run on this engine. `prompt` is for
        interface parity with the paged engine and ignored."""
        try:
            self.bucket_for(prompt_len)
        except ValueError:
            return "never"
        if needed_positions > self.max_len - self.base_cursor:
            return "never"
        if self.headroom < needed_positions:
            return "later"
        return "ok"

    def make_room(self, prompt_len: Optional[int] = None,
                  needed_positions: Optional[int] = None,
                  prompt: Optional[Sequence[int]] = None) -> bool:
        """Rewind the pool clock once every slot is free; True if it
        changed anything."""
        if self.allocator.num_used == 0 and self.cursor != self.base_cursor:
            self.reset_epoch()
            return True
        return False

    def admit(self, prompt: Sequence[int], *, seed: int = 0,
              max_positions: Optional[int] = None,
              trace_id: Optional[str] = None,
              sampling: Optional[Tuple] = None) -> int:
        """Prefill `prompt` into a free slot; returns the slot index. Its
        last token's K/V lands at `cursor - 1`, so the next decode step
        produces its first token together with everyone else's.
        `max_positions` is for interface parity and ignored."""
        p = len(prompt)
        if p == 0:
            raise ValueError("prompt must contain at least one token")
        w = self.bucket_for(p)
        slot = self.allocator.alloc()
        if slot is None:
            raise RuntimeError("no free slot — scheduler must gate admits")
        try:
            self._set_sampling(slot, sampling)
        except ValueError:
            self.allocator.free(slot)
            raise
        start = self.cursor - w
        assert start >= 0, (self.cursor, w)
        padded = np.full((1, w), self.config.pad_id, np.int64)
        padded[0, w - p:] = np.asarray(prompt, np.int64)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tid = trace_id or f"slot{slot}"
            self._slot_trace[slot] = tid
            span = tr.span("prefill", trace_id=tid, pid=self.replica,
                           tid=SLOT_LANE_BASE + slot, bucket=w,
                           prompt_len=p, slot=slot)
            ann = torch.profiler.record_function(f"serve:prefill:{tid}")
        else:
            span = ann = _NULL
        with span, ann:
            self._prefill_admit(torch.from_numpy(padded).to(self.device),
                                start, self.cursor - p, slot)
        # seeded by the REQUEST's seed alone, not the slot: a request's
        # sampled tokens do not depend on where it was placed
        self._gens[slot] = torch.Generator(device=self.device).manual_seed(
            seed)
        self._active[slot] = True
        return slot

    def step_burst(self) -> np.ndarray:
        """One dispatch of `decode_burst` steps; tokens (K, max_slots).
        Advances the shared cursor by K. Free slots' entries are pad_id."""
        k = self.config.decode_burst
        if self.headroom < k:
            raise RuntimeError(
                "pool positions exhausted — drain and reset_epoch()"
            )
        tr = self.tracer
        if tr is not None and tr.enabled:
            ids = self._dispatch_ids()
            span = tr.span("decode_burst", pid=self.replica,
                           tid=ENGINE_LANE, burst=k, active=len(ids),
                           cursor=self.cursor, sampled_only=True)
            ann = torch.profiler.record_function(
                "serve:decode[" + ",".join(ids) + "]")
        else:
            span = ann = _NULL
        with span, ann:
            toks, finite = self._decode_burst()
            self.cursor += k
            # one readback per burst: tokens and finite flags together
            host = torch.cat([toks, finite.long()]).cpu().numpy()
        self.burst_seq += 1
        self.last_burst_active = int(np.count_nonzero(self._active))
        self.last_finite = host[k:].astype(bool)
        return host[:k]

    def poison_slot(self, slot: int) -> None:
        """Overwrite one slot's pending sampling input with NaN (the
        fault-injection stand-in for a numerical blow-up)."""
        self._last_logits[slot] = float("nan")

    def release(self, slot: int) -> None:
        """Free a slot. The next admission overwrites its whole cache
        row, so no device work happens here."""
        self.allocator.free(slot)
        self._active[slot] = False
        self._slot_trace.pop(slot, None)

    def reset_epoch(self) -> None:
        """Rewind the shared cursor to the base (all slots must be free).
        Stale K/V stays in the buffers; every admission wipes its row."""
        if self.allocator.num_used:
            raise RuntimeError("reset_epoch with active slots")
        set_cursor(self._cache, self.base_cursor)
        self._attn_starts.zero_()
        self.cursor = self.base_cursor


class PagedEngine(_EngineBase):
    """Paged-KV continuous batching: per-slot page tables, no shared clock.

    The same public surface as SlotEngine, over a pool of fixed-size
    blocks (serve/kv_pages.py) where every slot decodes at its OWN
    slot-local position:

    - `admit` prefills the bucketed, LEFT-padded prompt into a batch-1
      contiguous scratch cache at positions [0, w) and scatters it into
      freshly allocated blocks;
    - `step_burst` appends each active slot's token at `lengths[slot]`
      through the page table and attends only that slot's pages (kernel C,
      or D for an int8 pool: ops/decode_attention.paged_decode_attention);
    - `release` DEREFS the slot's blocks: a block shared with the prefix
      cache or a fork sibling survives, a sole-owned one returns to the
      free list. Nothing drains and nothing rewinds;
    - a request may decode past the model's max_len: per-slot capacity is
      `max_blocks_per_slot * block_size` and RoPE positions are unbounded.

    On top of that, as in the reference:

    - **Prefix sharing** (`prefix_cache`): admission walks a radix tree of
      previously served prompt blocks; matched blocks join the slot's page
      table refcounted and only the suffix is prefilled
      (`_prefix_prefill`), RIGHT-padded at canonical positions.
    - **Copy-on-write**: before a burst writes into a block another holder
      references, the block is copied into a private one (`_cow_split`),
      which makes `fork` (n > 1 sampling per prompt) cheap.
    - **Block-aware preemption**: admission takes only the prompt blocks;
      when growth finds the pool empty the engine evicts unreferenced
      prefix-cache blocks, then preempts the YOUNGEST-admitted slot, whose
      request the scheduler re-prefills on readmission
      (`take_preempted`).
    - **Chunked prefill** (`prefill_chunk`) and **speculative decoding**
      (`spec_decode`: `propose_drafts` + `step_verify`).

    Host state (page tables, lengths, attention starts, the active mask)
    lives in NumPy mirrors and is shipped to the device once per dispatch;
    within a burst the lengths advance on the device, and the tokens come
    back in one readback at its end.
    """

    def __init__(self, model, config: EngineConfig = EngineConfig(), *,
                 draft_source: Optional[DraftSource] = None) -> None:
        if getattr(model, "pos_emb", None) != "rope":
            raise ValueError(
                "PagedEngine needs pos_emb='rope' — slots decode at "
                "slot-local positions, which only relative positions "
                "survive (models/lm.py)"
            )
        if not config.prompt_buckets:
            raise ValueError("prompt_buckets must be non-empty")
        if config.decode_burst < 1:
            raise ValueError("decode_burst must be >= 1")
        if config.block_size < 1:
            raise ValueError("block_size must be positive")
        if config.spec_decode:
            if config.temperature != 0.0:
                raise ValueError(
                    "spec_decode needs temperature=0.0 — exact "
                    "acceptance is greedy string matching against the "
                    "model's own argmaxes (serve/spec.py)"
                )
            if config.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if config.per_slot_sampling:
                raise ValueError(
                    "spec_decode excludes per_slot_sampling — exact "
                    "acceptance is greedy string matching, which a "
                    "slot sampling at its own temperature would break"
                )
        if config.prefill_chunk:
            if not config.prefix_cache:
                raise ValueError(
                    "prefill_chunk needs prefix_cache=True — chunks "
                    "append at canonical right-padded positions through "
                    "the page table (_prefix_prefill), the layout only "
                    "the prefix-cache mode uses"
                )
            if config.prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1 (0 = off)")
            if config.prefill_chunk > max(config.prompt_buckets):
                raise ValueError(
                    f"prefill_chunk {config.prefill_chunk} exceeds the "
                    f"largest prompt bucket "
                    f"{max(config.prompt_buckets)} — each chunk is "
                    f"bucketed"
                )
        self.model = model
        self.config = config
        self.device = model.tok_embed.weight.device
        self.max_len = config.max_len or model.max_len
        self.buckets = tuple(sorted(set(config.prompt_buckets)))
        bs = config.block_size
        self.max_blocks_per_slot = (
            config.max_blocks_per_slot or -(-self.max_len // bs)
        )
        self.max_context = self.max_blocks_per_slot * bs
        if self.buckets[-1] > min(self.max_context - 1, model.max_len):
            raise ValueError(
                f"largest prompt bucket {self.buckets[-1]} must fit the "
                f"scratch prefill (model max_len {model.max_len}) and "
                f"leave decode room in the per-slot capacity "
                f"{self.max_context}"
            )
        s = config.max_slots
        num_blocks = config.num_blocks or 1 + s * self.max_blocks_per_slot
        self.allocator = SlotAllocator(s)
        self.blocks = BlockAllocator(num_blocks)
        self.radix = (RadixPrefixCache(self.blocks, bs)
                      if config.prefix_cache else None)
        # matched tokens of the most recent admit (None = no prefix
        # cache): the scheduler books it into the request's flight record
        self.last_prefix_hit: Optional[int] = None
        self._cache = make_paged_cache(model, num_blocks, bs, self.device)
        self._last_logits = torch.zeros((s, model.vocab_size),
                                        dtype=model.dtype, device=self.device)
        self._gens = [None] * s
        self._active = np.zeros((s,), bool)
        self._temp = np.full((s,), config.temperature, np.float32)
        self._topk = np.full((s,), config.top_k, np.int32)
        self._topp = np.full((s,), config.top_p, np.float32)
        # chunk-admitted slots mid-prefill: slot -> {"prompt", "done"};
        # such a slot holds blocks and a table row but stays INACTIVE
        self._pending_prompt: dict = {}
        # host mirrors, shipped to the device once per dispatch
        self._pt = np.zeros((s, self.max_blocks_per_slot), np.int32)
        self._len = np.zeros((s,), np.int32)
        self._attn = np.zeros((s,), np.int32)
        self._nblk = np.zeros((s,), np.int64)    # blocks in the table
        self._budget = np.zeros((s,), np.int64)  # admit-time block cap
        self._seq = np.zeros((s,), np.int64)     # admission order (LIFO
        self._admit_seq = 0                      # preemption victims)
        self._preempted: list = []   # slots evicted since the last drain
        self.preemptions = 0
        self.last_finite = np.ones((1, s), bool)
        self._slot_trace: dict = {}
        # replayable sampling: slot -> the request's seed path, the admit
        # seed plus one fork ordinal per ancestor fork
        self._slot_seed: dict = {}
        self._fork_n: dict = {}
        if config.spec_decode:
            self.drafter: Optional[DraftSource] = (
                draft_source if draft_source is not None
                else PromptLookupDraft(config.spec_ngram_max,
                                       config.spec_ngram_min)
            )
        else:
            self.drafter = None
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_dispatches = 0
        # the distinct shapes each device path has run (compile_stats)
        self._prefill_shapes: set = set()
        self._decode_shapes: set = set()
        self._prefix_shapes: set = set()
        self._cow_shapes: set = set()
        self._verify_shapes: set = set()
        # single-token paged model applications (burst steps and verify
        # corrections, warmup included): each launches the paged decode
        # kernel once per layer on the card (chip_smoke.py)
        self.decode_steps = 0

    # ------------------------------------------------------------ device
    def _generator(self, path) -> torch.Generator:
        """The sampling generator of a seed path: an admitted request's
        own seed (as SlotEngine seeds it), or for a fork child the path
        mixed through NumPy's SeedSequence — a pure function of (request
        seed, fork order), whatever slot the child lands on."""
        seed = path[0] if len(path) == 1 else int(
            np.random.SeedSequence(list(path)).generate_state(
                1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, host: np.ndarray) -> torch.Tensor:
        """A host mirror shipped to the device (always a copy)."""
        return torch.tensor(host, device=self.device)

    def _apply(self, tokens, **kw) -> torch.Tensor:
        """decode_apply over the pool; returns the logits. Counts the
        single-token applications (`decode_steps`)."""
        if tokens.shape[1] == 1:
            self.decode_steps += 1
        return decode_apply(self.model, self._cache, tokens, **kw)[1]

    @torch.no_grad()
    def _prefill_admit(self, tokens, attn_start: int, block_ids, slot: int):
        """tokens (1, w) left-padded: prefill a scratch cache at slot-local
        positions [0, w), then scatter it into the slot's blocks."""
        w = tokens.shape[1]
        scratch = make_cache(self.model, 1, w, self.device)
        starts = torch.tensor([attn_start], dtype=torch.int32,
                              device=self.device)
        _, logits = decode_apply(self.model, scratch, tokens,
                                 attn_start=starts)
        scatter_prompt_blocks(self._cache, scratch, block_ids, w,
                              self.config.block_size)
        self._last_logits[slot] = logits[0, -1].to(self._last_logits.dtype)
        self._prefill_shapes.add(w)

    @torch.no_grad()
    def _prefix_prefill(self, tokens, pos0: int, true_len: int, slot: int):
        """tokens (1, w) RIGHT-padded, the real suffix in [0, true_len):
        appended at slot-local positions [pos0, pos0 + w) through the page
        table, attending the shared prefix blocks in place. The pad rows
        write K/V past the context, hidden by the causal mask until decode
        overwrites them; the next-token logits are the last real row's."""
        logits = self._apply(
            tokens, page_table=self._tensor(self._pt[slot:slot + 1]),
            kv_lengths=torch.tensor([pos0], dtype=torch.int32,
                                    device=self.device),
        )
        self._last_logits[slot] = logits[0, true_len - 1].to(
            self._last_logits.dtype)
        self._prefix_shapes.add(tokens.shape[1])

    @torch.no_grad()
    def _decode_burst(self, attn, active, page_table, lengths):
        """`decode_burst` paged single-token steps. Each writes the active
        slots' K/V at their own `lengths` and advances only those on the
        device; free slots write the garbage block. Returns (tokens,
        finite), both (K, max_slots), on the device."""
        cfg = self.config
        sampling = self._sampling_args()
        step = active.to(torch.int32)
        toks_k, finite_k = [], []
        for _ in range(cfg.decode_burst):
            finite_k.append(torch.isfinite(self._last_logits).all(dim=-1))
            toks = _sample_step(cfg, self._last_logits, active, self._gens,
                                sampling)
            logits = self._apply(toks[:, None], attn_start=attn,
                                 page_table=page_table, kv_lengths=lengths)
            lengths = lengths + step
            self._last_logits = logits[:, -1]
            toks_k.append(toks)
        self._decode_shapes.add((len(self._gens), cfg.decode_burst,
                                 sampling is not None))
        return torch.stack(toks_k), torch.stack(finite_k)

    @torch.no_grad()
    def _verify(self, drafts, draft_lens, attn, active, page_table,
                lengths):
        """Speculative verify: score a k-token drafted window in ONE paged
        prefill at positions `lengths + [0, k)`, accept greedily, append
        one corrected token.

        Row i of [carried logits, window logits] predicts the token at
        position lengths + i; `g` is their argmax (plain greedy decode's
        op). Draft i is accepted iff it equals g[:, i] and every earlier
        draft matched; with m accepted the emitted run is g[:, :m+1]. A
        single-token step then writes the correction token's K/V at
        `lengths + m` (over the rejected draft's row) and carries its
        logits. Rejected window positions keep garbage K/V inside the
        slot's own blocks, masked until overwritten. Returns (tokens
        (s, k+1), accepted (s,), finite (s, k+1)) on the device."""
        k = drafts.shape[1]
        pad = self.config.pad_id
        kw = dict(attn_start=attn, page_table=page_table)
        win = self._apply(drafts, kv_lengths=lengths, **kw)
        all_logits = torch.cat(
            [self._last_logits[:, None], win.to(self._last_logits.dtype)],
            dim=1)                                           # (s, k+1, v)
        g = sample_logits(all_logits, None, temperature=0.0)  # (s, k+1)
        cols = torch.arange(k, device=self.device)
        matches = (drafts == g[:, :k]) & (cols[None, :] < draft_lens[:, None])
        accepted = torch.cumprod(matches.long(), dim=1).sum(dim=1)
        accepted = torch.where(active, accepted, torch.zeros_like(accepted))
        finite = torch.isfinite(all_logits).all(dim=-1)
        correction = torch.gather(g, 1, accepted[:, None])
        correction = torch.where(active[:, None], correction,
                                 torch.full_like(correction, pad))
        nxt = self._apply(correction,
                          kv_lengths=(lengths + accepted).to(torch.int32),
                          **kw)
        self._last_logits = torch.where(
            active[:, None], nxt[:, -1].to(self._last_logits.dtype),
            self._last_logits)
        toks = torch.where(active[:, None], g, torch.full_like(g, pad))
        self._verify_shapes.add(tuple(drafts.shape))
        return toks, accepted, finite

    # -------------------------------------------------------------- host
    def _blocks_for(self, positions: int) -> int:
        return -(-positions // self.config.block_size)

    @property
    def blocks_available(self) -> int:
        """Blocks admission can promise right now: the free list plus
        unreferenced prefix-cache blocks (evicted on demand)."""
        free = self.blocks.num_free
        if self.radix is not None:
            free += self.radix.evictable()
        return free

    @property
    def headroom(self) -> int:
        """Promisable pool positions (informational)."""
        return self.blocks_available * self.config.block_size

    def _probe_prefix(self, prompt: Sequence[int]) -> int:
        """Read-only longest cached prefix of `prompt` (0 without the
        cache): what the admission gate subtracts before bucketing."""
        if self.radix is None:
            return 0
        return self.radix.peek(prompt)

    def _admit_plan(self, prompt_len: int,
                    prompt: Optional[Sequence[int]] = None):
        """(matched, bucket_w, need_now) for an admission, or None when no
        bucket fits the uncached suffix. need_now = prompt-table blocks not
        already cached + one decode block: the one place the gate,
        make_room and preempt_headroom derive it. With prefill_chunk, a
        suffix longer than one chunk is bucketed at the chunk width."""
        matched = self._probe_prefix(prompt) if prompt is not None else 0
        suffix = prompt_len - matched
        if self.config.prefill_chunk:
            suffix = min(suffix, self.config.prefill_chunk)
        try:
            w = self.bucket_for(suffix)
        except ValueError:
            return None
        need_now = self._blocks_for(matched + w) \
            - matched // self.config.block_size + 1
        return matched, w, need_now

    def admit_gate(self, prompt_len: int, needed_positions: int,
                   prompt: Optional[Sequence[int]] = None) -> str:
        """"ok" | "later" (blocks free as requests release, get preempted,
        or prefix blocks age out) | "never" (outgrows every bucket after
        the cached prefix, the per-slot capacity, or the whole pool)."""
        plan = self._admit_plan(prompt_len, prompt)
        if plan is None:
            return "never"
        matched, w, need_now = plan
        if self.radix is None:
            end = w + needed_positions
        else:
            end = max(matched + w, prompt_len + needed_positions)
        if end > self.max_context:
            return "never"
        if self._blocks_for(end) > self.blocks.num_blocks - 1:
            return "never"  # outgrows the whole pool, even empty
        if need_now > self.blocks_available:
            return "later"
        return "ok"

    def preempt_headroom(self, slots: Sequence[int], prompt_len: int,
                         prompt: Optional[Sequence[int]] = None) -> bool:
        """Could evicting every slot in `slots` possibly admit a blocked
        request of this shape? (Upper bound: a victim's whole table.)"""
        plan = self._admit_plan(prompt_len, prompt)
        if plan is None:
            return False
        bound = self.blocks_available \
            + int(sum(self._nblk[s] for s in slots))
        return plan[2] <= bound

    def make_room(self, prompt_len: Optional[int] = None,
                  needed_positions: Optional[int] = None,
                  prompt: Optional[Sequence[int]] = None) -> bool:
        """Evict unreferenced prefix-cache blocks (LRU); True if anything
        freed. With the blocked request's shape the pass is targeted: its
        own matched prefix is pinned first, and only the shortfall against
        the gate's need is freed."""
        if self.radix is None:
            return False
        keep = self.radix.ref_prefix(prompt) if prompt is not None else []
        try:
            if prompt_len is not None and needed_positions is not None:
                plan = self._admit_plan(prompt_len, prompt)
                if plan is None:
                    return False      # no bucket fits: room cannot help
                # the FULL shortfall: evict()'s exposure loop drains
                # interior chain blocks that evictable() does not count
                want = max(0, plan[2] - self.blocks.num_free)
            else:
                want = self.radix.evictable()
            return want > 0 and self.radix.evict(want) > 0
        finally:
            if keep:
                self.blocks.free(keep)

    # ------------------------------------------------- block acquisition
    def _acquire_admit(self, n: int):
        """n blocks for an admission: free list, then prefix-cache
        eviction. Admission never preempts runners."""
        ids = self.blocks.alloc(n)
        if ids is None and self.radix is not None:
            self.radix.evict(n - self.blocks.num_free)
            ids = self.blocks.alloc(n)
        if ids is None:
            raise RuntimeError(
                "not enough free blocks — scheduler must gate admits"
            )
        return ids

    def _acquire_decode(self, n: int, protect: int):
        """n blocks for growth or a CoW split: free list, then prefix-cache
        eviction, then preemption of the youngest-admitted active slot
        other than `protect`. Raises only when even preempting everyone
        else cannot cover."""
        while True:
            ids = self.blocks.alloc(n)
            if ids is not None:
                return ids
            if self.radix is not None \
                    and self.radix.evict(n - self.blocks.num_free):
                continue
            victims = [
                s for s in np.flatnonzero(self._active) if s != protect
            ]
            if not victims:
                raise RuntimeError(
                    f"paged pool exhausted: {n} blocks needed with no "
                    f"victim left to preempt (slot {protect} already "
                    f"holds {int(self._nblk[protect])})"
                )
            victim = max(victims, key=lambda s: self._seq[s])
            self.preempt(int(victim))

    def preempt(self, slot: int) -> None:
        """Evict one active slot: deref its blocks, clear the slot, and
        queue it on `take_preempted()` for the scheduler's readmission."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._clear_slot(slot)
        self.preemptions += 1
        self._preempted.append(slot)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant("preempt", trace_id=self._slot_trace.get(slot),
                       pid=self.replica, tid=ENGINE_LANE, slot=slot,
                       blocks_free=self.blocks.num_free)
        self._slot_trace.pop(slot, None)
        self._slot_seed.pop(slot, None)
        self._fork_n.pop(slot, None)

    def take_preempted(self) -> list:
        """Slots preempted since the last drain."""
        out, self._preempted = self._preempted, []
        return out

    # ---------------------------------------------------------- admission
    def admit(self, prompt: Sequence[int], *, seed: int = 0,
              max_positions: Optional[int] = None,
              trace_id: Optional[str] = None,
              sampling: Optional[Tuple] = None) -> int:
        """Prefill `prompt` into a free slot and blocks; the slot id.

        `max_positions` is the request's decode-position budget: the
        growth cap and the whole-pool feasibility check (None caps at the
        per-slot capacity). With `prefix_cache` the prompt first walks the
        radix tree and only the uncached suffix is prefilled; with
        `prefill_chunk`, a suffix longer than one chunk makes this a CHUNK
        admission (bookkeeping only; the caller drives `prefill_step`)."""
        p = len(prompt)
        if p == 0:
            raise ValueError("prompt must contain at least one token")
        bs = self.config.block_size
        shared: list = []
        matched = 0
        if self.radix is not None:
            shared, matched = self.radix.match(prompt)
            self.last_prefix_hit = matched
        chunk = self.config.prefill_chunk
        chunked = bool(chunk) and (p - matched) > chunk
        try:
            w = self.bucket_for(min(p - matched, chunk) if chunked
                                else p - matched)
        except ValueError:
            self.blocks.free(shared)
            raise
        # the slot's context END: the plain path starts at length w
        # (left-padding counts as positions), the prefix path at the true
        # p — but its prefill pad rows touch up to matched + w
        if max_positions is None:
            max_positions = self.max_context - (
                w if self.radix is None else max(matched + w, p)
            )
        if self.radix is None:
            end = w + max_positions
        else:
            end = max(matched + w, p + max_positions)
        if end > self.max_context:
            self.blocks.free(shared)
            raise ValueError(
                f"prompt {p} (prefill span {matched + w}) + max_positions "
                f"{max_positions} exceeds the per-slot capacity "
                f"{self.max_context} (= max_blocks_per_slot * block_size)"
            )
        if self._blocks_for(end) > self.blocks.num_blocks - 1:
            self.blocks.free(shared)
            raise ValueError(
                f"prompt {p} + max_positions {max_positions} outgrows "
                f"the whole pool ({self.blocks.num_blocks - 1} blocks)"
            )
        slot = self.allocator.alloc()
        if slot is None:
            self.blocks.free(shared)
            raise RuntimeError("no free slot — scheduler must gate admits")
        try:
            self._set_sampling(slot, sampling)
        except ValueError:
            self.allocator.free(slot)
            self.blocks.free(shared)
            raise
        n_shared = len(shared)
        if chunked:
            # chunk admission: the shared prefix joins the table; every
            # uncached token lands through prefill_step. The slot stays
            # INACTIVE until its final chunk: bursts pad it (their write at
            # _len[slot] is overwritten by the next chunk, or lands in the
            # garbage block while unallocated) and preemption skips it.
            self._pt[slot, :] = 0
            self._pt[slot, :n_shared] = shared
            self._nblk[slot] = n_shared
            self._budget[slot] = min(
                max(self._blocks_for(end), n_shared),
                self.max_blocks_per_slot,
            )
            self._seq[slot] = self._admit_seq
            self._admit_seq += 1
            self._len[slot] = matched
            self._attn[slot] = 0
            self._pending_prompt[slot] = {
                "prompt": [int(t) for t in prompt], "done": matched,
            }
            tr = self.tracer
            if tr is not None and tr.enabled:
                tid = trace_id or f"slot{slot}"
                self._slot_trace[slot] = tid
                tr.instant("chunk_admit", trace_id=tid,
                           pid=self.replica, tid=SLOT_LANE_BASE + slot,
                           prompt_len=p, prefix_hit=matched,
                           chunk=chunk, slot=slot)
            self._start_stream(slot, seed)
            return slot
        n_table = self._blocks_for(matched + w)
        try:
            ids = self._acquire_admit(n_table - n_shared)
        except RuntimeError:
            self.allocator.free(slot)
            self.blocks.free(shared)
            raise
        self._pt[slot, :] = 0
        self._pt[slot, :n_shared] = shared
        self._pt[slot, n_shared:n_table] = ids
        self._nblk[slot] = n_table
        self._budget[slot] = min(
            max(self._blocks_for(end), n_table), self.max_blocks_per_slot
        )
        self._seq[slot] = self._admit_seq
        self._admit_seq += 1
        tr = self.tracer
        if tr is not None and tr.enabled:
            tid = trace_id or f"slot{slot}"
            self._slot_trace[slot] = tid
            span = tr.span("prefill", trace_id=tid, pid=self.replica,
                           tid=SLOT_LANE_BASE + slot, bucket=w,
                           prompt_len=p, slot=slot, blocks=n_table,
                           prefix_hit=matched)
            ann = torch.profiler.record_function(f"serve:prefill:{tid}")
        else:
            span = ann = _NULL
        if self.radix is None:
            # plain path: LEFT-padded scratch prefill + block scatter
            self._len[slot] = w
            self._attn[slot] = w - p
            padded = np.full((1, w), self.config.pad_id, np.int64)
            padded[0, w - p:] = np.asarray(prompt, np.int64)
            with span, ann:
                self._prefill_admit(
                    torch.from_numpy(padded).to(self.device), w - p, ids,
                    slot)
        else:
            # prefix path: canonical positions, RIGHT-padded suffix
            # appended at `matched` through the page table
            sl = p - matched
            self._len[slot] = matched + sl
            self._attn[slot] = 0
            padded = np.full((1, w), self.config.pad_id, np.int64)
            padded[0, :sl] = np.asarray(prompt[matched:], np.int64)
            with span, ann:
                self._prefix_prefill(
                    torch.from_numpy(padded).to(self.device), matched, sl,
                    slot)
            # publish this prompt's own full blocks for future hits
            n_full = p // bs
            if n_full:
                self.radix.insert(
                    prompt, [int(b) for b in self._pt[slot, :n_full]]
                )
        self._start_stream(slot, seed)
        self._active[slot] = True
        if self.drafter is not None:
            # a readmission after preemption passes prompt + salvaged
            # tokens here, so the drafter's context is the slot's prefix
            self.drafter.begin(slot, [int(t) for t in prompt])
        return slot

    def _start_stream(self, slot: int, seed: int) -> None:
        """Seed the slot's sampling stream from the REQUEST's seed alone:
        placement stays invisible to the sample stream."""
        self._gens[slot] = self._generator((seed,))
        self._slot_seed[slot] = (seed,)
        self._fork_n.pop(slot, None)

    # ------------------------------------------------- chunked prefill
    def is_prefilling(self, slot: int) -> bool:
        """True while a chunk-admitted slot still has prompt chunks."""
        return slot in self._pending_prompt

    def prefill_step(self, slot: int) -> bool:
        """Run ONE prefill chunk for a chunk-admitted slot; True when the
        prompt is fully prefilled (the slot just went active).

        Each chunk is a `_prefix_prefill` at slot-local positions [done,
        done + take) through the page table. Blocks grow per chunk via
        `_acquire_decode`, only for the real tokens. The final chunk
        publishes the prompt's full blocks to the radix cache, seeds the
        drafter and activates the slot — the state a whole-prompt
        admission leaves. Raises RuntimeError when the pool cannot cover a
        chunk even after preempting every active slot."""
        st = self._pending_prompt[slot]
        prompt = st["prompt"]
        p = len(prompt)
        done = st["done"]
        take = min(p - done, self.config.prefill_chunk)
        w = self.bucket_for(take)
        need = self._blocks_for(done + take)
        grow = need - int(self._nblk[slot])
        if grow > 0:
            if need > self.max_blocks_per_slot:
                raise RuntimeError(
                    f"slot {slot} prompt chunk needs {need} blocks, "
                    f"past the per-slot capacity "
                    f"{self.max_blocks_per_slot}"
                )
            ids = self._acquire_decode(grow, protect=slot)
            self._pt[slot, self._nblk[slot]:need] = ids
            self._nblk[slot] = need
        padded = np.full((1, w), self.config.pad_id, np.int64)
        padded[0, :take] = np.asarray(prompt[done:done + take], np.int64)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tid = self._slot_trace.get(slot, f"slot{slot}")
            span = tr.span("prefill_chunk", trace_id=tid,
                           pid=self.replica, tid=SLOT_LANE_BASE + slot,
                           bucket=w, pos0=done, take=take, slot=slot)
            ann = torch.profiler.record_function(
                f"serve:prefill_chunk:{tid}")
        else:
            span = ann = _NULL
        with span, ann:
            self._prefix_prefill(torch.from_numpy(padded).to(self.device),
                                 done, take, slot)
        done += take
        st["done"] = done
        self._len[slot] = done
        if done < p:
            return False
        del self._pending_prompt[slot]
        floor = self._blocks_for(p)
        self._nblk[slot] = rewind_block_tail(
            self.blocks, self._pt[slot], int(self._nblk[slot]), floor
        )
        n_full = p // self.config.block_size
        if n_full:
            self.radix.insert(
                prompt, [int(b) for b in self._pt[slot, :n_full]]
            )
        if self.drafter is not None:
            self.drafter.begin(slot, [int(t) for t in prompt])
        self._active[slot] = True
        return True

    def fork(self, slot: int, *, seed: Optional[int] = None,
             trace_id: Optional[str] = None) -> int:
        """Clone a running request into a new slot WITHOUT copying its
        context: the child references every parent block (refcounted) and
        carries the same pending logits under its own sampling stream.
        With no explicit seed the child's stream derives from the parent's
        seed path plus this fork's ordinal (replayable whatever slot the
        allocator hands out); `seed=` starts a fresh stream."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        child = self.allocator.alloc()
        if child is None:
            raise RuntimeError("no free slot — gate fork like an admit")
        n = int(self._nblk[slot])
        self.blocks.ref([int(b) for b in self._pt[slot, :n]])
        self._pt[child, :] = self._pt[slot, :]
        self._len[child] = self._len[slot]
        self._attn[child] = self._attn[slot]
        self._nblk[child] = n
        self._budget[child] = self._budget[slot]
        # siblings sample under the parent's params
        self._temp[child] = self._temp[slot]
        self._topk[child] = self._topk[slot]
        self._topp[child] = self._topp[slot]
        self._seq[child] = self._admit_seq
        self._admit_seq += 1
        if seed is not None:
            path = (seed,)
        else:
            self._fork_n[slot] = self._fork_n.get(slot, 0) + 1
            path = self._slot_seed[slot] + (self._fork_n[slot],)
        self._slot_seed[child] = path
        self._gens[child] = self._generator(path)
        self._last_logits[child] = self._last_logits[slot]
        self._active[child] = True
        if self.drafter is not None:
            self.drafter.begin(child, self.drafter.snapshot(slot))
        if trace_id is not None:
            self._slot_trace[child] = trace_id
        return child

    # ------------------------------------------------------------- decode
    def _grow_tables(self, k: int) -> int:
        """Allocate the blocks the next k decode positions need, per
        active slot oldest-first (growth may preempt: LIFO victims must
        still be ungrown). Stepping a slot past its admit-time budget
        raises BEFORE touching the allocator. Returns blocks grown."""
        total_grown = 0
        order = sorted(np.flatnonzero(self._active),
                       key=lambda s: self._seq[s])
        for slot in order:
            if not self._active[slot]:
                continue  # preempted by an older slot's growth
            need = self._blocks_for(int(self._len[slot]) + k)
            grow = need - int(self._nblk[slot])
            if grow <= 0:
                continue
            if need > int(self._budget[slot]) \
                    or need > self.max_blocks_per_slot:
                raise RuntimeError(
                    f"slot {slot} stepped past its admit-time block "
                    f"budget (needs {need} blocks, budget "
                    f"{int(self._budget[slot])}) — admit with a larger "
                    f"max_positions"
                )
            ids = self._acquire_decode(grow, protect=int(slot))
            self._pt[slot, self._nblk[slot]:need] = ids
            self._nblk[slot] = need
            total_grown += grow
        return total_grown

    def _cow_split(self, k: int) -> int:
        """Copy-on-write before a burst: any existing table block the next
        k positions will write into that another holder also references
        is first copied into a private block, so a shared block is never
        mutated. Returns the number of splits."""
        splits = 0
        bs = self.config.block_size
        for slot in sorted(np.flatnonzero(self._active),
                           key=lambda s: self._seq[s]):
            if not self._active[slot]:
                continue
            length = int(self._len[slot])
            first = length // bs
            last = min((length + k - 1) // bs, int(self._nblk[slot]) - 1)
            for idx in range(first, last + 1):
                b = int(self._pt[slot, idx])
                if self.blocks.refcount(b) <= 1:
                    continue
                assert b != GARBAGE_BLOCK, \
                    "garbage block can never be shared"
                (new,) = self._acquire_decode(1, protect=int(slot))
                # `protect` keeps this slot off the victim list
                assert self._active[slot], "protected slot was preempted"
                with torch.no_grad():
                    copy_block(self._cache, b, new)
                self._cow_shapes.add(bs)
                self.blocks.free([b])     # drop this slot's ref
                self._pt[slot, idx] = new
                splits += 1
        return splits

    def step_burst(self) -> np.ndarray:
        """One dispatch of `decode_burst` steps; tokens (K, max_slots).
        Active slots' lengths advance by K; free slots emit pad_id and
        write only the garbage block. Growth and CoW run on the host
        first and may PREEMPT young slots (they surface through
        `take_preempted()`)."""
        k = self.config.decode_burst
        grown = self._grow_tables(k)
        splits = self._cow_split(k)
        tr = self.tracer
        if tr is not None and tr.enabled:
            ids = self._dispatch_ids()
            span = tr.span("decode_burst", pid=self.replica,
                           tid=ENGINE_LANE, burst=k, active=len(ids),
                           blocks_grown=grown, cow_splits=splits,
                           blocks_free=self.blocks.num_free,
                           sampled_only=True)
            ann = torch.profiler.record_function(
                "serve:decode[" + ",".join(ids) + "]")
        else:
            span = ann = _NULL
        with span, ann:
            toks, finite = self._decode_burst(
                self._tensor(self._attn), self._tensor(self._active),
                self._tensor(self._pt), self._tensor(self._len))
            self._len[self._active] += k
            # one readback per burst: tokens and finite flags together
            host = torch.cat([toks, finite.long()]).cpu().numpy()
        self.burst_seq += 1
        self.last_burst_active = int(np.count_nonzero(self._active))
        self.last_finite = host[k:].astype(bool)
        toks = host[:k]
        if self.drafter is not None:
            # plain-burst tokens grow the drafter's context too
            for slot in np.flatnonzero(self._active):
                self.drafter.extend(int(slot), toks[:, slot].tolist())
        return toks

    # ------------------------------------------------- speculative decoding
    def propose_drafts(self):
        """Every active slot's draft proposals (host-pure): (drafts
        (max_slots, spec_k) int32, draft_lens (max_slots,) int32,
        any_drafted bool)."""
        if self.drafter is None:
            raise RuntimeError("propose_drafts needs spec_decode=True")
        k = self.config.spec_k
        drafts = np.zeros((self.config.max_slots, k), np.int32)
        lens = np.zeros((self.config.max_slots,), np.int32)
        for slot in np.flatnonzero(self._active):
            d = self.drafter.propose(int(slot), k)
            if d:
                drafts[slot, :len(d)] = d
                lens[slot] = len(d)
        return drafts, lens, bool(lens.any())

    def step_verify(self, drafts: np.ndarray,
                    draft_lens: np.ndarray) -> tuple:
        """One verify dispatch over a drafted window (`_verify` is its
        device half). Returns (tokens (spec_k+1, max_slots), counts
        (max_slots,) real leading rows per slot = accepted + 1, or 0 for
        inactive slots, finite (spec_k+1, max_slots)). Growth covers the
        worst case (spec_k + 1 positions) up front, and the rejected
        tail's surplus blocks go back to the pool afterwards."""
        if self.drafter is None:
            raise RuntimeError("step_verify needs spec_decode=True")
        k = int(drafts.shape[1])
        nblk_before = self._nblk.copy()
        grown = self._grow_tables(k + 1)
        splits = self._cow_split(k + 1)
        tr = self.tracer
        if tr is not None and tr.enabled:
            ids = self._dispatch_ids()
            span = tr.span("verify", pid=self.replica,
                           tid=ENGINE_LANE, k=k, active=len(ids),
                           drafted=int(draft_lens.sum()),
                           blocks_grown=grown, cow_splits=splits,
                           sampled_only=True)
            ann = torch.profiler.record_function(
                "serve:verify[" + ",".join(ids) + "]")
        else:
            span = ann = _NULL
        with span, ann:
            toks, accepted, finite = self._verify(
                self._tensor(drafts).long(), self._tensor(draft_lens),
                self._tensor(self._attn), self._tensor(self._active),
                self._tensor(self._pt), self._tensor(self._len))
            # one readback: tokens, accepted counts and finite flags
            host = torch.cat([toks, accepted[:, None], finite.long()],
                             dim=1).cpu().numpy()
        toks, accepted, finite = (host[:, :k + 1], host[:, k + 1],
                                  host[:, k + 2:].astype(bool))
        counts = np.where(self._active, accepted + 1, 0).astype(np.int64)
        self._len[self._active] += counts[self._active].astype(np.int32)
        # rollback, block half: surplus blocks grown for the rejected tail
        # (this dispatch's own fresh allocations) go back to the pool
        for slot in np.flatnonzero(self._active):
            floor = max(self._blocks_for(int(self._len[slot])),
                        int(nblk_before[slot]))
            self._nblk[slot] = rewind_block_tail(
                self.blocks, self._pt[slot], int(self._nblk[slot]), floor
            )
        self.spec_drafted_tokens += int(draft_lens[self._active].sum())
        self.spec_accepted_tokens += int(accepted[self._active].sum())
        self.spec_dispatches += 1
        self.burst_seq += 1
        self.last_burst_active = int(np.count_nonzero(self._active))
        toks = np.ascontiguousarray(toks.T)      # (k+1, max_slots)
        finite = np.ascontiguousarray(finite.T)
        self.last_finite = finite
        for slot in np.flatnonzero(self._active):
            n = int(counts[slot])
            self.drafter.extend(int(slot), toks[:n, slot].tolist())
        return toks, counts, finite

    def context_len(self, slot: int) -> int:
        """The slot's context length (prompt span + decoded tokens); can
        exceed the model's max_len."""
        return int(self._len[slot])

    def fits_prompt(self, prompt_len: int) -> bool:
        """Chunked mode bounds servability by the per-slot capacity and
        the pool, not the bucket table."""
        if self.config.prefill_chunk:
            return (prompt_len + 1 <= self.max_context
                    and self._blocks_for(prompt_len + 1)
                    <= self.blocks.num_blocks - 1)
        return super().fits_prompt(prompt_len)

    def poison_slot(self, slot: int) -> None:
        """NaN one slot's pending sampling input (fault injection)."""
        self._last_logits[slot] = float("nan")

    def compile_stats(self) -> dict:
        """The reference's five keys (its jit cache sizes: the plain
        prefill, the decode burst, the prefix-suffix prefill, the CoW copy
        and the verify program). Eager PyTorch has no jit cache: here each
        value counts the distinct shapes that path has run, the
        static-shape observable that must stay flat under churn."""
        return {
            "prefill_compiles": len(self._prefill_shapes),
            "decode_compiles": len(self._decode_shapes),
            "prefix_prefill_compiles": len(self._prefix_shapes),
            "cow_compiles": len(self._cow_shapes),
            "verify_compiles": len(self._verify_shapes),
        }

    def _clear_slot(self, slot: int) -> None:
        self._pending_prompt.pop(slot, None)
        n = int(self._nblk[slot])
        if n:
            self.blocks.free([int(b) for b in self._pt[slot, :n]])
        if self.drafter is not None:
            self.drafter.end(slot)
        self.allocator.free(slot)
        self._pt[slot, :] = 0
        self._nblk[slot] = 0
        self._budget[slot] = 0
        self._len[slot] = 0
        self._attn[slot] = 0
        self._active[slot] = False

    def release(self, slot: int) -> None:
        """Free the slot and DEREF its blocks. The table row points back
        at the garbage block; stale K/V in freed blocks is invisible to
        the next occupant (masked to its own written positions)."""
        self._clear_slot(slot)
        self._slot_trace.pop(slot, None)
        self._slot_seed.pop(slot, None)
        self._fork_n.pop(slot, None)

    def reset_epoch(self) -> None:
        """Interface parity with SlotEngine: no pool clock to rewind, so a
        no-op with every slot free (the prefix cache survives); raises
        with active slots."""
        if self.allocator.num_used:
            raise RuntimeError("reset_epoch with active slots")
