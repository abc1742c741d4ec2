"""Continuous-batching engine core (counterpart of
ddp_practice_tpu/serve/engine.py `EngineConfig`, `_sample_step`,
`warm_engine`, `_EngineBase` and `SlotEngine`).

Two operations over one slot pool (serve/kv_slots.py):

- `admit`: run a request's prompt, LEFT-padded to a bucket width, through
  a batch-1 scratch cache positioned to end at the pool cursor, then copy
  the scratch rows and the next-token logits into the pool at the slot;
- `step_burst`: `decode_burst` single-token steps over every slot: sample
  one token per slot from the carried logits, apply the model at s=1,
  carry the new logits. Free slots ride along emitting pad tokens. The
  host reads the burst's tokens back once, at its end.

Greedy decode is token-identical to the one-shot generator
(inference.make_generate_fn): both run the same `decode_apply`. Sampling
is per slot: each slot carries its own `torch.Generator`, seeded from the
request's seed at admission, so a request's tokens do not depend on what
else shares the batch.

The reference's XLA workarounds (`_await_dispatch`, `_decode_donate`)
have no counterpart: PyTorch runs eagerly on one stream and the pool is
updated in place. The paged engine (`PagedEngine`) is a later slice;
`EngineConfig` already carries its fields.
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
from ddp_practice_tpu_torch.serve.kv_slots import (
    SlotAllocator,
    set_cursor,
    write_slot,
)
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
    """One admit per bucket width in play and one decode burst each, then
    release and rewind: the reference's warmup recipe. Eager PyTorch has
    no programs to compile, but this also loads the CUDA kernels and
    warms the allocator outside any timed window."""
    for w in widths or engine.buckets:
        slot = engine.admit([1] * w,
                            max_positions=engine.config.decode_burst)
        engine.step_burst()
        engine.release(slot)
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
