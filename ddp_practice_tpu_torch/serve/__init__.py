"""serve/: continuous-batching inference on the card (counterpart of
ddp_practice_tpu/serve). Ported so far, the engine paths:

- kv_slots.py  — the slot-based KV-cache pool and its free list;
- kv_pages.py  — the paged KV-cache pool: refcounted block allocator
  (block 0 the garbage block), radix prefix cache, in-place block scatter
  and copy;
- engine.py    — EngineConfig, SlotEngine and PagedEngine (prefix
  sharing, copy-on-write, block-aware preemption, chunked prefill,
  speculative decoding);
- spec.py      — the prompt-lookup drafter behind speculative decoding;
- scheduler.py — FIFO admission, deadlines, shedding, EOS/length release,
  preemption and the chunk pump;
- bench.py     — serve_bench (continuous, static and paged rows),
  shared_prefix_bench and spec_decode_bench.
"""

from ddp_practice_tpu_torch.serve.engine import (
    EngineConfig,
    PagedEngine,
    SlotEngine,
)
from ddp_practice_tpu_torch.serve.kv_pages import (
    BlockAllocator,
    RadixPrefixCache,
)
from ddp_practice_tpu_torch.serve.scheduler import (
    Completion,
    FakeClock,
    Request,
    Scheduler,
)
from ddp_practice_tpu_torch.serve.spec import DraftSource, PromptLookupDraft

__all__ = ["EngineConfig", "SlotEngine", "PagedEngine", "Scheduler",
           "Request", "Completion", "FakeClock", "BlockAllocator",
           "RadixPrefixCache", "DraftSource", "PromptLookupDraft"]
