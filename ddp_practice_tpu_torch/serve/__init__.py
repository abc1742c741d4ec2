"""serve/: continuous-batching inference on the card (counterpart of
ddp_practice_tpu/serve). This slice ports the slot engine path:

- kv_slots.py  — the slot-based KV-cache pool and its free list;
- engine.py    — EngineConfig and SlotEngine: bucketed prefill-admit and
  batched single-token decode bursts;
- scheduler.py — FIFO admission, deadlines, shedding, EOS/length release;
- bench.py     — serve_bench: one Poisson trace through the continuous
  server and the static-batch baseline.
"""

from ddp_practice_tpu_torch.serve.engine import EngineConfig, SlotEngine
from ddp_practice_tpu_torch.serve.scheduler import (
    Completion,
    FakeClock,
    Request,
    Scheduler,
)

__all__ = ["EngineConfig", "SlotEngine", "Scheduler", "Request",
           "Completion", "FakeClock"]
