"""serve/: continuous-batching inference on the card (counterpart of
ddp_practice_tpu/serve). Ported so far, the engine paths and the
in-process serving plane:

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
- faults.py    — the seeded, JSON-serialisable FaultPlan (crash /
  latency / nan_logits / admit_fail, and the worker fleet's kill);
- health.py    — per-replica HEALTHY/DEGRADED/DEAD with a circuit
  breaker and backed-off half-open probes;
- metrics.py   — TTFT/TPOT/queue/occupancy per replica and the fleet
  counters (retries, failovers, sheds by reason, breaker state,
  brown-out) over utils/metrics.py;
- slo.py       — SLO targets as multi-window burn rates, the watchdog
  that drives the router's brown-out, and the alert sinks;
- fairshare.py — virtual-token fair share, the tenant ledger, Jain's
  index;
- affinity.py  — prefix digests and the router's dispatch policies;
- router.py    — the fault-tolerant router over N SlotEngine replicas on
  one card: retries with backoff, crash failover by re-prefill,
  brown-out, exactly-once token streams;
- bench.py     — serve_bench (continuous, static, paged and router
  rows, faults, SLO and the trace), shared_prefix_bench and
  spec_decode_bench.

The front door and QoS (ROADMAP A6b), the worker fleet (A6c) and the
telemetry exporter (A6d) are later slices.
"""

from ddp_practice_tpu_torch.serve.engine import (
    EngineConfig,
    PagedEngine,
    SlotEngine,
)
from ddp_practice_tpu_torch.serve.fairshare import (
    TenantLedger,
    VirtualTokenCounter,
    federate_tenant_reports,
    jains_index,
)
from ddp_practice_tpu_torch.serve.faults import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    ReplicaCrashed,
)
from ddp_practice_tpu_torch.serve.health import (
    BreakerConfig,
    CircuitBreaker,
    HealthState,
    ReplicaHealth,
)
from ddp_practice_tpu_torch.serve.kv_pages import (
    BlockAllocator,
    RadixPrefixCache,
)
from ddp_practice_tpu_torch.serve.kv_slots import SlotAllocator
from ddp_practice_tpu_torch.serve.metrics import (
    FrontdoorMetrics,
    RouterMetrics,
    ServeMetrics,
)
from ddp_practice_tpu_torch.serve.router import (
    Router,
    RouterConfig,
    make_router,
)
from ddp_practice_tpu_torch.serve.scheduler import (
    Completion,
    FakeClock,
    MonotonicClock,
    Request,
    Scheduler,
)
from ddp_practice_tpu_torch.serve.slo import (
    AlertSinks,
    AlertSinkSpec,
    FleetAlerts,
    SLOConfig,
    SLOWatchdog,
    TenantSLORegistry,
)
from ddp_practice_tpu_torch.serve.spec import DraftSource, PromptLookupDraft

__all__ = [
    "AlertSinkSpec",
    "AlertSinks",
    "BlockAllocator",
    "BreakerConfig",
    "CircuitBreaker",
    "Completion",
    "DraftSource",
    "EngineConfig",
    "FakeClock",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "FleetAlerts",
    "FrontdoorMetrics",
    "HealthState",
    "MonotonicClock",
    "PagedEngine",
    "PromptLookupDraft",
    "RadixPrefixCache",
    "ReplicaCrashed",
    "ReplicaHealth",
    "Request",
    "Router",
    "RouterConfig",
    "RouterMetrics",
    "SLOConfig",
    "SLOWatchdog",
    "Scheduler",
    "ServeMetrics",
    "SlotAllocator",
    "SlotEngine",
    "TenantLedger",
    "TenantSLORegistry",
    "VirtualTokenCounter",
    "federate_tenant_reports",
    "jains_index",
    "make_router",
]
