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
- sse.py       — the Server-Sent Events codec (one StreamEvent, one
  frame) and its incremental parser;
- admission.py — per-tenant token buckets, concurrency caps and the
  weighted-fair gate at the door, on an injectable clock;
- frontdoor.py — the HTTP/SSE front door over Router.stream: one driver
  thread owns the router, an asyncio loop owns the sockets; typed
  refusals, slow-consumer shedding, graceful drain;
- workload.py  — seeded multi-tenant workload plans (Poisson, bursty and
  diurnal arrivals, heavy-tailed lengths, multi-turn sessions);
- rpc.py       — length-prefixed JSON frames over localhost TCP, the
  retrying client, push streams and the threaded server;
- worker.py    — one replica as an OS process (`python -m
  ddp_practice_tpu_torch.serve.worker --spec ...`) on the card by
  default, its engine warmed before its READY line;
- supervisor.py— worker lifecycles (spawn, waitpid, backoff restarts
  under a budget, drain, grow/shrink, reap_all) and RemoteReplicaHandle,
  the router's replica interface over the RPC wire; make_fleet_router;
- autoscaler.py— the elastic fleet: the SLO-burn / queue-pressure
  policy (trip fast, resolve slow, no reversal inside a hold window),
  the warm standby pool, and the Autoscaler the router ticks (warm
  promotion or cold spawn up, graceful drain down);
- bench.py     — serve_bench (continuous, static, paged and router
  rows, faults, SLO and the trace), shared_prefix_bench,
  spec_decode_bench, frontdoor_bench, qos_bench, fleet_bench,
  streaming_bench, cache_routing_bench and fleet_autoscale_bench.

The telemetry exporter, federation and fleet trace plane (ROADMAP A6d)
are a later slice.
"""

from ddp_practice_tpu_torch.serve.admission import (
    AdmissionController,
    TenantPolicy,
)
from ddp_practice_tpu_torch.serve.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    AutoscalerPolicy,
    StandbyPool,
)
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
from ddp_practice_tpu_torch.serve.frontdoor import (
    Frontdoor,
    FrontdoorConfig,
    RouterDriver,
    sse_request,
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
from ddp_practice_tpu_torch.serve.rpc import (
    RpcClient,
    RpcError,
    RpcServer,
    RpcTimeout,
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
from ddp_practice_tpu_torch.serve.supervisor import (
    RemoteReplicaHandle,
    Supervisor,
    SupervisorConfig,
    make_fleet_router,
)
from ddp_practice_tpu_torch.serve.worker import WorkerSpec
from ddp_practice_tpu_torch.serve.workload import TenantSpec, WorkloadPlan

__all__ = [
    "AdmissionController",
    "AlertSinkSpec",
    "AlertSinks",
    "Autoscaler",
    "AutoscalerConfig",
    "AutoscalerPolicy",
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
    "Frontdoor",
    "FrontdoorConfig",
    "FrontdoorMetrics",
    "HealthState",
    "MonotonicClock",
    "PagedEngine",
    "PromptLookupDraft",
    "RadixPrefixCache",
    "RemoteReplicaHandle",
    "ReplicaCrashed",
    "ReplicaHealth",
    "Request",
    "Router",
    "RouterConfig",
    "RouterDriver",
    "RouterMetrics",
    "RpcClient",
    "RpcError",
    "RpcServer",
    "RpcTimeout",
    "SLOConfig",
    "SLOWatchdog",
    "Scheduler",
    "ServeMetrics",
    "SlotAllocator",
    "SlotEngine",
    "StandbyPool",
    "Supervisor",
    "SupervisorConfig",
    "TenantLedger",
    "TenantPolicy",
    "TenantSLORegistry",
    "TenantSpec",
    "VirtualTokenCounter",
    "WorkerSpec",
    "WorkloadPlan",
    "federate_tenant_reports",
    "jains_index",
    "make_fleet_router",
    "make_router",
    "sse_request",
]
