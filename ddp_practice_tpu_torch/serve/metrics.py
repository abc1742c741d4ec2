"""Serving observability: TTFT / TPOT / queue depth / occupancy / tok/s.

(Host-pure Python: a copy of ddp_practice_tpu/serve/metrics.py with its
imports pointed at the port's registry and logging: the port imports
nothing of the reference package.)

A thin adapter between the scheduler's lifecycle hooks and the generic
registry (utils/metrics.py). The scheduler calls `on_submit` /
`on_tick` / `on_complete`; this class names the metrics and decides
what is a counter vs a gauge vs a distribution:

- ``serve_ttft_s`` (histogram): arrival -> first generated token, the
  user-perceived responsiveness number continuous batching exists to
  protect (a queued request's clock runs while it waits);
- ``serve_tpot_s`` (histogram): mean inter-token latency after the
  first token — the streaming smoothness number;
- ``serve_queue_depth`` / ``serve_slot_occupancy`` (gauges): the two
  saturation signals (queue growing = shed soon; occupancy < 1 with a
  queue = admission is the bottleneck);
- ``serve_tokens_total`` and per-status request counters.

`report(elapsed_s)` folds in tokens/sec; `emit()` logs one JSON line
through the process-0 gate (utils/logging.emit_metrics) so multi-host
replicas don't duplicate metric lines.
"""

from __future__ import annotations

from typing import Optional

from ddp_practice_tpu_torch.utils.logging import emit_metrics
from ddp_practice_tpu_torch.utils.metrics import MetricsRegistry, labelled


class ServeMetrics:
    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.ttft = r.histogram("serve_ttft_s")
        self.tpot = r.histogram("serve_tpot_s")
        self.queue_depth = r.gauge("serve_queue_depth")
        self.slot_occupancy = r.gauge("serve_slot_occupancy")
        # paged-engine pool gauges (serve/kv_pages.py): block occupancy
        # is the paged saturation signal — slots can be free while
        # blocks are the binding constraint (long contexts) and vice
        # versa (many short requests). Stay 0 for the slot engine.
        self.block_occupancy = r.gauge("serve_block_occupancy")
        self.blocks_free = r.gauge("serve_blocks_free")
        # prefix-sharing / preemption observables: in-use and
        # SHARED (refcount > 1) block gauges, cumulative prefix-cache
        # hit/miss token counters (proof the radix cache earns its
        # keep), and block-aware preemption count. Exported as deltas
        # from the engine's own cumulative fields each tick, so they
        # ride /metrics and the telemetry JSONL like everything else.
        self.kv_blocks_in_use = r.gauge("kv_blocks_in_use")
        self.kv_blocks_shared = r.gauge("kv_blocks_shared")
        self.prefix_hit_tokens = r.counter("prefix_cache_hit_tokens_total")
        self.prefix_miss_tokens = r.counter("prefix_cache_miss_tokens_total")
        self.preemptions = r.counter("preemptions_total")
        self._last_hit = self._last_miss = self._last_preempt = 0
        # speculative decoding observables (serve/spec.py): drafted vs
        # accepted token counters, exported as deltas from the engine's
        # cumulative fields each tick. The fleet-wide accept rate is
        # accepted/drafted over any scrape window; per-request accept
        # rates live in flight records, not here.
        self.spec_drafted = r.counter("spec_drafted_tokens_total")
        self.spec_accepted = r.counter("spec_accepted_tokens_total")
        self._last_drafted = self._last_accepted = 0
        self.tokens_total = r.counter("serve_tokens_total")
        self.submitted = r.counter("serve_requests_submitted")

    # scheduler hooks ------------------------------------------------------
    def on_submit(self, scheduler) -> None:
        self.submitted.inc()
        self.queue_depth.set(len(scheduler.queue))

    def on_tick(self, scheduler) -> None:
        self.queue_depth.set(len(scheduler.queue))
        eng = scheduler.engine
        self.slot_occupancy.set(eng.num_active / eng.allocator.max_slots)
        blocks = getattr(eng, "blocks", None)  # PagedEngine only
        if blocks is not None:
            # blocks_available counts free + prefix-cache-evictable —
            # what admission actually gates on; a gauge built from the
            # raw free list would show a "full" pool whose cached
            # prefixes are one make_room away from being promisable
            allocatable = blocks.num_blocks - 1  # minus the garbage block
            available = eng.blocks_available
            self.block_occupancy.set(
                (allocatable - available) / allocatable
            )
            self.blocks_free.set(available)
            self.kv_blocks_in_use.set(blocks.num_used)
            self.kv_blocks_shared.set(blocks.num_shared)
            preempt = getattr(eng, "preemptions", 0)
            self.preemptions.inc(preempt - self._last_preempt)
            self._last_preempt = preempt
            radix = getattr(eng, "radix", None)
            if radix is not None:
                self.prefix_hit_tokens.inc(
                    radix.hit_tokens - self._last_hit
                )
                self.prefix_miss_tokens.inc(
                    radix.miss_tokens - self._last_miss
                )
                self._last_hit = radix.hit_tokens
                self._last_miss = radix.miss_tokens
        drafted = getattr(eng, "spec_drafted_tokens", 0)
        accepted = getattr(eng, "spec_accepted_tokens", 0)
        self.spec_drafted.inc(drafted - self._last_drafted)
        self.spec_accepted.inc(accepted - self._last_accepted)
        self._last_drafted = drafted
        self._last_accepted = accepted

    def on_complete(self, completion, scheduler) -> None:
        self.registry.counter(f"serve_requests_{completion.status}").inc()
        self.tokens_total.inc(len(completion.tokens))
        tenant = getattr(completion, "tenant", None)
        if tenant is not None:
            # per-tenant attribution, behind the labelled() cardinality
            # guard: past the per-label limit an adversarial flood of
            # tenant ids lands in tenant="other" instead of growing the
            # registry without bound
            self.registry.counter(labelled(
                "serve_tenant_requests_total",
                tenant=tenant, status=completion.status)).inc()
            self.registry.counter(labelled(
                "serve_tenant_tokens_total", tenant=tenant)).inc(
                    len(completion.tokens))
        # exemplar = the completion's trace_id: the latency histograms
        # in /metrics carry a per-bucket pointer back into the trace
        # timeline (render_text emits OpenMetrics `# {trace_id=...}`).
        # Only KEPT traces may be cited — an exemplar naming a
        # sampling-suppressed trace_id is a dead link by construction.
        ex = (completion.trace_id
              if getattr(completion, "trace_sampled", True) else None)
        if completion.ttft is not None:
            self.ttft.observe(completion.ttft, exemplar=ex)
        if completion.tpot is not None:
            self.tpot.observe(completion.tpot, exemplar=ex)

    # reporting ------------------------------------------------------------
    def report(self, elapsed_s: Optional[float] = None) -> dict:
        snap = self.registry.snapshot()
        if elapsed_s and elapsed_s > 0:
            snap["serve_tokens_per_sec"] = (
                self.tokens_total.value / elapsed_s
            )
        return snap

    def emit(self, elapsed_s: Optional[float] = None, logger=None):
        """One `metrics {...}` line on process 0 (None elsewhere)."""
        return emit_metrics(self.report(elapsed_s), logger)


# health-state gauge encoding (serve_replica_state{replica=i}): a gauge
# is a float, so the states get stable small ints. "removed" is the
# elastic-fleet terminal: a drained slot's gauge parks there instead of
# masquerading as a crash ("dead" pages someone; a scale-down must not)
STATE_CODES = {"healthy": 0.0, "degraded": 1.0, "dead": 2.0,
               "removed": 3.0}


class RouterMetrics:
    """Fleet-level observability for serve/router.py.

    Same registry idiom as ServeMetrics but for the router's concerns:
    retries/failovers (how often the fault machinery earns its keep),
    sheds BY REASON (queue_full vs brownout vs no_replica are three
    different operator actions), per-replica breaker state, and the
    brown-out gauge pair (active flag + the fleet-pressure signal that
    drives it).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.retries = r.counter("serve_retries_total")
        self.failovers = r.counter("serve_failovers_total")
        self.breaker_trips = r.counter("serve_breaker_trips_total")
        self.brownout_active = r.gauge("serve_brownout_active")
        self.fleet_pressure = r.gauge("serve_fleet_pressure")
        self.tokens_total = r.counter("serve_router_tokens_total")
        self.submitted = r.counter("serve_router_requests_submitted")
        # client-perceived latency ACROSS attempts (the per-replica
        # ServeMetrics only see their own attempt) — exemplar-fed, so
        # the fleet /metrics p99 bucket names an offending trace_id
        self.ttft = r.histogram("serve_router_ttft_s")
        self.tpot = r.histogram("serve_router_tpot_s")
        # elastic-fleet observables (serve/autoscaler.py): current
        # active size, warm standbys ready to promote, and the scale
        # ledger by direction x trigger (slo_burn vs queue_pressure up,
        # slo_resolved down — the labels an operator pivots on)
        self.fleet_size = r.gauge("fleet_size")
        self.standby_ready = r.gauge("standby_ready")

    def on_scale_event(self, direction: str, trigger: str) -> None:
        self.registry.counter(labelled(
            "scale_events_total", direction=direction, trigger=trigger
        )).inc()

    def on_shed(self, reason: str) -> None:
        self.registry.counter(
            labelled("serve_sheds_total", reason=reason)
        ).inc()

    def on_route(self, decision: str) -> None:
        """Dispatch-policy ledger: how often placement was won by cache
        affinity vs the load tiebreak vs the digestless fallback —
        the first thing to pivot on when fleet hit rate drifts."""
        self.registry.counter(labelled(
            "serve_route_decisions_total", decision=decision
        )).inc()

    def on_replica_state(self, replica: int, state: str) -> None:
        self.registry.gauge(
            labelled("serve_replica_state", replica=replica)
        ).set(STATE_CODES[state])

    def on_finalize(self, completion) -> None:
        self.registry.counter(
            f"serve_router_requests_{completion.status}"
        ).inc()
        self.tokens_total.inc(len(completion.tokens))
        # kept-only exemplars, same contract as ServeMetrics.on_complete
        ex = (completion.trace_id
              if getattr(completion, "trace_sampled", True) else None)
        if completion.ttft is not None:
            self.ttft.observe(completion.ttft, exemplar=ex)
        if completion.tpot is not None:
            self.tpot.observe(completion.tpot, exemplar=ex)
        tenant = getattr(completion, "tenant", None)
        if tenant is not None:
            # fleet-level per-tenant attribution: request/token counters
            # and a TTFT histogram per tenant, all behind the labelled()
            # cardinality guard (overflow tenants fold into "other")
            self.registry.counter(labelled(
                "serve_router_tenant_requests_total",
                tenant=tenant, status=completion.status)).inc()
            self.registry.counter(labelled(
                "serve_router_tenant_tokens_total", tenant=tenant)).inc(
                    len(completion.tokens))
            if completion.ttft is not None:
                self.registry.histogram(labelled(
                    "serve_router_tenant_ttft_s", tenant=tenant)).observe(
                        completion.ttft, exemplar=ex)

    def report(self) -> dict:
        return self.registry.snapshot()

    def emit(self, logger=None):
        return emit_metrics(self.report(), logger)


class FrontdoorMetrics:
    """Wire-surface observability for serve/frontdoor.py.

    Everything below the door is already measured (ServeMetrics per
    replica, RouterMetrics per fleet); this layer counts what only the
    door can see — HTTP responses by status code, admission refusals
    by reason, SSE frames shipped, and slow-consumer sheds. The
    generic `count` hook keeps the front door decoupled from metric
    naming: it labels and prefixes so the door just states facts
    ("http code=429", "admission_refused reason=rate").
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.sse_frames = r.counter("frontdoor_sse_frames_total")
        self.slow_consumer_sheds = r.counter(
            "frontdoor_slow_consumer_sheds_total")

    def count(self, what: str, **labels) -> None:
        self.registry.counter(
            labelled(f"frontdoor_{what}_total", **labels)
        ).inc()

    def report(self) -> dict:
        return self.registry.snapshot()

    def emit(self, logger=None):
        return emit_metrics(self.report(), logger)
