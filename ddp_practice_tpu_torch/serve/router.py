"""Fault-tolerant router over N SlotEngine replicas.

(Host-pure Python: a copy of ddp_practice_tpu/serve/router.py with its
imports pointed at the port; `make_router` builds the replicas from the
port's `nn.Module`, whose weights the replicas share, each with its own
KV pool. The port imports nothing of the reference package.)

One SlotEngine is one card's batch; heavy traffic needs a fleet. This
router is the serving mirror of train/elastic.py: the training side
fails fast (watchdog) and recovers by checkpoint; the serving side
fails fast (circuit breaker, serve/health.py) and recovers by REQUEST
MIGRATION — a dead replica's in-flight requests are re-admitted on a
surviving replica as `prompt + tokens-generated-so-far`, a fresh
prefill that is token-identical under greedy decoding (the tokens
already streamed to the host were sampled from finite logits; decoding
is a pure function of the token prefix).

Dispatch is least-loaded, driven by the per-replica serve/metrics.py
gauges (queue depth + slot occupancy), preferring HEALTHY replicas over
DEGRADED ones. Failures are answered in layers:

- one bad completion (status "error": non-finite logits, transient
  admission failure) → bounded retry budget with exponential backoff +
  jitter (utils/backoff.py), on whichever replica is then least loaded;
- consecutive failures → breaker trips, replica goes DEAD, in-flight
  work migrates, half-open probes with backoff decide when it returns;
- fleet overload OR SLO burn → brown-out: when fleet pressure
  ((active + queued) / total slots) crosses `brownout_on`, or an
  attached SLO watchdog (serve/slo.py) has a burn-rate alert active —
  pressure is a proxy; a burning TTFT/error-rate SLO is the measured
  thing it stands for — low-priority requests (Request.priority >=
  shed_priority) are shed at the door AND out of replica queues, and
  new admissions get their `max_new_tokens` capped (degraded answers
  beat no answers); both revert only when pressure falls below
  `brownout_off` AND no SLO alert is active (hysteresis on both
  triggers, so the mode doesn't flap).

Every request ends in a defined terminal status — "eos"/"length" (ok),
"timeout" (deadline), "shed" (backpressure/brown-out), "rejected"
(malformed), or "error" (retry budget exhausted) — the chaos tests'
none-lost invariant. Time is injected (the schedulers' clock), so a
FaultPlan replay on FakeClock replicas is bit-for-bit deterministic.

Tracing (utils/trace.py, optional): the router stamps each request's
trace_id ONCE at intake and passes it through every retry/failover
re-admission, so a crash-migrated request's spans on the survivor join
the original timeline — the linkage the chaos tests assert. The router's
own lane (pid ROUTER_PID) records dispatch / retry / failover /
brown-out instants; per-replica spans come from the schedulers/engines.
Final completions carry a merged flight record: per-phase time summed
across attempts, stall_s = latency not spent on any replica (parked in
the retry heap, dead-replica gaps), plus retry/failover counts.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

from ddp_practice_tpu_torch.serve.engine import EngineConfig, SlotEngine
from ddp_practice_tpu_torch.serve.faults import FaultPlan, ReplicaCrashed
from ddp_practice_tpu_torch.serve.health import (
    BreakerConfig,
    HealthState,
    ReplicaHealth,
)
from ddp_practice_tpu_torch.serve.metrics import RouterMetrics, ServeMetrics
from ddp_practice_tpu_torch.serve.scheduler import (
    Completion,
    MonotonicClock,
    Request,
    Scheduler,
)
from ddp_practice_tpu_torch.utils.backoff import backoff_delay
from ddp_practice_tpu_torch.utils.metrics import MetricsRegistry
from ddp_practice_tpu_torch.utils.trace import (
    ROUTER_PID,
    TraceSampler,
    label_replica,
    label_router,
)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    # ---- retry budget (per request, for "error" completions)
    max_retries: int = 2
    retry_base_s: float = 0.02
    retry_factor: float = 2.0
    retry_max_s: float = 1.0
    retry_jitter: float = 0.5
    # stamped as Request.deadline when the client set none (None = no
    # per-request timeout)
    request_timeout_s: Optional[float] = None
    # ---- circuit breaker (consecutive "error"s; crashes trip instantly)
    trip_after: int = 3
    probe_base_s: float = 0.05
    probe_factor: float = 2.0
    probe_max_s: float = 5.0
    probe_jitter: float = 0.0
    # ---- brown-out (fleet pressure = (active + queued) / total slots)
    brownout_on: float = 1.5
    brownout_off: float = 0.75
    brownout_max_new: int = 16
    # priority classes >= this are shed while browned out (0 =
    # interactive traffic, never brown-out shed)
    shed_priority: int = 1
    # jitter seed root: per-request retry jitter folds in the rid, per-
    # replica probe jitter folds in the replica id — deterministic replay,
    # de-synchronized fleet
    seed: int = 0
    # ---- streaming delivery: expose a per-request TokenStream fed from
    # the replicas' TokenChunks (scheduler.py), with the exactly-once /
    # resume contract. False = end-of-request delivery only (the
    # overhead bench's control arm; chunks from replicas are drained
    # and discarded so handle state stays bounded).
    streaming: bool = True
    # ---- cache-aware dispatch: score HEALTHY replicas by expected
    # prefix-hit tokens from their published radix digests (affinity.py)
    # and dispatch by affinity minus a load penalty. Degrades to the
    # least-loaded sort wherever digests are absent/cold, so fleets of
    # non-paged engines behave byte-identically to cache_aware=False.
    cache_aware: bool = True
    # ---- weighted-fair service (serve/fairshare.py): when on,
    # make_router threads one VirtualTokenCounter through every
    # scheduler — queue heads go to the least-served tenant instead of
    # strict FIFO. Off (default) no VTC exists anywhere on the path, so
    # scheduling is byte-identical to the pre-fairness router.
    fair: bool = False


@dataclasses.dataclass
class _Tracked:
    """Router-side lifecycle of one client request across attempts."""

    req: Request
    budget: int                 # max_new_tokens after any brown-out cap
    prefix: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    retries: int = 0            # error retries consumed (bounded)
    failovers: int = 0          # crash migrations (not budget-bounded)
    done: bool = False
    # flight-record phase sums across attempts (sub-completion flights
    # accumulate here; _finalize derives stall_s as the residual)
    queue_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # speculative-decoding tallies summed the same way: a failover
    # mid-request keeps the dead attempt's drafted/accepted counts, so
    # the merged accept rate reflects the whole request
    spec_drafted: int = 0
    spec_accepted: int = 0
    # streaming splice point: len(prefix) at the CURRENT dispatch — a
    # chunk's attempt-local `start` plus this base is its absolute
    # offset in the client's output (the dedup key after failover)
    dispatch_base: int = 0
    # how the LAST dispatch picked its replica ("affinity" | "load" |
    # "fallback") and the prefix tokens the replicas actually served
    # from cache, summed across attempts — both surface in the flight
    # record so a trace can say WHY a request landed where it did
    route: Optional[str] = None
    prefix_hit_tokens: int = 0


@dataclasses.dataclass
class StreamEvent:
    """One edge on a TokenStream, in consumer order.

    `kind` is ``tokens`` (new output, never re-delivered), ``resumed``
    (a failover/retry splice happened HERE — the marker the exactly-once
    contract emits instead of duplicate or missing tokens), or ``end``
    (terminal, carries the request's final status — a brown-out shed
    mid-stream ends the stream with status "shed", never silence).
    `seq` is contiguous per stream from 0; `start` is the absolute
    token offset of `tokens[0]` in the client's output."""

    kind: str
    seq: int
    trace_id: Optional[str]
    t: float
    start: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: Optional[str] = None
    attrs: Optional[dict] = None


class TokenStream:
    """Per-request consumer stream with the exactly-once contract.

    The router appends StreamEvents as replica TokenChunks arrive;
    `delivered` counts absolute tokens handed to the consumer, and any
    chunk tokens at offsets below it are suppressed (counted in
    `suppressed`) — that is how a failover's re-decode of the salvaged
    prefix never reaches the consumer twice. `gaps` counts offsets
    that were skipped forward over (the chaos pin asserts 0: chunks
    and the salvage point ride the same worker frame, so the resume
    cursor can never outrun delivery). `resume_gap_s` sums the time
    the stream sat between a resume marker and its next token — the
    stall the flight record attributes to failover."""

    def __init__(self, rid: int, trace_id: Optional[str]) -> None:
        self.rid = rid
        self.trace_id = trace_id
        self.events: List[StreamEvent] = []
        self.delivered = 0
        self.closed = False
        self.status: Optional[str] = None
        # replica tokens suppressed by the dedup cursor (failover
        # re-decode of the salvaged prefix lands here — EXPECTED under
        # chaos; consumer-visible duplicates are structurally impossible
        # and re-checked from the event log by bench/check_stream)
        self.suppressed = 0
        self.gaps = 0
        self.resume_gap_s = 0.0
        self._resumed_at: Optional[float] = None

    @property
    def next_seq(self) -> int:
        return len(self.events)

    def tokens(self) -> List[int]:
        """The consumer's view: every delivered token, concatenated."""
        out: List[int] = []
        for ev in self.events:
            out.extend(ev.tokens)
        return out


class ReplicaHandle:
    """One IN-PROCESS replica: engine + scheduler + gauges + health, as
    the router sees it. The scheduler/engine pair is exactly the
    single-replica serving stack — the router composes, it does not
    reimplement.

    This class also DEFINES the narrow replica interface the Router
    drives — `submit` / `step` / `poll` / `evacuate` / `shed_queued`
    (the Scheduler.submit / completions-watermark seam) plus the
    load/capacity observables (`load`, `has_queue_space`, `max_slots`,
    `queue_len`, `active`, `fits_prompt`) and lifecycle edges
    (`probe_ok`, `restart`, `warmup`, `compile_stats`). The in-process
    implementation is direct calls; serve/supervisor.py's
    RemoteReplicaHandle implements the SAME interface over the
    serve/rpc.py wire to a worker OS process — the router cannot tell
    them apart, which is the whole point of the seam."""

    def __init__(self, rid: int, scheduler: Scheduler,
                 breaker: BreakerConfig = BreakerConfig()) -> None:
        self.id = rid
        self.scheduler = scheduler
        self.engine: SlotEngine = scheduler.engine
        self.health = ReplicaHealth(breaker)
        self.consumed = 0  # completions watermark (survives restarts)
        self.chunks_consumed = 0  # TokenChunk watermark (same contract)

    # --------------- the seam: submit down, completions watermark up
    def submit(self, req: Request) -> None:
        """Hand one (sub-)request to the replica. A shed/reject lands
        as a completion in the next poll — never an exception."""
        self.scheduler.submit(req)

    def step(self) -> None:
        """Advance the replica one tick. May raise ReplicaCrashed. A
        remote replica self-steps; its step() is the heartbeat/poll."""
        self.scheduler.step()

    def poll(self) -> List[Completion]:
        """Completions since the watermark (consume-once)."""
        comps = self.scheduler.completions
        new, self.consumed = comps[self.consumed:], len(comps)
        return new

    def poll_chunks(self) -> List:
        """TokenChunks since the chunk watermark (consume-once) — the
        streaming twin of poll(). The list is append-only across
        restarts, so the watermark never replays."""
        chunks = self.scheduler.chunks
        new = chunks[self.chunks_consumed:]
        self.chunks_consumed = len(chunks)
        return new

    def evacuate(self) -> List[tuple]:
        """(request, tokens_so_far, ftt, phases) for everything this
        replica held — the failover harvest (Scheduler.evacuate)."""
        return self.scheduler.evacuate()

    def shed_queued(self, min_priority: int,
                    covers=None, tenants=None) -> List[int]:
        """Shed queued requests with priority >= min_priority (the
        brown-out lever); returns their rids. `covers` (tenant -> bool)
        narrows the shed to the burning tenants' work — a tenant-scoped
        brown-out must never pay a compliant tenant's requests for a
        hostile tenant's burn. `tenants` is the remote seam's
        serializable rendering of the same scope; the in-process handle
        has the exact predicate, so it is ignored here. The shed
        completions are consumed HERE
        (watermark advanced): the router finalizes from the returned
        rids, so replaying them from poll() would double-book — worse,
        the rid may have been reused by then."""
        shed = self.scheduler.shed_queued(
            lambda r: r.priority >= min_priority
            and (covers is None or covers(r.tenant))
        )
        self.consumed = len(self.scheduler.completions)
        return [r.rid for r in shed]

    # ------------------------------------------------- observables
    @property
    def load(self) -> float:
        """Least-loaded dispatch signal: queue depth + occupied slots,
        read from the replica's ServeMetrics gauges (the ROADMAP's
        'metrics gauges are the routing signals'); falls back to direct
        scheduler state when the replica carries no metrics."""
        m = self.scheduler.metrics
        slots = self.engine.config.max_slots
        if m is not None:
            return m.queue_depth.value + m.slot_occupancy.value * slots
        return len(self.scheduler.queue) + self.engine.num_active

    @property
    def has_queue_space(self) -> bool:
        return len(self.scheduler.queue) < self.scheduler.max_queue

    @property
    def max_slots(self) -> int:
        return self.engine.config.max_slots

    @property
    def queue_len(self) -> int:
        return len(self.scheduler.queue)

    @property
    def active(self) -> int:
        return self.engine.num_active

    def fits_prompt(self, n_tokens: int) -> bool:
        """Can a prompt of n_tokens prefill here? Delegates to the
        engine's own feasibility probe (bucket-bounded, except the
        chunk-capable paged engine, which is capacity-bounded)."""
        probe = getattr(self.engine, "fits_prompt", None)
        if probe is not None:
            return probe(n_tokens)
        try:
            self.engine.bucket_for(n_tokens)
            return True
        except ValueError:
            return False

    @property
    def kv_summary(self) -> Optional[dict]:
        """KV/radix-cache summary + prefix digest, read straight off
        the engine — the in-process twin of the worker's `_kv_summary`
        heartbeat payload (same builder, affinity.kv_summary), so the
        router's affinity scorer works identically with and without
        the RPC seam. None for non-paged engines."""
        if getattr(self.engine, "radix", None) is None:
            return None
        if not hasattr(self, "_digest_pub"):
            from ddp_practice_tpu_torch.serve.affinity import DigestPublisher
            self._digest_pub = DigestPublisher(self.engine.radix)
        from ddp_practice_tpu_torch.serve.affinity import kv_summary
        return kv_summary(self.engine, self._digest_pub)

    # --------------------------------------------------- lifecycle
    def probe_ok(self, now: float) -> bool:
        """Half-open probe: is the replica reachable again? With an
        injected fault plan the answer is the plan's crash window; a
        replica that crashed for real (no injector) is assumed
        restartable — in-process, restart() rebuilds its device state."""
        inj = self.scheduler.fault_hook
        return inj is None or inj.alive(now)

    def restart(self) -> None:
        """Bring a probed-alive replica back: free every slot, rewind
        the pool clock. The scheduler's queue/running were already
        evacuated at death; its completions list (and our watermark)
        survive so no completion is double-consumed."""
        eng = self.engine
        for slot in list(eng.allocator.used_slots()):
            eng.release(slot)
        eng.reset_epoch()
        inj = self.scheduler.fault_hook
        if inj is not None:
            inj.revive()

    def warmup(self, widths: Optional[Sequence[int]] = None) -> None:
        """Run one admit per bucket and a decode burst outside any timed
        window (engine.warm_engine — the one recipe workers also use):
        the CUDA kernels load and the allocator warms there."""
        from ddp_practice_tpu_torch.serve.engine import warm_engine

        warm_engine(self.engine, widths)

    def compile_stats(self) -> dict:
        return self.engine.compile_stats()


class Router:
    """Least-loaded, health-checked dispatch over a replica fleet."""

    def __init__(self, schedulers: Sequence, *, clock=None,
                 config: RouterConfig = RouterConfig(),
                 metrics: Optional[RouterMetrics] = None,
                 tracer=None, slo=None, telemetry=None,
                 policy=None, vtc=None, ledger=None) -> None:
        """`schedulers` is the replica fleet: Scheduler objects (the
        in-process fleet — wrapped in ReplicaHandle here) and/or
        prebuilt handle objects implementing ReplicaHandle's replica
        interface (serve/supervisor.py RemoteReplicaHandle for worker
        OS processes). The router owns breaker POLICY either way: it
        (re)arms each handle's ReplicaHealth from its own config."""
        if not schedulers:
            raise ValueError("need at least one replica")
        self.clock = clock or getattr(schedulers[0], "clock", None)
        if self.clock is None:
            raise ValueError("pass clock= when building from handles")
        self.config = config
        self.metrics = metrics or RouterMetrics()
        self.tracer = tracer
        # optional serve/slo.py SLOWatchdog: fed every finalized
        # completion, evaluated once per tick; while it alerts, brown-out
        # engages regardless of fleet pressure (_update_brownout)
        self.slo = slo
        # optional utils/telemetry.py TelemetryExporter (or anything with
        # on_completion): streams one "flight" line per finalization and
        # feeds the /flight rolling window
        self.telemetry = telemetry
        # optional serve/fairshare.py pair: the VirtualTokenCounter the
        # schedulers charge (kept here for introspection — /tenants,
        # the bench's service report) and the TenantLedger fed one
        # on_completion per finalization (cost metering)
        self.vtc = vtc
        self.ledger = ledger
        # tenant scope of the CURRENT brown-out: None = global (pressure
        # trip, or an slo= without per-tenant queries); a tuple of
        # burning tenant names = shed/door-shed only their work
        self._brownout_scope = None
        if tracer is not None:
            label_router(tracer)
        self.handles = []
        for i, item in enumerate(schedulers):
            bcfg = BreakerConfig(
                trip_after=config.trip_after,
                probe_base_s=config.probe_base_s,
                probe_factor=config.probe_factor,
                probe_max_s=config.probe_max_s,
                probe_jitter=config.probe_jitter,
                seed=config.seed + i,
            )
            if isinstance(item, Scheduler):
                h = ReplicaHandle(i, item, bcfg)
            else:
                h = item
                h.health = ReplicaHealth(bcfg)
            self.handles.append(h)
        # dispatch policy seam: anything with order(cands, prompt, now)
        # -> (ordered, decisions, expected_hits) and forget(replica_id).
        # Default is digest-driven affinity (which itself degrades to
        # the least-loaded sort when no digest is usable); pass an
        # explicit policy= to override both.
        if policy is None:
            from ddp_practice_tpu_torch.serve.affinity import (
                AffinityPolicy, LeastLoadedPolicy,
            )
            policy = (AffinityPolicy() if config.cache_aware
                      else LeastLoadedPolicy())
        self.policy = policy
        self.tracked: Dict[int, _Tracked] = {}
        self.completions: List[Completion] = []
        # streaming registry: rid -> TokenStream, created at intake,
        # closed by _finalize's typed end event. Closed streams stay
        # until the consumer takes them (the bench reads/clears per
        # rep) — the same accumulate-and-consume contract as
        # `completions`.
        self.streams: Dict[int, TokenStream] = {}
        self._streaming = config.streaming
        self.brownout = False
        self._pending = 0
        self._retry_q: List[tuple] = []  # (ready_at, seq, rid) heap
        self._retry_seq = 0
        # optional serve/autoscaler.py Autoscaler: evaluated once per
        # tick right after the SLO watchdog (its trip/resolve signals
        # are the autoscaler's inputs, so they must be fresh)
        self.autoscaler = None
        for h in self.handles:
            self.metrics.on_replica_state(h.id, h.health.state.value)

    # ------------------------------------------------- elastic membership
    def add_handle(self, h) -> None:
        """Join a NEW replica handle mid-run (autoscaler grow): armed
        with the same breaker policy __init__ applies, seeded by its
        stable slot id so probe jitter stays deterministic per slot."""
        bcfg = BreakerConfig(
            trip_after=self.config.trip_after,
            probe_base_s=self.config.probe_base_s,
            probe_factor=self.config.probe_factor,
            probe_max_s=self.config.probe_max_s,
            probe_jitter=self.config.probe_jitter,
            seed=self.config.seed + h.id,
        )
        h.health = ReplicaHealth(bcfg)
        self.handles.append(h)
        self.metrics.on_replica_state(h.id, h.health.state.value)

    def remove_handle(self, h) -> None:
        """Retire a replica handle mid-run (autoscaler shrink, after
        the drain). Anything it still holds is flushed and salvaged —
        chunks first so the delivery cursor is current, then leftovers
        re-dispatch on survivors — so removal can never strand a
        stream, even when the drain was cut short."""
        if h not in self.handles:
            return
        self._ingest_chunks(h)
        self._consume(h)
        for req, tokens, ftt, phases in h.evacuate():
            tr = self.tracked.get(req.rid)
            if tr is None or tr.done:
                continue
            tr.queue_s += phases["queue_s"]
            tr.prefill_s += phases["prefill_s"]
            tr.decode_s += phases["decode_s"]
            tr.prefix.extend(tokens)
            if tr.first_token_time is None:
                tr.first_token_time = ftt
            tr.failovers += 1
            self.metrics.failovers.inc()
            if not self._dispatch(tr):
                self._park_or_shed(tr)
        self.handles.remove(h)
        # drop its digest view: the slot is gone, and rendezvous
        # placement over the surviving ids re-homes its sticky families
        self.policy.forget(h.id)
        self.metrics.on_replica_state(h.id, "removed")

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> bool:
        """Route one request; False = terminal at the door (shed or
        rejected — a completion exists either way, never silence)."""
        if req.arrival is None:
            req.arrival = self.clock.now()
        if req.rid in self.tracked:
            raise ValueError(f"duplicate rid {req.rid}")
        if req.trace_id is None:
            # stamped ONCE here: every retry/failover re-admission below
            # reuses it, so a migrated request is one timeline
            req.trace_id = f"r{req.rid}"
        if self.tracer is not None:
            # the head-sampling decision, stamped once with the trace_id
            # and propagated to every sub-request (and across the RPC
            # seam) — workers honor it instead of re-deciding
            req.sampled = self.tracer.begin_trace(req.trace_id,
                                                  req.sampled,
                                                  tenant=req.tenant)
        cfg = self.config
        if req.deadline is None and cfg.request_timeout_s is not None:
            req.deadline = req.arrival + cfg.request_timeout_s
        self.metrics.submitted.inc()
        budget = req.max_new_tokens
        if req.max_new_tokens < 1:
            # malformed beats browned-out: "rejected" is terminal advice
            # (never resubmit), "shed" invites a retry that can only fail
            self._finalize(self._track(req, budget), [], "rejected")
            return False
        if self.brownout and self._brownout_covers(req.tenant):
            if req.priority >= cfg.shed_priority:
                tr = self._track(req, budget)
                # slo_exempt: this shed IS the brown-out response — if
                # the watchdog counted it as an availability failure,
                # the controller would feed its own alert and never
                # disengage (positive-feedback latch)
                self._finalize(tr, [], "shed", slo_exempt=True)
                self.metrics.on_shed("brownout")
                return False
            budget = min(budget, cfg.brownout_max_new)
        tr = self._track(req, budget)
        if not self._dispatch(tr):
            self._finalize(tr, [], "shed")
            self.metrics.on_shed(
                "no_replica" if not self._alive() else "fleet_full"
            )
            return False
        return True

    def _track(self, req: Request, budget: int) -> _Tracked:
        tr = _Tracked(req=req, budget=budget)
        self.tracked[req.rid] = tr
        self._pending += 1
        if self._streaming:
            self.streams[req.rid] = TokenStream(req.rid, req.trace_id)
        return tr

    def stream(self, rid: int) -> Optional["TokenStream"]:
        """The consumer handle for one request's TokenStream (None when
        streaming is off or the rid was never submitted)."""
        return self.streams.get(rid)

    # --------------------------------------------------------- streaming
    def _stream_emit(self, st: TokenStream, kind: str, *, start: int = 0,
                     tokens=(), status: Optional[str] = None,
                     attrs: Optional[dict] = None) -> StreamEvent:
        now = self.clock.now()
        ev = StreamEvent(
            kind=kind, seq=st.next_seq, trace_id=st.trace_id, t=now,
            start=start, tokens=list(tokens), status=status, attrs=attrs,
        )
        st.events.append(ev)
        if kind == "resumed":
            if st._resumed_at is None:
                st._resumed_at = now
            if self.tracer is not None:
                # a resume splice is a tail keep-rule of its own: the
                # staged timeline promotes the moment the consumer saw
                # the seam, not at completion
                self.tracer.note_keep(st.trace_id, "resumed")
        elif st._resumed_at is not None:
            # the resume gap closes at the next consumer-visible edge
            # (first post-splice tokens, or the end if none ever came) —
            # the stall the flight record books as resume_gap_s
            st.resume_gap_s += now - st._resumed_at
            st._resumed_at = None
        if kind == "end":
            st.closed = True
            st.status = status
        emit = getattr(self.telemetry, "emit", None)
        if emit is not None:
            # one JSONL line per stream event: the offline exactly-once
            # audit trail (tools/check_stream.py) — contiguous seq per
            # trace_id, one terminal, original trace_id across failover
            emit("chunk", trace_id=st.trace_id, rid=st.rid, seq=ev.seq,
                 event=kind, start=ev.start, n=len(ev.tokens),
                 status=status)
        return ev

    def _stream_tokens(self, st: TokenStream, gstart: int,
                       toks: List[int]) -> None:
        """Feed replica chunk tokens at absolute offset `gstart` through
        the dedup cursor: only tokens past `delivered` reach the
        consumer, re-decoded salvage is suppressed, and a forward skip
        (structurally impossible — chunks and the salvage point share a
        frame) is counted as a gap rather than hidden."""
        if st.closed or not toks:
            return
        end = gstart + len(toks)
        if end <= st.delivered:
            st.suppressed += len(toks)
            return
        if gstart > st.delivered:
            st.gaps += gstart - st.delivered
            start = gstart
        else:
            st.suppressed += st.delivered - gstart
            start = st.delivered
        self._stream_emit(st, "tokens", start=start,
                          tokens=toks[start - gstart:])
        st.delivered = end

    def _ingest_chunks(self, h) -> None:
        """Drain one handle's TokenChunks into the streams. Runs even
        with streaming off (the handle's pending buffer must not grow
        unbounded); chunk-level `final` markers are scheduler-attempt
        scoped and deliberately ignored here — the ROUTER owns the
        terminal event (_finalize), because a sub-attempt's "error"
        final is a retry, not an ending, from the consumer's seat."""
        poll = getattr(h, "poll_chunks", None)
        if poll is None:
            return
        chunks = poll()
        if not self._streaming:
            return
        for ch in chunks:
            st = self.streams.get(ch.rid)
            if st is None or st.closed:
                continue
            tr = self.tracked.get(ch.rid)
            base = tr.dispatch_base if tr is not None else 0
            self._stream_tokens(st, base + ch.start, list(ch.tokens))

    # ---------------------------------------------------------- dispatch
    def _alive(self) -> List[ReplicaHandle]:
        return [h for h in self.handles if h.health.alive]

    def _dispatch(self, tr: _Tracked) -> bool:
        """Place (or re-place) a tracked request on the best replica.
        False = nowhere to put it right now (caller sheds or requeues)."""
        remaining = tr.budget - len(tr.prefix)
        if remaining <= 0:
            # a migrated request that already produced its whole budget
            self._finalize(tr, list(tr.prefix), "length",
                           tr.first_token_time)
            return True
        cands = [h for h in self._alive() if h.has_queue_space]
        if not cands:
            return False
        req = tr.req
        # the dispatch-policy seam: affinity scoring over the replicas'
        # published prefix digests when usable, the classic HEALTHY-
        # before-DEGRADED least-loaded sort otherwise (LeastLoadedPolicy
        # and the cold-digest fallback produce the identical order)
        cands, decisions, exp = self.policy.order(
            cands, req.prompt, self.clock.now()
        )
        for h in cands:
            if tr.prefix:
                if not h.fits_prompt(len(req.prompt) + len(tr.prefix)):
                    # prompt+prefix outgrew every prefill bucket (a long
                    # generation migrated late): drop the salvage and
                    # regenerate from the original prompt — it fit once,
                    # it fits again, and a deterministic decode
                    # reproduces the same tokens (the per-request PRNG
                    # chain restarts from the request seed). Recompute
                    # beats a lost request.
                    tr.prefix = []
                    remaining = tr.budget
            # the splice point for this attempt's chunks: attempt-local
            # chunk offsets + this base = absolute position in the
            # client's output (the stream dedup key)
            tr.dispatch_base = len(tr.prefix)
            sub = Request(
                rid=req.rid,
                # failover/retry resume: the tokens already produced ARE
                # the continuation — re-admitting prompt+prefix as a
                # fresh prefill reproduces the remaining tokens exactly
                # under greedy decoding
                prompt=list(req.prompt) + list(tr.prefix),
                max_new_tokens=remaining,
                deadline=req.deadline,
                seed=req.seed,
                arrival=req.arrival,
                priority=req.priority,
                # the ORIGINAL trace_id: the survivor's spans join the
                # migrated request's timeline (tests/test_trace.py)
                trace_id=req.trace_id,
                # a request that already retried / failed over IS the
                # anomaly tail sampling exists to keep: upgrade the
                # decision so the post-fault attempt records fully on
                # the worker (its pre-fault spans were tail-promoted by
                # the retry/failover markers)
                sampled=(True if (tr.retries or tr.failovers)
                         else req.sampled),
                tenant=req.tenant,
                # per-request sampling overrides ride every dispatch —
                # a failover re-admission must sample under the SAME
                # params or the spliced stream changes distribution
                temperature=req.temperature,
                top_k=req.top_k,
                top_p=req.top_p,
            )
            # stamp the dispatch time BEFORE the submit hop: a remote
            # worker can queue and even start prefill while the RPC is
            # still in flight, and a post-submit stamp would put the
            # dispatch instant AFTER the worker's spans — backwards
            # causality the fleet validator rightly rejects
            rec = self.tracer
            t_dispatch = (rec.now() if rec is not None and rec.enabled
                          else None)
            h.submit(sub)
            if getattr(h, "last_submit_refused", False):
                # a DRAINING worker refused at the door — typed and
                # certain, not a fault: try the next candidate instead
                # of writing the replica off (it is finishing in-flight
                # streams and will exit on its own)
                continue
            tr.route = decisions.get(h.id, "fallback")
            self.metrics.on_route(tr.route)
            if t_dispatch is not None:
                rec.record_instant(
                    "dispatch", t_dispatch, trace_id=req.trace_id,
                    pid=ROUTER_PID,
                    attrs={"replica": h.id,
                           "attempt": tr.retries + tr.failovers,
                           "salvaged": len(tr.prefix),
                           "route": tr.route,
                           "affinity_tokens": exp.get(h.id, 0)},
                )
            return True
        return False

    def _requeue(self, tr: _Tracked, delay_s: float) -> None:
        now = self.clock.now()
        deadline = tr.req.deadline
        if deadline is not None and now + delay_s > deadline:
            self._finalize(tr, list(tr.prefix), "timeout",
                           tr.first_token_time)
            return
        self._retry_seq += 1
        heapq.heappush(
            self._retry_q, (now + delay_s, self._retry_seq, tr.req.rid)
        )

    # ----------------------------------------------------------- the tick
    def step(self) -> List[Completion]:
        """One fleet tick: probe dead replicas, step the live ones
        (crashes trigger failover), consume completions (errors retry),
        drain due retries, update brown-out. Returns the client
        completions finalized during this tick."""
        before = len(self.completions)
        t_start = self.clock.now()
        self._probe_dead()
        for h in self.handles:
            if not h.health.alive:
                continue
            try:
                h.step()
            except ReplicaCrashed:
                self._kill(h)
        for h in self.handles:
            # chunks BEFORE completions: the dedup cursor must be
            # current when the terminal flush measures what is left
            self._ingest_chunks(h)
            self._consume(h)
        self._drain_retries()
        if self.slo is not None:
            self.slo.evaluate(self.clock.now())
        if self.autoscaler is not None:
            # after the SLO pass (burn rates fresh), before brown-out
            # (a grow this tick relieves the very pressure brown-out
            # would otherwise respond to)
            self.autoscaler.step(self.clock.now())
        self._update_brownout()
        if self.clock.now() == t_start:
            # nothing decoded this tick (fleet idle/dead): advance
            # virtual time anyway so retry backoffs and probe timers can
            # ever come due under FakeClock (no-op on the real clock)
            self.clock.tick()
        return self.completions[before:]

    def _probe_dead(self) -> None:
        now = self.clock.now()
        for h in self.handles:
            if h.health.alive or not h.health.probe_due(now):
                continue
            ok = h.probe_ok(now)
            h.health.on_probe(ok, now)
            if ok:
                h.restart()
                # the new incarnation's radix is cold: drop the digest
                # view so affinity can't route on the dead cache's
                # fingerprint (a stale digest costs a miss, never
                # correctness — but why pay the miss on purpose)
                self.policy.forget(h.id)
                if self.tracer is not None and self.tracer.enabled:
                    self.tracer.instant("replica_restart", pid=ROUTER_PID,
                                        replica=h.id)
            self.metrics.on_replica_state(h.id, h.health.state.value)

    def _kill(self, h: ReplicaHandle) -> None:
        """Replica death: trip the breaker and migrate everything it
        held — in-flight requests resume from their salvaged tokens."""
        now = self.clock.now()
        h.health.mark_dead(now)
        self.policy.forget(h.id)  # its warm cache died with it
        self.metrics.breaker_trips.inc()
        self.metrics.on_replica_state(h.id, h.health.state.value)
        rec = self.tracer
        if rec is not None and rec.enabled:
            rec.instant("replica_dead", pid=ROUTER_PID, replica=h.id)
        # flush chunks the dead replica already published: they rode
        # the same frames as the salvage point below, so after this the
        # delivery cursor and the resume cursor agree — the survivor's
        # re-decode dedups exactly, no duplicate and no gap
        self._ingest_chunks(h)
        for req, tokens, ftt, phases in h.evacuate():
            tr = self.tracked.get(req.rid)
            if tr is None or tr.done:
                continue
            # fold the dead attempt's on-replica time into the flight
            # record — no Completion will ever report it (evacuated
            # attempts don't finish), and without this the pre-crash
            # decode work would show up as stall_s
            tr.queue_s += phases["queue_s"]
            tr.prefill_s += phases["prefill_s"]
            tr.decode_s += phases["decode_s"]
            tr.prefix.extend(tokens)
            if tr.first_token_time is None:
                tr.first_token_time = ftt
            tr.failovers += 1
            self.metrics.failovers.inc()
            st = self.streams.get(req.rid)
            if st is not None and not st.closed:
                # the consumer sees a marker at the splice, never a
                # duplicate and never a hole — the exactly-once edge
                self._stream_emit(st, "resumed", attrs={
                    "reason": "failover", "from_replica": h.id,
                    "salvaged": len(tokens),
                })
            if rec is not None and rec.enabled:
                rec.instant("failover", trace_id=req.trace_id,
                            pid=ROUTER_PID, from_replica=h.id,
                            salvaged=len(tokens))
            if not self._dispatch(tr):
                self._park_or_shed(tr)

    def _consume(self, h: ReplicaHandle) -> None:
        now = self.clock.now()
        for c in h.poll():
            tr = self.tracked.get(c.rid)
            if tr is None or tr.done:
                continue  # e.g. brown-out sheds already finalized
            if c.flight is not None:
                # fold this attempt's on-replica phases into the merged
                # flight record (_finalize derives stall_s as residual)
                tr.queue_s += c.flight["queue_s"]
                tr.prefill_s += c.flight["prefill_s"]
                tr.decode_s += c.flight["decode_s"]
                tr.spec_drafted += c.flight.get("spec_drafted", 0)
                tr.spec_accepted += c.flight.get("spec_accepted", 0)
                tr.prefix_hit_tokens += c.flight.get(
                    "prefix_hit_tokens", 0)
            if tr.first_token_time is None and c.ttft is not None:
                tr.first_token_time = tr.req.arrival + c.ttft
            if c.status == "refused":
                # one-way submit reconciled as a DRAINING refusal
                # (supervisor._reconcile_confirm): typed and certain,
                # not a fault — re-dispatch on the next candidate
                # without a breaker mark or a retry charge, exactly
                # like the synchronous last_submit_refused skip
                if not self._dispatch(tr):
                    self._park_or_shed(tr)
                continue
            if c.status in ("eos", "length"):
                h.health.mark_success()
                self._finalize(tr, tr.prefix + c.tokens, c.status,
                               tr.first_token_time)
            elif c.status == "timeout":
                self._finalize(tr, tr.prefix + c.tokens, "timeout",
                               tr.first_token_time)
            elif c.status == "rejected":
                # malformed for this engine config (prompt over every
                # bucket / budget over the pool): identical replicas
                # would all reject it — not retryable
                self._finalize(tr, list(tr.prefix), "rejected")
            else:  # "error" (and the defensive "shed" path): retryable
                if h.health.mark_failure(now):
                    self._kill(h)  # trip: migrate the rest of its work
                self.metrics.on_replica_state(h.id, h.health.state.value)
                tr.prefix.extend(c.tokens)
                if tr.retries >= self.config.max_retries:
                    self._finalize(tr, list(tr.prefix), "error",
                                   tr.first_token_time)
                    continue
                tr.retries += 1
                self.metrics.retries.inc()
                st = self.streams.get(c.rid)
                if st is not None and not st.closed:
                    # an error retry is a resume point too: tokens
                    # already streamed stay delivered, the re-decode on
                    # the next replica dedups against them
                    self._stream_emit(st, "resumed", attrs={
                        "reason": "retry", "replica": h.id,
                        "salvaged": len(tr.prefix),
                    })
                cfg = self.config
                delay = backoff_delay(
                    tr.retries - 1, base_s=cfg.retry_base_s,
                    factor=cfg.retry_factor, max_s=cfg.retry_max_s,
                    jitter=cfg.retry_jitter, seed=cfg.seed + c.rid,
                )
                rec = self.tracer
                if rec is not None and rec.enabled:
                    rec.instant("retry", trace_id=tr.req.trace_id,
                                pid=ROUTER_PID, replica=h.id,
                                attempt=tr.retries, delay_s=delay)
                self._requeue(tr, delay)

    def _drain_retries(self) -> None:
        now = self.clock.now()
        while self._retry_q and self._retry_q[0][0] <= now:
            _, _, rid = heapq.heappop(self._retry_q)
            tr = self.tracked.get(rid)
            if tr is None or tr.done:
                continue
            deadline = tr.req.deadline
            if deadline is not None and now > deadline:
                self._finalize(tr, list(tr.prefix), "timeout",
                               tr.first_token_time)
                continue
            if not self._dispatch(tr):
                # still nowhere to go: shed or park, then stop draining
                # (the fleet state won't change within this tick)
                self._park_or_shed(tr)
                break

    def _park_or_shed(self, tr: _Tracked) -> None:
        """A request with nowhere to run: queues full on a live fleet is
        TRANSIENT (they drain as decode proceeds — park it for one
        backoff), but a fleet with no alive replica gets the same answer
        the front door gives (submit): an immediate terminal shed. The
        fast no keeps the none-lost invariant even when every replica is
        permanently dead — parking there would cycle the retry heap
        forever and hang run_until_idle / the bench loop."""
        if not self._alive():
            self._finalize(tr, list(tr.prefix), "shed")
            self.metrics.on_shed("no_replica")
        else:
            self._requeue(tr, self.config.retry_base_s)

    # --------------------------------------------------------- brown-out
    def _brownout_covers(self, tenant) -> bool:
        """Whether the active brown-out applies to `tenant`'s work.
        Global scope (pressure trip, or an slo= object without
        per-tenant queries) covers everyone; an SLO-scoped brown-out
        covers only the burning tenants — the compliant tenant keeps
        its full budget and its queue slots."""
        if self._brownout_scope is None:
            return True
        is_b = getattr(self.slo, "is_burning", None)
        if is_b is None:
            return True
        return bool(is_b(tenant))

    def _shed_brownout_queued(self, covers=None) -> None:
        """Shed low-priority WAITERS too, not just new arrivals — the
        queue backlog is exactly the overload being answered.
        (shed_queued consumes its own sub-completions — replaying
        them from poll() would double-book against whatever
        request is tracked under the rid by then.)

        Scoped sheds ride the seam twice: `covers` (the exact
        registry-backed predicate, overflow fold included) for
        in-process handles, and the raw scope NAMES for remote ones —
        a callable cannot cross the RPC wire, so the worker matches
        folded tenant names instead. The one divergence (an "other"
        overflow scope names no raw tenant remotely) self-heals via
        the escalation path."""
        tenants = (None if covers is None
                   else list(self._brownout_scope or ()))
        for h in self._alive():
            for rid in h.shed_queued(self.config.shed_priority,
                                     covers=covers, tenants=tenants):
                tr = self.tracked.get(rid)
                if tr is not None and not tr.done:
                    # slo_exempt: see submit() — the brown-out's own
                    # sheds must not burn the SLO that drives it
                    self._finalize(tr, list(tr.prefix), "shed",
                                   slo_exempt=True)
                    self.metrics.on_shed("brownout")

    def _update_brownout(self) -> None:
        """Brown-out has TWO triggers: fleet pressure (the
        occupancy heuristic) and SLO burn (serve/slo.py — pressure is a
        proxy; a burning TTFT/error-rate SLO is the measured thing the
        proxy stands for). Either engages it; disengage requires BOTH
        pressure under `brownout_off` and no active SLO alert — the
        pressure hysteresis band and the watchdog's trip/resolve
        asymmetry compose, so neither trigger can flap the mode.

        An SLO-only trip against a TenantSLORegistry is TENANT-SCOPED:
        only the burning tenants' low-priority work sheds (door and
        queues) — per-tenant budgets exist precisely so a hostile
        tenant's burn cannot cost the compliant tenant's requests. The
        scope tracks the burning set while engaged and ESCALATES to
        global if pressure later crosses `brownout_on` (overload is
        everyone's problem, whoever caused it)."""
        cfg = self.config
        alive = self._alive()
        slots = sum(h.max_slots for h in alive)
        work = sum(h.queue_len + h.active for h in alive)
        pressure = (work / slots) if slots else float("inf")
        self.metrics.fleet_pressure.set(min(pressure, 1e9))
        slo_burning = self.slo is not None and self.slo.active
        traced = self.tracer is not None and self.tracer.enabled
        burning_fn = getattr(self.slo, "burning_tenants", None)
        if not self.brownout and (pressure >= cfg.brownout_on
                                  or slo_burning):
            self.brownout = True
            scope = None
            if pressure < cfg.brownout_on and burning_fn is not None:
                scope = tuple(burning_fn())
            self._brownout_scope = scope
            self.metrics.brownout_active.set(1)
            if traced:
                attrs = dict(pressure=round(pressure, 3),
                             trigger=("pressure"
                                      if pressure >= cfg.brownout_on
                                      else "slo"))
                if scope is not None:
                    attrs["tenants"] = ",".join(scope)
                self.tracer.instant("brownout_on", pid=ROUTER_PID,
                                    **attrs)
            self._shed_brownout_queued(
                None if scope is None else self._brownout_covers)
        elif self.brownout and pressure <= cfg.brownout_off \
                and not slo_burning:
            self.brownout = False
            self._brownout_scope = None
            self.metrics.brownout_active.set(0)
            if traced:
                self.tracer.instant("brownout_off", pid=ROUTER_PID,
                                    pressure=round(pressure, 3))
        elif self.brownout and self._brownout_scope is not None:
            # engaged and tenant-scoped: keep the scope current
            if pressure >= cfg.brownout_on:
                # overload joined the party — escalate to global and
                # shed the backlog the scoped pass left untouched
                self._brownout_scope = None
                if traced:
                    self.tracer.instant("brownout_escalate",
                                        pid=ROUTER_PID,
                                        pressure=round(pressure, 3))
                self._shed_brownout_queued(None)
            elif burning_fn is not None:
                now_burning = tuple(burning_fn())
                newly = set(now_burning) - set(self._brownout_scope)
                self._brownout_scope = now_burning
                if newly:
                    # a tenant that STARTED burning mid-brown-out gets
                    # the same treatment the original offenders got
                    self._shed_brownout_queued(self._brownout_covers)

    # ---------------------------------------------------------- finalize
    def _finalize(self, tr: _Tracked, tokens: List[int], status: str,
                  first_token_time: Optional[float] = None,
                  slo_exempt: bool = False) -> Completion:
        now = self.clock.now()
        req = tr.req
        ttft = tpot = None
        if first_token_time is not None:
            ttft = first_token_time - req.arrival
            if len(tokens) > 1:
                tpot = (now - first_token_time) / (len(tokens) - 1)
        total = now - req.arrival
        flight = {
            "queue_s": tr.queue_s, "prefill_s": tr.prefill_s,
            "decode_s": tr.decode_s,
            # latency not spent on any replica: parked in the retry
            # heap, dead-replica gaps, pre-submit trace lateness
            "stall_s": max(
                0.0, total - tr.queue_s - tr.prefill_s - tr.decode_s
            ),
            "retries": tr.retries, "failovers": tr.failovers,
        }
        if tr.spec_drafted:
            flight["spec_drafted"] = tr.spec_drafted
            flight["spec_accepted"] = tr.spec_accepted
            flight["spec_accept_rate"] = tr.spec_accepted / tr.spec_drafted
        if tr.route is not None:
            # the routing decision behind this request's placement and
            # the prefix tokens its replicas served warm — the flight
            # record says WHY a request was fast (affinity hit) or not
            flight["route"] = tr.route
            flight["prefix_hit_tokens"] = tr.prefix_hit_tokens
        st = self.streams.get(req.rid)
        if st is not None and not st.closed:
            # flush the authoritative tail (tokens the completion holds
            # that never rode a chunk — at most the last burst), then
            # the typed end. A shed mid-stream lands HERE with status
            # "shed": the stream terminates with a reason, not silence.
            if len(tokens) > st.delivered:
                self._stream_emit(st, "tokens", start=st.delivered,
                                  tokens=tokens[st.delivered:])
                st.delivered = len(tokens)
            self._stream_emit(st, "end", status=status)
            # attribute the failover stall: time between resume markers
            # and their next delivered edge, measured at the consumer
            flight["resume_gap_s"] = st.resume_gap_s
        c = Completion(
            rid=req.rid, tokens=tokens, status=status,
            arrival=req.arrival, finish=now, ttft=ttft, tpot=tpot,
            flight=flight, trace_id=req.trace_id, tenant=req.tenant,
        )
        if self.tracer is not None:
            # tail verdict on the ROUTER's recorder (the fleet
            # timeline): keeps on bad status, any retry/failover hop,
            # or end-to-end latency past the slow threshold. The
            # outcome gates the fleet histogram exemplars below.
            c.trace_sampled = self.tracer.finish_trace(
                req.trace_id, status=status, latency_s=total,
                retries=tr.retries, failovers=tr.failovers)
        tr.done = True
        self._pending -= 1
        # drop the tracking entry so live state stays O(in-flight) and
        # rids may be reused; late sub-completions for this rid just miss
        # the lookup and are skipped. (self.completions keeps the result
        # history — the same accumulate-and-consume contract as
        # Scheduler.completions; a drain API is recorded follow-up.)
        self.tracked.pop(req.rid, None)
        self.completions.append(c)
        self.metrics.on_finalize(c)
        if self.ledger is not None:
            # cost metering (serve/fairshare.py): one fold per terminal,
            # prompt length from the request (the Completion doesn't
            # carry the prompt), phases/prefix hits off the flight
            self.ledger.on_completion(c, prompt_tokens=len(req.prompt))
        if self.telemetry is not None:
            # the exemption travels with the flight line, so the
            # offline verdict (tools/check_slo.py) reproduces the
            # online judgment
            self.telemetry.on_completion(c, slo_exempt=slo_exempt)
        if self.slo is not None and not slo_exempt:
            # brown-out's own sheds are exempt (anti-windup): counting
            # the degradation response as an SLO failure would hold the
            # alert — and therefore the brown-out — active forever
            self.slo.observe(c)
        return c

    # ------------------------------------------------------------- misc
    @property
    def idle(self) -> bool:
        return self._pending == 0

    def run_until_idle(self, max_ticks: int = 100_000) -> List[Completion]:
        for _ in range(max_ticks):
            if self.idle:
                return self.completions
            self.step()
        raise RuntimeError(f"not idle after {max_ticks} ticks")

    def warmup(self, widths: Optional[Sequence[int]] = None) -> None:
        """Compile each replica's programs outside any timed/traced
        window: one admit per bucket width in play + one decode burst.
        After this, request churn (and failover re-prefills, which land
        in the same buckets) causes zero new compiles — the chaos tests
        pin that via compile_stats(). (Worker processes warm themselves
        before signalling ready — their handle's warmup is a no-op.)"""
        for h in self.handles:
            h.warmup(widths)

    def compile_stats(self) -> Dict[int, dict]:
        return {h.id: h.compile_stats() for h in self.handles}

    def states(self) -> Dict[int, str]:
        return {h.id: h.health.state.value for h in self.handles}


def make_router(
    model,
    n_replicas: int,
    engine_config: EngineConfig,
    *,
    clock=None,
    max_queue: int = 64,
    config: RouterConfig = RouterConfig(),
    fault_plan: Optional[FaultPlan] = None,
    registry: Optional[MetricsRegistry] = None,
    tracer=None,
    slo=None,
    telemetry=None,
    trace_sample: float = 1.0,
    trace_keep_slow_s: Optional[float] = None,
    trace_tenant_rates: Optional[dict] = None,
    vtc=None,
    ledger=None,
) -> Router:
    """Build a fleet of identical replicas on one shared clock: each a
    SlotEngine over the same `model` (one copy of the weights on the
    card; the reference replicates its params the same way) with its own
    KV pool, its own ServeMetrics (the routing gauges) and, when a
    FaultPlan targets it, its own deterministic injector. `tracer`
    (utils/trace.py TraceRecorder) threads one recorder through the
    router, every scheduler, and every engine — pid=replica, labelled
    lanes — for `--trace-out` Chrome-trace export. `trace_sample` /
    `trace_keep_slow_s` / `trace_tenant_rates` attach the head-sampling
    + tail-keep policy to that recorder (default: record everything)."""
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    clock = clock or MonotonicClock()
    if config.fair and vtc is None:
        from ddp_practice_tpu_torch.serve.fairshare import (
            VirtualTokenCounter,
        )
        vtc = VirtualTokenCounter()
    if tracer is not None and (trace_sample < 1.0
                               or trace_keep_slow_s is not None
                               or trace_tenant_rates):
        tracer.set_sampler(
            TraceSampler(trace_sample, keep_slow_s=trace_keep_slow_s,
                         tenant_rates=trace_tenant_rates),
            registry=registry,
        )
    schedulers = []
    for i in range(n_replicas):
        engine = SlotEngine(model, engine_config)
        if tracer is not None:
            engine.set_tracer(tracer, i)
            label_replica(tracer, i, engine_config.max_slots)
        schedulers.append(Scheduler(
            engine, clock=clock, max_queue=max_queue,
            metrics=ServeMetrics(),
            fault_hook=fault_plan.injector(i) if fault_plan else None,
            tracer=tracer, replica=i, vtc=vtc,
        ))
    return Router(
        schedulers, clock=clock, config=config,
        metrics=RouterMetrics(registry), tracer=tracer,
        slo=slo, telemetry=telemetry, vtc=vtc, ledger=ledger,
    )
