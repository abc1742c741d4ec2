"""Request-lifecycle tracing: Dapper-style spans over an injectable clock.

The serving stack (Scheduler -> SlotEngine/PagedEngine -> Router) and the
training loop both answer "where did the time go?" with aggregate gauges
only (utils/metrics.py) — a bad TTFT or a failover hop leaves no record
of queue wait vs bucketed prefill vs decode-burst stalls vs retry hops.
This module is the missing recorder:

- **Host-pure and thread-safe.** Nothing here touches the device; appends are
  deque ops under the GIL, snapshots take the lock. A serve loop is
  single-threaded, but submission may come from another thread.
- **Injectable clock.** The recorder reads time through the same clock
  the schedulers use (`MonotonicClock` in production, `FakeClock` in
  tests), so a chaos replay's trace is bit-for-bit deterministic.
- **Bounded.** Records live in a ring buffer (`max_events`); a
  long-lived server's tracing memory is O(1), and the exported timeline
  is the most recent window — a flight recorder, not an archive.
- **Zero-overhead when off.** A disabled recorder's `span()` returns a
  shared no-op context manager and `instant()` returns immediately; the
  instrumented hot paths additionally gate on `tracer is not None`, so
  the production default (no tracer) pays a single attribute test.
- **Streamable.** An optional `sink` (utils/telemetry.py
  TelemetryExporter) receives every record as a plain dict THE MOMENT it
  is recorded — line-delimited JSONL export that survives a SIGKILL,
  where `save()` (the exit-time Chrome dump) would leave nothing.
  tools/check_traces.py validates both forms.

Three record kinds, three Chrome trace-event encodings
(`to_chrome_trace()` emits the JSON Perfetto / chrome://tracing /
vLLM's tooling consume):

- **Lane spans** (`span()` / `record_span()`): synchronous work on one
  (pid, tid) lane — a prefill dispatch on a slot lane, a decode burst
  on the engine lane, a train step phase. Exported as matched B/E
  pairs, properly nested per lane (tools/check_traces.py validates).
- **Request spans** (`record_async()`): per-request lifecycle intervals
  ("request", "queued") that overlap freely across requests. Exported
  as Chrome ASYNC events (ph "b"/"e") keyed by `id=trace_id`, so one
  request renders as one timeline row however many replicas it crossed.
- **Instants** (`instant()`): point events (shed, retry, failover,
  brownout flip) — ph "i".

Lane conventions for serving (shared by both engines and the router):
pid = replica id (`ROUTER_PID` for the router's own lane), tid 0 =
`ENGINE_LANE` (decode dispatches + scheduler instants), tid 1+slot =
the slot's prefill lane. `label_replica()` / `label_router()` stamp the
matching process/thread-name metadata so traces open pre-labelled.

Trace-id propagation is the router's failover contract: a re-admitted
request's sub-Request carries the ORIGINAL trace_id, so a crash-migrated
request's spans on the survivor join the same async track as its spans
on the dead replica — one request, one timeline (pinned in
tests/test_trace.py). The engines also name their
`torch.profiler.record_function` regions with the dispatch's trace-ids,
so a device timeline captured by utils/profiling.py lines up with the
host spans by name (utils/xprof.py reads the device side back).

(Host-pure Python: a copy of ddp_practice_tpu/utils/trace.py up to its
lane-label helpers: the port imports nothing of the reference package.
The fleet-side classes after them, the adaptive head-rate controller,
the clock-offset estimator and the trace collector, come with the
telemetry slice, ROADMAP A6d. The OTLP export names its scope
"ddp_practice_tpu_torch.trace".)
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import threading
import time
import zlib
from collections import defaultdict, deque
from typing import Dict, Optional

# record kinds (internal)
_DUR, _ASYNC, _INSTANT = 0, 1, 2

# serving lane conventions (see module doc)
ENGINE_LANE = 0          # tid for decode dispatches + scheduler instants
SLOT_LANE_BASE = 1       # tid = SLOT_LANE_BASE + slot for prefill spans
ROUTER_PID = -1          # the router's own pid (replicas are 0..N-1)

# the shared no-op span: what a disabled recorder hands out, and what
# instrumented hot paths use when no tracer is attached at all
NULL_SPAN = contextlib.nullcontext()
_NULL_SPAN = NULL_SPAN


def _resolve_clock(clock):
    """Accept a scheduler-style clock object (has .now()), a plain
    callable, or None (wall monotonic)."""
    if clock is None:
        return time.monotonic
    now = getattr(clock, "now", None)
    if callable(now):
        return now
    if callable(clock):
        return clock
    raise TypeError(f"clock must have .now() or be callable: {clock!r}")


# ------------------------------------------------------------- sampling
# Tail-keep markers: an instant/span with one of these names arriving for
# a staged (head-unsampled) request promotes the whole staged timeline on
# the spot — anomalies keep their traces even if the process dies before
# the request completes. The names match what the router/scheduler/engine
# already record ("retry"/"failover" instants, "preempted"/"preempt",
# "stale_retry", "replica_dead") plus the terminal status instants the
# scheduler stamps for non-eos/length outcomes.
KEEP_MARKERS = frozenset({
    "preempt", "preempted", "retry", "failover", "resumed",
    "stale_retry", "replica_dead", "shed", "timeout", "error",
    "rejected",
})

# statuses that terminate cleanly — anything else is a keep-worthy outcome
_CLEAN_STATUSES = ("eos", "length")


def head_keep(trace_id: str, rate: float) -> bool:
    """The deterministic head-sampling decision: keep `trace_id` at
    `rate`. Dapper's coherence rule is that this decision is made ONCE
    per request and honored by every process the request touches — so it
    must be a pure function of the trace_id, stable across OS processes.
    Python's builtin hash() is salted per interpreter (PYTHONHASHSEED)
    and would give the router and a worker process DIFFERENT answers;
    crc32 is stable everywhere."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = zlib.crc32(trace_id.encode("utf-8")) & 0xFFFFFFFF
    return (h / 4294967296.0) < rate


class TraceSampler:
    """Sampling policy: head rate + tail keep-rules.

    `rate` is the head-sampling probability (decided per trace_id by
    `head_keep`, or by an injected `decide` callable in tests);
    `keep_slow_s` is the latency threshold above which a completed
    request is tail-kept even when head-unsampled (SLO-derived: a
    straggler IS the interesting trace); `stage_limit` bounds the
    per-request staging area a head-unsampled request's spans wait in
    until its tail verdict; `tenant_rates` maps tenant id -> head rate
    override (a debugged tenant runs at 1.0 while the fleet default
    stays at 1%), consulted per request via `rate_for`. Tail keep-rules
    are deliberately tenant-blind: a fault-affected request keeps its
    trace whatever its tenant's head rate."""

    def __init__(self, rate: float = 1.0, *,
                 keep_slow_s: Optional[float] = None,
                 stage_limit: int = 256, decide=None,
                 tenant_rates: Optional[Dict[str, float]] = None) -> None:
        if stage_limit < 1:
            raise ValueError("stage_limit must be positive")
        self.rate = float(rate)
        self.keep_slow_s = keep_slow_s
        self.stage_limit = stage_limit
        self._decide = decide
        self.tenant_rates: Optional[Dict[str, float]] = (
            {str(k): float(v) for k, v in tenant_rates.items()}
            if tenant_rates else None)

    def rate_for(self, tenant: Optional[str] = None) -> float:
        """The head rate this request samples at: the tenant's override
        when one is configured, the fleet default otherwise."""
        if tenant is not None and self.tenant_rates:
            r = self.tenant_rates.get(tenant)
            if r is not None:
                return r
        return self.rate

    def sampled(self, trace_id: str,
                tenant: Optional[str] = None) -> bool:
        if self._decide is not None:
            return bool(self._decide(trace_id))
        return head_keep(trace_id, self.rate_for(tenant))

    def keep_reason(self, *, status: Optional[str] = None,
                    latency_s: Optional[float] = None,
                    retries: int = 0, failovers: int = 0
                    ) -> Optional[str]:
        """Tail verdict at completion: the keep reason, or None to
        suppress. Any non-clean terminal status, any retry/failover hop,
        or a latency past the slow threshold keeps the trace."""
        if status is not None and status not in _CLEAN_STATUSES:
            return str(status)
        if failovers:
            return "failover"
        if retries:
            return "retry"
        if (self.keep_slow_s is not None and latency_s is not None
                and latency_s > self.keep_slow_s):
            return "slow"
        return None


class _TailStage:
    """One head-unsampled request's bounded span staging area."""

    __slots__ = ("records", "dropped")

    def __init__(self, limit: int) -> None:
        self.records: deque = deque(maxlen=limit)
        self.dropped = 0


class _Rec:
    __slots__ = ("kind", "name", "t0", "t1", "pid", "tid", "trace_id",
                 "attrs", "seq")

    def __init__(self, kind, name, t0, t1, pid, tid, trace_id, attrs, seq):
        self.kind = kind
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.pid = pid
        self.tid = tid
        self.trace_id = trace_id
        self.attrs = attrs
        self.seq = seq


class _Span:
    """Context manager for one lane span; created only when enabled."""

    __slots__ = ("rec", "name", "trace_id", "pid", "tid", "attrs", "t0",
                 "sampled_only")

    def __init__(self, rec, name, trace_id, pid, tid, attrs,
                 sampled_only=False):
        self.rec = rec
        self.name = name
        self.trace_id = trace_id
        self.pid = pid
        self.tid = tid
        self.attrs = attrs
        self.sampled_only = sampled_only

    def __enter__(self):
        self.t0 = self.rec._now()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.rec.record_span(
            self.name, self.t0, self.rec._now(), trace_id=self.trace_id,
            pid=self.pid, tid=self.tid, attrs=self.attrs,
            sampled_only=self.sampled_only,
        )
        return False


class TraceRecorder:
    """Bounded, clock-injected span/event recorder (see module doc)."""

    def __init__(self, *, clock=None, max_events: int = 65536,
                 enabled: bool = True, sink=None,
                 drop_counter=None) -> None:
        if max_events < 1:
            raise ValueError("max_events must be positive")
        self._now = _resolve_clock(clock)
        self.enabled = enabled
        self._records: deque = deque(maxlen=max_events)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        # span-loss accounting: the ring buffer SILENTLY evicts the
        # oldest record when full — count every eviction (plus drops
        # reported by external producers, e.g. a worker's bounded trace
        # buffer via TraceCollector) so a truncated timeline is
        # observable instead of quietly validating. `drop_counter` is an
        # optional utils/metrics.py Counter (trace_events_dropped_total);
        # the count is also stamped into the export metadata so
        # tools/check_traces.py can warn.
        self.dropped = 0
        self._drop_counter = drop_counter
        self._process_names: Dict[int, str] = {}
        self._thread_names: Dict[tuple, str] = {}
        # streaming sink (utils/telemetry.py TelemetryExporter): called
        # with one plain dict per record AS IT IS RECORDED, so a killed
        # run's events survive outside this ring buffer. None = the
        # exit-time export (save()) is the only output.
        self._sink = None
        # head sampling + tail keep (None = record everything, the
        # pre-sampling behavior; see set_sampler / begin_trace)
        self.sampler: Optional[TraceSampler] = None
        self._head: Dict[str, int] = {}        # 0 staged / 1 head / 2 kept
        self._staged: Dict[str, _TailStage] = {}
        self._outcomes: Dict[str, bool] = {}   # finished trace -> recorded
        self._active_flowing = 0               # in-flight head/kept traces
        self.spans_sampled = 0                 # records kept by the head decision
        self.spans_kept = 0                    # records kept by a tail rule
        self.spans_suppressed = 0              # staged records discarded
        self.traces_sampled = 0
        self.traces_kept = 0
        self.traces_suppressed = 0
        self.kept_reasons: Dict[str, int] = {}
        self._c_sampled = self._c_kept = self._c_suppressed = None
        self._keep_registry = None
        # incremental OTLP drain state (drain_otlp / OtlpPusher): the
        # high-water seq already exported plus each trace's remembered
        # root spanId, so successive batches never re-emit a record
        # (spanIds must stay unique across a merged push capture) and a
        # span drained after its root shipped still parents onto it.
        self._otlp_drained = -1
        self._otlp_roots: Dict[str, str] = {}
        if sink is not None:
            self.set_sink(sink)

    def set_sink(self, sink) -> None:
        """Attach a streaming consumer: `sink(record_dict)` per span/
        async/instant record (kind-tagged; see _stream) plus one "meta"
        record per lane label. Already-recorded lane labels are replayed
        into the sink at attach time, so a sink attached after
        label_replica() still knows every pid."""
        self._sink = sink
        for pid, name in self._process_names.items():
            sink({"kind": "meta", "meta": "process_name",
                  "pid": pid, "name": name})
        for (pid, tid), name in self._thread_names.items():
            sink({"kind": "meta", "meta": "thread_name",
                  "pid": pid, "tid": tid, "name": name})

    def _stream(self, rec: dict) -> None:
        if self._sink is not None:
            self._sink(rec)

    def _stream_record(self, kind: str, name, pid, tid, trace_id,
                       attrs, **times) -> None:
        """Build + emit one sink record (callers gate on `_sink is not
        None` first, so the no-sink hot path never builds the dict).
        The stream schema has ONE producer: change it here, and every
        record kind follows."""
        rec = {"kind": kind, "name": name, **times, "pid": pid}
        if tid is not None:
            rec["tid"] = tid
        if trace_id is not None:
            rec["trace_id"] = trace_id
        if attrs:
            rec["attrs"] = attrs
        self._sink(rec)

    # ------------------------------------------------------------ recording
    def now(self) -> float:
        return self._now()

    def _append(self, rec: "_Rec") -> None:
        if len(self._records) == self._records.maxlen:
            self._note_drops(1)
        self._records.append(rec)

    def _note_drops(self, n: int) -> None:
        if n <= 0:
            return
        self.dropped += n
        if self._drop_counter is not None:
            self._drop_counter.inc(n)

    def count_external_drops(self, n: int) -> None:
        """Fold drops that happened OUTSIDE this ring buffer (a worker's
        bounded trace buffer, a full push queue) into this recorder's
        loss accounting — one number answers "is this timeline whole"."""
        self._note_drops(n)

    # ------------------------------------------------------------- sampling
    def set_sampler(self, sampler: Optional[TraceSampler], *,
                    registry=None) -> None:
        """Attach the sampling policy. With `registry` (utils/metrics.py
        MetricsRegistry), mints the accounting counters —
        trace_spans_sampled/kept/suppressed_total plus a per-reason
        trace_traces_kept_total{reason=...} family."""
        self.sampler = sampler
        if registry is not None:
            self._c_sampled = registry.counter("trace_spans_sampled_total")
            self._c_kept = registry.counter("trace_spans_kept_total")
            self._c_suppressed = registry.counter(
                "trace_spans_suppressed_total")
            self._keep_registry = registry

    def begin_trace(self, trace_id: Optional[str],
                    sampled: Optional[bool] = None, *,
                    tenant: Optional[str] = None) -> bool:
        """Stamp the head decision for one request at admission.
        Idempotent per trace_id (the router and a scheduler sharing one
        recorder both call it); `sampled` carries an upstream decision
        across the RPC seam (Dapper coherence: decided once, honored
        everywhere); `tenant` selects a per-tenant head-rate override
        when the sampler has one. Returns whether the request's spans
        flow."""
        if self.sampler is None or trace_id is None or not self.enabled:
            return True if sampled is None else bool(sampled)
        v = self._head.get(trace_id)
        if v is not None:
            return v != 0
        if sampled is None:
            sampled = self.sampler.sampled(trace_id, tenant)
        if len(self._head) >= 16384:
            # runaway begin/finish imbalance must not leak: evict the
            # oldest in-flight trace, suppressing anything it staged
            old, ov = next(iter(self._head.items()))
            del self._head[old]
            stg = self._staged.pop(old, None)
            if stg is not None:
                self._suppress(len(stg.records) + stg.dropped)
            elif ov != 0:
                self._active_flowing -= 1
        if sampled:
            self._head[trace_id] = 1
            self._active_flowing += 1
            self.traces_sampled += 1
        else:
            self._head[trace_id] = 0
            self._staged[trace_id] = _TailStage(self.sampler.stage_limit)
        return bool(sampled)

    def note_keep(self, trace_id: Optional[str],
                  reason: str = "marked") -> None:
        """Promote a staged request to kept RIGHT NOW (flush its staged
        spans; everything it records from here on flows). No-op for
        head-sampled / unknown / already-resolved traces."""
        if self.sampler is None or trace_id is None:
            return
        if self._head.get(trace_id) == 0:
            self._promote(trace_id, reason)

    def trace_recorded(self, trace_id: Optional[str]) -> bool:
        """Is this trace_id in the timeline (head-sampled, tail-kept, or
        sampling off)? The exemplar gate: a histogram exemplar citing a
        suppressed trace is a dead link."""
        if self.sampler is None or trace_id is None:
            return True
        v = self._head.get(trace_id)
        if v is not None:
            return v != 0
        return self._outcomes.get(trace_id, True)

    def finish_trace(self, trace_id: Optional[str], *,
                     status: Optional[str] = None,
                     latency_s: Optional[float] = None,
                     retries: int = 0, failovers: int = 0) -> bool:
        """The tail verdict at request completion: promote the staged
        spans when any keep-rule fires, otherwise discard them as
        suppressed. Returns whether the trace is in the timeline (the
        exemplar gate). Idempotent: a second finish (router after
        scheduler on a shared recorder) returns the first outcome."""
        if self.sampler is None or trace_id is None or not self.enabled:
            return True
        v = self._head.pop(trace_id, None)
        if v is None:
            return self._outcomes.get(trace_id, True)
        if v != 0:
            self._active_flowing -= 1
            self._remember(trace_id, True)
            return True
        stg = self._staged.pop(trace_id, None)
        reason = self.sampler.keep_reason(
            status=status, latency_s=latency_s, retries=retries,
            failovers=failovers)
        if reason is not None:
            self.traces_kept += 1
            self._count_reason(reason)
            if stg is not None:
                for r in stg.records:
                    self._flush_rec(r)
                self.spans_kept += len(stg.records)
                if self._c_kept is not None:
                    self._c_kept.inc(len(stg.records))
                if stg.dropped:
                    self._note_drops(stg.dropped)
            self._remember(trace_id, True)
            return True
        self.traces_suppressed += 1
        if stg is not None:
            self._suppress(len(stg.records) + stg.dropped)
        self._remember(trace_id, False)
        return False

    def _remember(self, trace_id: str, recorded: bool) -> None:
        self._outcomes[trace_id] = recorded
        if len(self._outcomes) > 8192:
            self._outcomes.pop(next(iter(self._outcomes)))

    def _suppress(self, n: int) -> None:
        if n <= 0:
            return
        self.spans_suppressed += n
        if self._c_suppressed is not None:
            self._c_suppressed.inc(n)

    def _count_reason(self, reason: str) -> None:
        self.kept_reasons[reason] = self.kept_reasons.get(reason, 0) + 1
        if self._keep_registry is not None:
            from ddp_practice_tpu_torch.utils.metrics import labelled
            self._keep_registry.counter(
                labelled("trace_traces_kept_total", reason=reason)).inc()

    def _promote(self, trace_id: str, reason: str) -> None:
        """Staged -> kept: flush the staging area into the ring + sink,
        record the reason, let subsequent records flow."""
        self._head[trace_id] = 2
        self._active_flowing += 1
        self.traces_kept += 1
        self._count_reason(reason)
        stg = self._staged.pop(trace_id, None)
        if stg is None:
            return
        for r in stg.records:
            self._flush_rec(r)
        self.spans_kept += len(stg.records)
        if self._c_kept is not None:
            self._c_kept.inc(len(stg.records))
        if stg.dropped:
            # staged overflow became real loss the moment we kept the
            # trace — fold it into the recorder's drop accounting
            self._note_drops(stg.dropped)

    def _flush_rec(self, r: "_Rec") -> None:
        self._append(r)
        if self._sink is None:
            return
        if r.kind == _DUR:
            self._stream_record("span", r.name, r.pid, r.tid,
                                r.trace_id, r.attrs, t0=r.t0, t1=r.t1)
        elif r.kind == _ASYNC:
            self._stream_record("async", r.name, r.pid, None,
                                r.trace_id, r.attrs, t0=r.t0, t1=r.t1)
        else:
            self._stream_record("instant", r.name, r.pid, r.tid,
                                r.trace_id, r.attrs, t=r.t0)

    def _admit(self, rec: "_Rec", sampled_only: bool = False) -> bool:
        """The sampling gate on every record: True = record now, False =
        staged or suppressed. Marker-named records promote their staged
        trace on the spot (anomalies survive even a later SIGKILL)."""
        tid_ = rec.trace_id
        if tid_ is None:
            # shared lane work (decode bursts): recorded only while some
            # sampled/kept request is in flight when the producer asked
            # for the gate — the residual cost at a 1% head rate
            if sampled_only and self._active_flowing == 0:
                self._suppress(1)
                return False
            return True
        v = self._head.get(tid_)
        if v is None:
            return True
        if v != 0:
            if v == 1:
                self.spans_sampled += 1
                if self._c_sampled is not None:
                    self._c_sampled.inc()
            else:
                self.spans_kept += 1
                if self._c_kept is not None:
                    self._c_kept.inc()
            return True
        if rec.name in KEEP_MARKERS:
            self._promote(tid_, rec.name)
            self.spans_kept += 1
            if self._c_kept is not None:
                self._c_kept.inc()
            return True
        stg = self._staged.get(tid_)
        if stg is None:    # defensive: decision says staged, stage gone
            return True
        if len(stg.records) == stg.records.maxlen:
            stg.dropped += 1
        stg.records.append(rec)
        return False

    def span(self, name: str, *, trace_id: Optional[str] = None,
             pid: int = 0, tid: int = 0, sampled_only: bool = False,
             **attrs):
        """Lane span context manager; a shared no-op when disabled.
        `sampled_only` marks shared-lane work (no trace_id of its own)
        that should be suppressed while nothing sampled is in flight."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, trace_id, pid, tid, attrs, sampled_only)

    def record_span(self, name: str, t0: float, t1: float, *,
                    trace_id: Optional[str] = None, pid: int = 0,
                    tid: int = 0, attrs: Optional[dict] = None,
                    sampled_only: bool = False) -> None:
        """Explicit-timestamp lane span (for intervals the caller timed)."""
        if not self.enabled:
            return
        rec = _Rec(
            _DUR, name, t0, t1, pid, tid, trace_id, attrs, next(self._seq)
        )
        if self.sampler is not None and not self._admit(rec, sampled_only):
            return
        self._append(rec)
        if self._sink is not None:
            self._stream_record("span", name, pid, tid, trace_id, attrs,
                                t0=t0, t1=t1)

    def record_async(self, name: str, t0: float, t1: float, *,
                     trace_id: str, pid: int = 0,
                     attrs: Optional[dict] = None) -> None:
        """Per-request interval: exported as async b/e keyed by trace_id,
        so overlapping requests never fight over one lane's B/E stack."""
        if not self.enabled:
            return
        rec = _Rec(
            _ASYNC, name, t0, t1, pid, 0, trace_id, attrs, next(self._seq)
        )
        if self.sampler is not None and not self._admit(rec):
            return
        self._append(rec)
        if self._sink is not None:
            self._stream_record("async", name, pid, None, trace_id,
                                attrs, t0=t0, t1=t1)

    def instant(self, name: str, *, trace_id: Optional[str] = None,
                pid: int = 0, tid: int = 0, **attrs) -> None:
        if not self.enabled:
            return
        self.record_instant(name, self._now(), trace_id=trace_id,
                            pid=pid, tid=tid, attrs=attrs or None)

    def record_instant(self, name: str, t: float, *,
                       trace_id: Optional[str] = None, pid: int = 0,
                       tid: int = 0, attrs: Optional[dict] = None) -> None:
        """Explicit-timestamp instant — for events timed in another
        process's clock domain (TraceCollector merges worker instants
        with the measured offset already applied)."""
        if not self.enabled:
            return
        rec = _Rec(
            _INSTANT, name, t, t, pid, tid, trace_id, attrs or None,
            next(self._seq)
        )
        if self.sampler is not None and not self._admit(rec):
            return
        self._append(rec)
        if self._sink is not None:
            self._stream_record("instant", name, pid, tid, trace_id,
                                attrs or None, t=t)

    # ------------------------------------------------------------- metadata
    def set_process_name(self, pid: int, name: str) -> None:
        self._process_names[pid] = name
        self._stream({"kind": "meta", "meta": "process_name",
                      "pid": pid, "name": name})

    def set_thread_name(self, pid: int, tid: int, name: str) -> None:
        self._thread_names[(pid, tid)] = name
        self._stream({"kind": "meta", "meta": "thread_name",
                      "pid": pid, "tid": tid, "name": name})

    # ------------------------------------------------------------- plumbing
    def __len__(self) -> int:
        return len(self._records)

    def clear(self) -> None:
        """Drop recorded events (lane labels survive) — e.g. after a
        warmup phase whose compile-time spans would dwarf the workload.
        In-flight sampling decisions survive (a cleared recorder must
        still resolve its open requests coherently); their already-staged
        records are dropped with the ring, uncounted, like everything
        else clear() discards."""
        with self._lock:
            self._records.clear()
            for stg in self._staged.values():
                stg.records.clear()
                stg.dropped = 0

    def disable(self) -> None:
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    # --------------------------------------------------------------- export
    def to_chrome_trace(self) -> dict:
        """Render the ring buffer as Chrome trace-event JSON.

        Lane spans become matched B/E pairs, emitted per (pid, tid) in
        stack order (outer-first at shared starts), so zero-duration
        spans on a FakeClock still nest cleanly; request spans become
        async b/e pairs keyed by id=trace_id; instants become ph "i".
        ts is microseconds of the recorder's clock domain.
        """
        with self._lock:
            records = list(self._records)
        events = []
        pids = ({r.pid for r in records} | set(self._process_names))
        for pid in sorted(pids):
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": self._process_names.get(pid, f"pid{pid}")},
            })
        lane_tids = {(r.pid, r.tid) for r in records if r.kind == _DUR}
        for (pid, tid) in sorted(set(self._thread_names) | lane_tids):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": self._thread_names.get(
                    (pid, tid), f"tid{tid}")},
            })

        def us(t: float) -> float:
            return round(t * 1e6, 3)

        def begin(r: _Rec, ph: str) -> dict:
            ev = {"name": r.name, "ph": ph, "ts": us(r.t0),
                  "pid": r.pid, "tid": r.tid}
            args = dict(r.attrs) if r.attrs else {}
            if r.trace_id is not None:
                args["trace_id"] = r.trace_id
            if args:
                ev["args"] = args
            if ph == "b":
                ev["cat"] = "request"
                ev["id"] = r.trace_id
            return ev

        def end(r: _Rec, ph: str) -> dict:
            ev = {"name": r.name, "ph": ph, "ts": us(r.t1),
                  "pid": r.pid, "tid": r.tid}
            if ph == "e":
                ev["cat"] = "request"
                ev["id"] = r.trace_id
            return ev

        def sweep(recs, b_ph, e_ph):
            """Emit properly nested begin/end pairs for one lane: sort by
            (start, -end, seq), close every span that ends at-or-before
            the next span's start, drain at the end. Genuinely crossing
            intervals come out ts-disordered — the validator flags them
            rather than this export papering over them."""
            recs.sort(key=lambda r: (r.t0, -r.t1, r.seq))
            stack = []
            for r in recs:
                while stack and stack[-1].t1 <= r.t0:
                    events.append(end(stack.pop(), e_ph))
                events.append(begin(r, b_ph))
                stack.append(r)
            while stack:
                events.append(end(stack.pop(), e_ph))

        lanes = defaultdict(list)
        asyncs = defaultdict(list)
        instants = []
        for r in records:
            if r.kind == _DUR:
                lanes[(r.pid, r.tid)].append(r)
            elif r.kind == _ASYNC:
                asyncs[(r.pid, r.trace_id)].append(r)
            else:
                instants.append(r)
        for key in sorted(lanes):
            sweep(lanes[key], "B", "E")
        for key in sorted(asyncs, key=lambda k: (k[0], str(k[1]))):
            sweep(asyncs[key], "b", "e")
        for r in instants:
            ev = begin(r, "i")
            ev["s"] = "t"  # thread-scoped instant
            events.append(ev)
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        meta = {}
        if self.dropped:
            # a flight recorder that lost events must SAY so: the
            # validator (tools/check_traces.py) warns on this instead of
            # blessing a quietly truncated timeline
            meta["trace_events_dropped"] = self.dropped
        sm = self.sampling_meta()
        if sm is not None:
            # ...and a SAMPLED timeline must say it is partial BY POLICY
            # (suppressed != dropped): check_traces reads this back so a
            # missing lane for an unsampled request is not a loss warning
            meta["sampling"] = sm
        if meta:
            out["metadata"] = meta
        return out

    def sampling_meta(self) -> Optional[dict]:
        """The export-header sampling block; None when sampling is off."""
        if self.sampler is None:
            return None
        out = {
            "head_rate": self.sampler.rate,
            "keep_slow_s": self.sampler.keep_slow_s,
            "traces_sampled": self.traces_sampled,
            "traces_kept": self.traces_kept,
            "traces_suppressed": self.traces_suppressed,
            "spans_sampled": self.spans_sampled,
            "spans_kept": self.spans_kept,
            "spans_suppressed": self.spans_suppressed,
            "kept_reasons": dict(self.kept_reasons),
        }
        if self.sampler.tenant_rates:
            out["tenant_rates"] = dict(self.sampler.tenant_rates)
        return out

    def save(self, path: str) -> None:
        """Write the Chrome trace JSON (open in Perfetto / chrome://tracing)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    # --------------------------------------------------------- OTLP export
    def to_otlp(self, service_name: str = "ddp-serve") -> dict:
        """Render the per-request records as an OTLP-JSON
        ``ExportTraceServiceRequest`` (the shape an OTLP/HTTP collector
        accepts at /v1/traces), alongside the Chrome export.

        Mapping: every record carrying a trace_id becomes one span;
        traceId (16 bytes) / spanId (8 bytes) are derived by stable hash
        from the request's trace_id and the record identity, the
        "request" async span is the trace root and every other record
        parents onto it (lane spans and instants are children — instants
        become zero-duration spans). Records WITHOUT a trace_id (shared
        decode-burst lanes, clock_offset instants) are infrastructure,
        not request traces, and stay in the Chrome export only.
        Timestamps are the recorder's clock domain as unix-nanos strings
        (proto3 JSON int64); the original trace_id and lane rides along
        as ``ddp.*`` attributes, so tools/check_otlp.py can round-trip
        against the Chrome export. Resource attributes carry the
        sampling header."""
        with self._lock:
            records = [r for r in self._records if r.trace_id is not None]
        by_trace: Dict[str, list] = defaultdict(list)
        for r in records:
            by_trace[str(r.trace_id)].append(r)
        spans = []
        for tid_, recs in sorted(by_trace.items()):
            recs.sort(key=lambda r: (r.t0, r.seq))
            root_sid = None
            for r in recs:
                if r.kind == _ASYNC and r.name == "request":
                    root_sid = _otlp_span_id(tid_, r.seq)
                    break
            for r in recs:
                spans.append(_otlp_record_span(r, tid_, root_sid))
        return self._otlp_request(service_name, spans)

    def drain_otlp(self, service_name: str = "ddp-serve"
                   ) -> Optional[dict]:
        """Incremental OTLP export: the per-request records that entered
        the ring since the previous drain, as one
        ``ExportTraceServiceRequest`` (None when nothing is new). This is
        the push-plane producer (utils/telemetry.py OtlpPusher): each
        record is emitted in EXACTLY one batch — a seq high-water mark —
        so a collector that dedups whole batches by batch id never sees
        a duplicate spanId across the merged capture. The first
        "request" async span seen for a trace becomes (and stays) its
        root: spans in later batches parent onto it even though it
        shipped batches ago, and spans drained BEFORE their root exists
        go parentless — legal OTLP roots until the real root arrives."""
        with self._lock:
            records = [r for r in self._records
                       if r.trace_id is not None
                       and r.seq > self._otlp_drained]
            if not records:
                return None
            self._otlp_drained = max(r.seq for r in records)
        records.sort(key=lambda r: (str(r.trace_id), r.t0, r.seq))
        spans = []
        for r in records:
            tid_ = str(r.trace_id)
            root_sid = self._otlp_roots.get(tid_)
            if (root_sid is None and r.kind == _ASYNC
                    and r.name == "request"):
                root_sid = _otlp_span_id(tid_, r.seq)
                if len(self._otlp_roots) >= 16384:
                    self._otlp_roots.pop(next(iter(self._otlp_roots)))
                self._otlp_roots[tid_] = root_sid
            spans.append(_otlp_record_span(r, tid_, root_sid))
        return self._otlp_request(service_name, spans)

    def _otlp_request(self, service_name: str, spans: list) -> dict:
        """Wrap built spans in the export envelope (resource header =
        service name + sampling accounting + drop count)."""
        resource_attrs = {"service.name": service_name}
        sm = self.sampling_meta()
        if sm is not None:
            resource_attrs["ddp.sampling.head_rate"] = sm["head_rate"]
            resource_attrs["ddp.sampling.traces_kept"] = sm["traces_kept"]
            resource_attrs["ddp.sampling.traces_suppressed"] = (
                sm["traces_suppressed"])
            resource_attrs["ddp.sampling.spans_suppressed"] = (
                sm["spans_suppressed"])
        if self.dropped:
            resource_attrs["ddp.trace.dropped_events"] = self.dropped
        return {"resourceSpans": [{
            "resource": {"attributes": _otlp_attrs(resource_attrs)},
            "scopeSpans": [{
                "scope": {"name": "ddp_practice_tpu_torch.trace"},
                "spans": spans,
            }],
        }]}

    def save_otlp(self, path: str,
                  service_name: str = "ddp-serve") -> None:
        """Write the OTLP-JSON export (tools/check_otlp.py validates)."""
        with open(path, "w") as f:
            json.dump(self.to_otlp(service_name=service_name), f)


def _otlp_trace_id(trace_id: str) -> str:
    """16-byte OTLP traceId as 32 hex chars, stable-hashed from the
    request trace_id (md5 as a hash, not a credential)."""
    return hashlib.md5(("ddp:" + trace_id).encode("utf-8")).hexdigest()


def _otlp_span_id(trace_id: str, seq: int) -> str:
    """8-byte OTLP spanId as 16 hex chars, unique per record."""
    return hashlib.md5(
        f"{trace_id}#{seq}".encode("utf-8")).hexdigest()[:16]


def _otlp_record_span(r: "_Rec", tid_: str,
                      root_sid: Optional[str]) -> dict:
    """One record -> one OTLP span (shared by the exit-time to_otlp and
    the incremental drain_otlp, so both exports speak the same shape).
    `root_sid` is the trace root's spanId or None; the root itself
    (sid == root_sid) carries the status instead of a parent link."""
    sid = _otlp_span_id(tid_, r.seq)
    attrs = {"ddp.trace_id": tid_, "ddp.pid": r.pid,
             "ddp.kind": ("span", "async", "instant")[r.kind]}
    if r.kind == _DUR:
        attrs["ddp.tid"] = r.tid
    if r.attrs:
        attrs.update(r.attrs)
    span = {
        "traceId": _otlp_trace_id(tid_),
        "spanId": sid,
        "name": str(r.name),
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(round(r.t0 * 1e9))),
        "endTimeUnixNano": str(int(round(r.t1 * 1e9))),
        "attributes": _otlp_attrs(attrs),
    }
    if root_sid is not None and sid != root_sid:
        span["parentSpanId"] = root_sid
    elif sid == root_sid:
        status = (r.attrs or {}).get("status")
        if status is not None:
            span["status"] = (
                {"code": 1} if status in _CLEAN_STATUSES
                else {"code": 2, "message": str(status)})
    return span


def _otlp_attrs(attrs: dict) -> list:
    """dict -> OTLP KeyValue list (string/bool/int/double values)."""
    out = []
    for k, v in attrs.items():
        if isinstance(v, bool):
            val = {"boolValue": v}
        elif isinstance(v, int):
            val = {"intValue": str(v)}
        elif isinstance(v, float):
            val = {"doubleValue": v}
        else:
            val = {"stringValue": str(v)}
        out.append({"key": str(k), "value": val})
    return out


# ------------------------------------------------------- lane label helpers
def label_replica(recorder: TraceRecorder, replica: int,
                  max_slots: int) -> None:
    """Stamp the serving lane names for one replica: pid=replica,
    tid 0 = engine (decode dispatches), tid 1+slot = prefill lanes."""
    recorder.set_process_name(replica, f"replica{replica}")
    recorder.set_thread_name(replica, ENGINE_LANE, "engine")
    for s in range(max_slots):
        recorder.set_thread_name(replica, SLOT_LANE_BASE + s, f"slot{s}")


def label_router(recorder: TraceRecorder) -> None:
    recorder.set_process_name(ROUTER_PID, "router")
    recorder.set_thread_name(ROUTER_PID, 0, "dispatch")
