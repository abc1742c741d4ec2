"""Worker process: one serving replica as a real OS process.

(Host-pure Python around the port's engines: a copy of
ddp_practice_tpu/serve/worker.py with its imports pointed at the port;
the port imports nothing of the reference package. The reference pins a
JAX platform (`platform`, default "cpu"); the port's field is `device`,
default "cuda", as `TrainConfig.device` is, and a worker asked for a card
that is not there raises before it prints its READY line.)

`python -m ddp_practice_tpu_torch.serve.worker --spec <json|@path>` boots
a complete single-replica serving stack — its own CUDA context (or the
CPU, when the spec asks for it), its own model (seeded init from the
spec's model dict), its own Scheduler + SlotEngine/PagedEngine — and
serves two planes:

- the serve/rpc.py seam (``submit`` / ``poll`` / ``ping`` / ``shed`` /
  ``drain`` / ``shutdown``), cut at exactly Scheduler.submit and the
  completions watermark, for the router in the supervisor process;
- the telemetry endpoints (``/metrics`` ``/healthz`` ``/flight``
  ``/tenants``, utils/telemetry.py TelemetryServer).

The worker drives its own serve loop (a scheduler tick whenever work is
queued) — the router does NOT tick remote replicas; its per-tick call
is the heartbeat+watermark ``poll``. Every RPC op is IDEMPOTENT so the
client may retry transport failures: submit dedups by rid, poll reads
from a client-held watermark, ping/shed/drain repeat safely.

Ready protocol: after the engine warms (one admit per bucket and a
decode burst: the CUDA kernels load and the allocator warms there), the
worker prints one line ``WORKER_READY {json}`` (pid + bound ports) to
stdout and flushes; everything else it says goes to stderr. The
supervisor tails the worker's log file for that line — warmup is paid
BEFORE the worker joins dispatch, so a restarted replica re-warms from
scratch and rejoins only after a passing health probe, never cold.

Each worker is a plain OS process started by `subprocess.Popen`, never
forked from a process that touched CUDA. Workers share nothing but the
RPC wire; the weights are replicated by construction (same spec, same
seed, drawn on the CPU in parameter order), which is exactly the
replicated-fleet contract the in-process router has. The spec may carry
the caller's `weights_digest`: a build that gives another digest (the
caller's model was not a seed-0 draw of the spec's widths) raises before
READY. The READY line and the published `stats` carry the digest, the
engine's decode steps and the decode-attention kernel launches of this
process (ops/decode_attention.py LAUNCHES), so a caller can hold each
worker's launches against its own steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Optional


@dataclasses.dataclass
class WorkerSpec:
    """Everything a worker needs to become a replica, JSON-serializable
    (passed on argv — the spec IS the replica's identity, so a
    supervisor restart rebuilds a bit-identical one)."""

    # model: "name" (registry name, default lm_tiny), "precision"
    # (fp32 | bf16, default fp32) and the rest create_model kwargs
    # (seed-0 init — every worker with the same spec holds
    # byte-identical weights)
    model: dict = dataclasses.field(default_factory=dict)
    # EngineConfig kwargs, plus "paged": true to build a PagedEngine
    engine: dict = dataclasses.field(default_factory=dict)
    replica: int = 0            # id in fleet telemetry / lane labels
    max_queue: int = 64
    rpc_port: int = 0           # 0 = ephemeral, reported in READY
    telemetry_port: int = 0
    warmup: bool = True
    device: str = "cuda"        # "cuda" or "cpu"; no fallback
    # fleet tracing: record this replica's prefill/decode_burst/queued/
    # request spans (utils/trace.py) and stream them back to the router
    # as batched `trace` push frames, where the TraceCollector merges
    # them into the fleet timeline (ROADMAP A6d: the port refuses it
    # until the TraceCollector is ported).
    trace: bool = False
    trace_buffer: int = 4096    # pending-events bound (drops counted)
    # head-sampling rate for the trace plane (1.0 = record everything,
    # the pre-sampling behavior). The ROUTER decides per trace_id and
    # propagates the decision on the wire; this local policy covers
    # direct submits and lets the worker agree deterministically when
    # no upstream decision rode along (same crc32 hash, same answer).
    trace_sample: float = 1.0
    # tail keep-rule: head-unsampled requests slower than this are
    # promoted to kept at completion (None = no latency rule)
    trace_keep_slow_s: Optional[float] = None
    # per-tenant head-rate overrides (tenant id -> rate). Same Dapper
    # coherence as trace_sample: the router decides per trace_id and
    # the decision rides the wire, but a direct submit consults the
    # same table and agrees.
    trace_tenant_rates: Optional[dict] = None
    # token streaming: the scheduler emits per-burst TokenChunks and
    # the worker ships them inside its `pub` push frames (atomically
    # with the inflight salvage point — a dropped frame loses both
    # together, so the router's resume cursor never outruns delivery).
    # False = end-of-request delivery (the overhead bench's control).
    stream: bool = True
    # speculative decoding (serve/spec.py): first-class spec fields so
    # fleet launchers can flip the feature without knowing EngineConfig
    # internals; folded into the engine kwargs at build time. Only
    # meaningful for paged workers (the SlotEngine refuses it).
    spec_decode: bool = False
    spec_k: int = 4
    # weighted-fair scheduling (serve/fairshare.py): the worker builds
    # its own VirtualTokenCounter + TenantLedger, the scheduler picks
    # the least-served tenant's queue head, and /tenants serves the
    # per-tenant cost rollup. Off = byte-identical FIFO (no VTC
    # exists) — the same contract as RouterConfig.fair in-process.
    fair: bool = False
    # the digest (`weights_digest`) of the weights this replica must
    # serve, taken by the caller from its own model: a worker whose
    # seed-0 build gives another digest raises at boot, so a fleet can
    # never serve other weights than the in-process arms it is held to.
    # None = unchecked.
    weights_digest: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "WorkerSpec":
        return cls(**json.loads(text))


READY_PREFIX = "WORKER_READY "


class _TelemetryFanout:
    """Scheduler takes ONE telemetry object; a fair worker needs two
    sinks per completion (FlightStats window + TenantLedger billing).
    Tiny fan-out instead of widening the scheduler seam."""

    def __init__(self, *sinks) -> None:
        self.sinks = sinks

    def on_completion(self, completion, **kw) -> None:
        for s in self.sinks:
            s.on_completion(completion, **kw)


def build_model(model_kw: dict, device: str = "cuda"):
    """The bench's decoder recipe (serve/bench.py _build_model),
    spec-driven: the same kwargs and seed 0 in every process ->
    replicated weights. Raises when `device` is "cuda" and no card is
    present (config.resolve_device), never falling back to the CPU."""
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model

    kw = dict(model_kw)
    name = kw.pop("name", "lm_tiny")
    precision = kw.pop("precision", "fp32")
    return create_model(name, policy=PrecisionPolicy.from_name(precision),
                        device=device, seed=0, **kw)


def weights_digest(model) -> str:
    """A hex digest of `model`'s parameters: names, dtypes, shapes and
    bytes, read on the CPU, so the same weights give the same digest on
    the card and off it."""
    import hashlib

    import torch

    h = hashlib.blake2b(digest_size=16)
    for name, p in model.named_parameters():
        t = p.detach().cpu().contiguous().reshape(-1)
        h.update(f"{name}:{t.dtype}:{tuple(p.shape)};".encode())
        h.update(memoryview(t.view(torch.uint8).numpy()))
    return h.hexdigest()


class WorkerServer:
    """The replica's in-process wiring: scheduler + engine behind the
    RPC handlers, telemetry on the side, one lock serializing every
    state mutation against the serve loop."""

    def __init__(self, spec: WorkerSpec) -> None:
        from ddp_practice_tpu_torch.serve.engine import (
            EngineConfig,
            PagedEngine,
            SlotEngine,
        )
        from ddp_practice_tpu_torch.serve.metrics import ServeMetrics
        from ddp_practice_tpu_torch.serve.rpc import RpcServer
        from ddp_practice_tpu_torch.serve.scheduler import Scheduler
        from ddp_practice_tpu_torch.utils.metrics import MetricsRegistry
        from ddp_practice_tpu_torch.utils.telemetry import (
            FlightStats,
            TelemetryServer,
        )

        if spec.trace:
            raise NotImplementedError(
                "WorkerSpec.trace: the fleet trace plane (worker span "
                "streams merged by utils/trace.py TraceCollector) is "
                "ROADMAP A6d, not ported yet")
        self.spec = spec
        model = build_model(spec.model, spec.device)
        self.weights_digest = weights_digest(model)
        if (spec.weights_digest is not None
                and spec.weights_digest != self.weights_digest):
            raise RuntimeError(
                f"WorkerSpec.weights_digest {spec.weights_digest}, but "
                f"create_model(seed=0) of the spec's model gives "
                f"{self.weights_digest}: the caller serves other weights "
                f"than a worker can rebuild")
        eng_kw = dict(spec.engine)
        paged = bool(eng_kw.pop("paged", False))
        if "prompt_buckets" in eng_kw:
            eng_kw["prompt_buckets"] = tuple(eng_kw["prompt_buckets"])
        if spec.spec_decode:
            eng_kw.setdefault("spec_decode", True)
            eng_kw.setdefault("spec_k", spec.spec_k)
        cfg = EngineConfig(**eng_kw)
        engine_cls = PagedEngine if paged else SlotEngine
        self.engine = engine_cls(model, cfg)
        # prefix-digest publisher (serve/affinity.py): fingerprints the
        # warm radix tree into every heartbeat so the router can route
        # by expected prefix hit. None without a prefix cache — the
        # kv summary simply carries no digest and the router falls back
        # to least-loaded.
        radix = getattr(self.engine, "radix", None)
        if radix is not None:
            from ddp_practice_tpu_torch.serve.affinity import DigestPublisher

            self._digest = DigestPublisher(radix)
        else:
            self._digest = None
        self.registry = MetricsRegistry()
        self.flight = FlightStats()
        self.ledger = None
        vtc = None
        if spec.fair:
            from ddp_practice_tpu_torch.serve.fairshare import (
                TenantLedger,
                VirtualTokenCounter,
            )

            vtc = VirtualTokenCounter()
            self.ledger = TenantLedger(registry=self.registry, vtc=vtc)
        self.scheduler = Scheduler(
            self.engine, max_queue=spec.max_queue,
            metrics=ServeMetrics(self.registry),
            telemetry=(self.flight if self.ledger is None
                       else _TelemetryFanout(self.flight, self.ledger)),
            replica=spec.replica,
            stream=spec.stream, vtc=vtc,
        )
        # two-lock discipline so the RPC plane NEVER waits out a decode
        # burst: `_lock` (the big one) serializes scheduler/engine
        # mutation and is held across a whole step(); `_io_lock` guards
        # only the intake list and the published snapshot, held for
        # microseconds. submit appends to intake, poll reads the last
        # published snapshot — both return in ~an RTT while the burst
        # runs. (Measured: handler-behind-the-burst cost the RPC seam
        # most of its latency overhead at 8 rps.)
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._intake: list = []
        self._published: dict = {
            "completions_len": 0, "chunks_len": 0,
            "inflight": [], "stats": None,
        }
        self._pub_version = 0
        # push subscribers: [{"q": Queue, "watermark": int}] — _publish
        # enqueues one frame per snapshot, the RpcServer push loop owns
        # the socket. Queues are bounded; a slow/stuck subscriber drops
        # frames (its poll path reconciles) rather than stalling steps.
        self._subscribers: list = []
        self._last_push = 0.0
        self._last_pushed_upto = 0
        self._last_pushed_cupto = 0
        self._stop = threading.Event()
        self._wake = threading.Event()   # submit -> serve loop, no spin
        self._draining = False
        self._drain_exit = False         # SIGTERM: exit once drained
        self._seen_rids: dict = {}   # rid -> accepted (submit dedup)
        self._t0 = time.monotonic()
        if spec.warmup:
            self._warm()
        with self._lock:
            self._publish()   # ping/poll answer before the first step
        # planes come up only after warmup: a worker is dispatchable
        # the moment its ports are visible, so visible == warm
        self.telemetry = TelemetryServer(
            registry=self.registry,
            health_fn=lambda: {spec.replica: "healthy"},
            flight_fn=self.flight.report,
            tenants_fn=(self.ledger.report
                        if self.ledger is not None else None),
            port=spec.telemetry_port,
        )
        self.rpc = RpcServer({
            "ping": self._op_ping,
            "submit": self._op_submit,
            "poll": self._op_poll,
            "subscribe": self._op_subscribe,
            "reset": self._op_reset,
            "shed": self._op_shed,
            "drain": self._op_drain,
            "trace": self._op_trace,
            "shutdown": self._op_shutdown,
        }, port=spec.rpc_port)

    def _warm(self) -> None:
        from ddp_practice_tpu_torch.serve.engine import warm_engine

        warm_engine(self.engine)

    # ------------------------------------------------------------- ops
    def _kv_summary(self) -> dict:
        """KV/radix-cache occupancy riding every heartbeat frame: blocks
        in use / shared, prefix-cache hit rate, evictable count — plus
        the prefix digest (serve/affinity.py) cache-aware routing scores
        against. Zeros (and no digest) for the slot engine. Federated
        into per-worker gauges by the fleet view; the router's affinity
        index feeds straight off this payload."""
        from ddp_practice_tpu_torch.serve.affinity import kv_summary

        return kv_summary(self.engine, self._digest)

    def _stats(self) -> dict:
        from ddp_practice_tpu_torch.ops.decode_attention import LAUNCHES

        return {
            "kv": self._kv_summary(),
            "replica": self.spec.replica,
            "pid": os.getpid(),
            "t": time.monotonic(),
            "uptime_s": time.monotonic() - self._t0,
            "queue": len(self.scheduler.queue),
            "active": self.engine.num_active,
            "max_slots": self.engine.config.max_slots,
            "max_queue": self.scheduler.max_queue,
            "completions": len(self.scheduler.completions),
            "draining": self._draining,
            # post-warmup these are CONSTANT under churn (every admit
            # lands in a warmed bucket) — refreshed per publish anyway,
            # it is two dict-len reads
            "compile_stats": self.engine.compile_stats(),
            # this process's single-token model applications and its
            # decode-attention kernel launches (warmup included): the
            # caller holds each kernel's launches against depth x steps
            "decode_steps": self.engine.decode_steps,
            "kernel_launches": dict(LAUNCHES),
            "weights_digest": self.weights_digest,
        }

    def _op_ping(self, req: dict) -> dict:
        with self._io_lock:
            stats = self._published["stats"]
        if stats is None:
            with self._lock:
                stats = self._stats()
        # "t" is THIS clock read during handling — the remote timestamp
        # of the NTP-style offset sample the caller may be taking
        # (utils/trace.py ClockOffsetEstimator); the snapshot stats'
        # own "t" is stale by up to a publish interval
        return {"stats": stats, "t": time.monotonic()}

    def _op_submit(self, req: dict) -> dict:
        from ddp_practice_tpu_torch.serve.scheduler import Request

        r = req["request"]
        rid = r["rid"]
        with self._io_lock:
            if rid in self._seen_rids:
                # transport-retry replay: answer what we answered
                return {"accepted": self._seen_rids[rid], "dedup": True}
            if self._draining:
                self._seen_rids[rid] = False
                return {"accepted": False, "draining": True}
            # intake only — the serve loop drains into the scheduler at
            # the top of its next iteration (exactly when an in-process
            # scheduler would admit a just-queued request). A shed or
            # reject still lands as a completion in a later poll.
            self._intake.append(Request(
                rid=rid,
                prompt=list(r["prompt"]),
                max_new_tokens=r.get("max_new_tokens", 32),
                deadline=r.get("deadline"),
                seed=r.get("seed", 0),
                arrival=r.get("arrival"),
                priority=r.get("priority", 0),
                trace_id=r.get("trace_id"),
                # the router's head decision rides the wire (Dapper
                # coherence); absent → the scheduler re-derives it from
                # the same deterministic hash and agrees anyway
                sampled=r.get("sampled"),
                tenant=r.get("tenant"),
                temperature=r.get("temperature"),
                top_k=r.get("top_k"),
                top_p=r.get("top_p"),
            ))
            self._seen_rids[rid] = True
            # the dedup window only needs to outlive a transport retry
            # (seconds) — cap the map so a long-lived worker doesn't
            # retain every rid it ever served (dicts iterate in
            # insertion order: the popped entries are the oldest)
            while len(self._seen_rids) > 8192:
                del self._seen_rids[next(iter(self._seen_rids))]
        self._wake.set()
        return {"accepted": True}

    @staticmethod
    def _completion_dict(c) -> dict:
        return {
            "rid": c.rid, "tokens": list(c.tokens), "status": c.status,
            "arrival": c.arrival, "finish": c.finish,
            "ttft": c.ttft, "tpot": c.tpot, "flight": c.flight,
            "trace_id": c.trace_id,
            # the worker-side keep verdict, so the router's exemplar
            # gating sees whether this attempt's spans are in the stream
            "sampled": getattr(c, "trace_sampled", True),
            "tenant": getattr(c, "tenant", None),
        }

    def _publish(self) -> None:
        """Snapshot scheduler state for the RPC plane — called by the
        serve loop under the BIG lock after every mutation, read by
        handlers under the io lock only. Completion dicts are built
        lazily at read (the list is append-only; a published length
        bounds what a poll may see)."""
        inflight = [
            {"rid": r.rid, "tokens": list(toks), "ftt": ftt,
             "phases": phases}
            for r, toks, ftt, phases in self.scheduler.inflight_snapshot()
        ]
        stats = self._stats()
        comps = self.scheduler.completions
        upto = len(comps)
        chunks = self.scheduler.chunks   # append-only, like completions
        cupto = len(chunks)
        with self._io_lock:
            self._pub_version += 1
            version = self._pub_version
            self._published = {
                "completions_len": upto,
                "chunks_len": cupto,
                "inflight": inflight,
                "stats": stats,
            }
            subs = list(self._subscribers)
        # push to subscribers only when a COMPLETION or a token chunk
        # moved (the latency-critical events — streaming TTFT/ITL are
        # measured off these frames) or the 50 ms freshness beat is
        # due: pushing every decode step taxed the same single core the
        # decode runs on, for frames that carried nothing new. With
        # streaming on, a burst that decoded tokens always moved cupto,
        # so the chunk plane rides per-burst frames; the overhead bench
        # bills exactly this extra push traffic against the ≤1.05x bar.
        if subs and upto == self._last_pushed_upto \
                and cupto == self._last_pushed_cupto \
                and time.monotonic() - self._last_push < 0.05:
            return
        # (outside the io lock — the queues are thread-safe; completion
        # dicts are built per subscriber from its own watermark)
        for sub in subs:
            wm = sub["watermark"]
            cwm = sub["cwm"]
            # chunks ride IN the pub frame (not a separate frame kind):
            # a dropped frame loses the chunk slice and the inflight
            # salvage point TOGETHER, so the router's resume cursor can
            # never run ahead of the chunks it suppresses against
            frame = {
                "kind": "pub", "version": version,
                "from": wm, "watermark": upto,
                "completions": [
                    self._completion_dict(c) for c in comps[wm:upto]
                ],
                "chunks": [c.to_dict() for c in chunks[cwm:cupto]],
                "chunks_from": cwm, "chunks_watermark": cupto,
                "inflight": inflight, "stats": stats,
            }
            try:
                sub["q"].put_nowait(frame)
                sub["watermark"] = upto
                sub["cwm"] = cupto
            except Exception:
                pass  # full queue: this frame drops, poll reconciles
        self._last_push = time.monotonic()
        self._last_pushed_upto = upto
        self._last_pushed_cupto = cupto

    def _op_trace(self, req: dict) -> dict:
        """The reference's runtime toggle of the worker's span recording.
        The fleet trace plane is ROADMAP A6d; until then no worker has a
        recorder, and the op answers so (RemoteReplicaHandle.set_trace
        reads it as a disabled plane, not an error)."""
        return {"supported": False, "enabled": False}

    def _op_poll(self, req: dict) -> dict:
        """The heartbeat + completions-watermark read. `watermark` is
        CLIENT-held (an index into this process's completions list —
        a restarted worker starts at 0 and the client resets with it).
        `inflight` is the live salvage point: rid / tokens-so-far /
        first-token-time for everything queued or decoding, so a later
        SIGKILL costs the router at most one poll interval of tokens —
        and greedy re-decode reproduces even those. Served from the
        post-step published snapshot: a poll never waits out a burst."""
        watermark = int(req.get("watermark", 0))
        cwm = int(req.get("chunks_watermark", 0))
        seen_version = req.get("version")
        confirm = req.get("confirm")
        confirmed: Optional[dict] = None
        with self._io_lock:
            version = self._pub_version
            pub = self._published
            upto = pub["completions_len"]
            cupto = pub["chunks_len"]
            inflight = pub["inflight"]
            stats = pub["stats"]
            if confirm:
                # fire-and-forget reconcile: for each rid the client
                # cast a one-way submit for, answer what _op_submit
                # recorded — True accepted, False refused (draining),
                # absent = the frame never landed (client resubmits;
                # submit is idempotent by rid). Served on the SAME
                # connection the casts rode, so TCP ordering makes
                # "absent" mean lost, not merely not-yet-processed.
                confirmed = {
                    str(rid): self._seen_rids[rid]
                    for rid in confirm if rid in self._seen_rids
                }
        if seen_version == version and watermark >= upto \
                and cwm >= cupto:
            # nothing moved since the client's last poll: answer with a
            # frame small enough that a high-rate heartbeat costs the
            # decode loop (same single core!) close to nothing. "t" =
            # this clock read (clock-offset sampling, see _op_ping).
            out = {"version": version, "unchanged": True,
                   "t": time.monotonic()}
            if confirmed is not None:
                out["confirmed"] = confirmed
            return out
        comps = self.scheduler.completions  # append-only list
        new = [self._completion_dict(c) for c in comps[watermark:upto]]
        chunks = self.scheduler.chunks      # append-only too
        new_chunks = [c.to_dict() for c in chunks[cwm:cupto]]
        if stats is None:
            with self._lock:
                stats = self._stats()
        out = {"version": version,
               "completions": new,
               "watermark": upto,
               "chunks": new_chunks,
               "chunks_from": cwm,
               "chunks_watermark": cupto,
               "inflight": inflight,
               "stats": stats,
               "t": time.monotonic()}
        if confirmed is not None:
            out["confirmed"] = confirmed
        return out

    def _drain_intake_locked(self) -> int:
        """Move intake into the scheduler (big lock held by caller)."""
        with self._io_lock:
            intake, self._intake = self._intake, []
        for r in intake:
            self.scheduler.submit(r)
        return len(intake)

    def _op_subscribe(self, req: dict) -> dict:
        """Switch this connection into a push stream (rpc.py push
        mode): every published snapshot lands as a frame, no polling.
        `watermark` is where the client's completion stream currently
        stands (a resubscribe after a stream hiccup must not replay).
        The push loop unregisters the subscriber when the stream dies —
        reconnect churn must not leave _publish building frames for a
        graveyard of dead queues."""
        import queue

        q: "queue.Queue" = queue.Queue(maxsize=256)
        sub = {"q": q, "watermark": int(req.get("watermark", 0)),
               "cwm": int(req.get("chunks_watermark", 0))}
        with self._io_lock:
            self._subscribers.append(sub)

        def closed():
            with self._io_lock:
                try:
                    self._subscribers.remove(sub)
                except ValueError:
                    pass

        return {"_stream_queue": q, "_stream_closed": closed}

    def _op_reset(self, req: dict) -> dict:
        """The remote mirror of the in-process ReplicaHandle.restart():
        a handle rejoining an incarnation it had written off (a
        transport-blip 'death' — the process never died) must find a
        CLEAN replica: stale queue/running work dropped (its requests
        were already re-dispatched on survivors; finishing them here
        would double-spend the engine and replay rid history), slots
        released, dedup history forgotten. Returns the completions
        watermark so the client resyncs instead of replaying the whole
        history from 0."""
        with self._lock:
            self._drain_intake_locked()
            slots = list(self.scheduler.running.keys())
            self.scheduler.evacuate()   # clears queue/running/_resume
            for s in slots:
                self.engine.release(s)
            with self._io_lock:
                self._seen_rids.clear()
            self._publish()
            # both watermarks so the rejoining client resyncs its chunk
            # cursor too — the evacuated attempts' chunks stay in the
            # list (append-only) but none of them will ever see a final
            # marker; skipping ahead avoids replaying them
            return {"completions": len(self.scheduler.completions),
                    "chunks": len(self.scheduler.chunks)}

    def _op_shed(self, req: dict) -> dict:
        min_priority = int(req["min_priority"])
        # tenant-scoped brown-out (serve/router.py): a name list rides
        # the wire in place of the router's exact covers-predicate;
        # None/absent = global shed
        tenants = req.get("tenants")
        scope = None if tenants is None else {
            (t if t else "default") for t in tenants
        }
        with self._lock:
            # intake items are queued-but-not-drained: shed sees them too
            self._drain_intake_locked()
            shed = self.scheduler.shed_queued(
                lambda r: r.priority >= min_priority
                and (scope is None
                     or (r.tenant if r.tenant is not None
                         else "default") in scope)
            )
            self._publish()
            return {"rids": [r.rid for r in shed]}

    def _op_drain(self, req: dict) -> dict:
        with self._io_lock:
            self._draining = True
        with self._lock:
            return {"queue": len(self.scheduler.queue),
                    "active": self.engine.num_active}

    def _op_shutdown(self, req: dict) -> dict:
        self._stop.set()
        return {"bye": True}

    def begin_drain(self) -> None:
        """The SIGTERM path: refuse new submits (typed ``draining``
        refusal — the router re-dispatches those on survivors), finish
        every in-flight request to its natural end (consumers observe
        an uninterrupted stream, NO resume marker — the graceful column
        of the failure matrix), publish the final frames, exit 0.
        Signal-handler safe: only sets flags."""
        with self._io_lock:
            self._draining = True
        self._drain_exit = True
        self._wake.set()

    # ------------------------------------------------------- the loop
    def serve_forever(self) -> None:
        """Self-driven serve loop: tick whenever work exists; otherwise
        nap. RPC handlers mutate scheduler state under the same lock a
        tick holds, so a submit lands between (not inside) bursts."""
        while not self._stop.is_set():
            with self._lock:
                moved = self._drain_intake_locked()
                idle = self.scheduler.idle
                if not idle:
                    self.scheduler.step()
                if moved or not idle:
                    self._publish()
            if idle and not moved:
                if self._drain_exit:
                    with self._io_lock:
                        pending = bool(self._intake)
                    if not pending:
                        # drained: in-flight streams ran to their
                        # natural end and were published. Give the push
                        # loop a beat to flush the final frames, then
                        # exit 0 — the supervisor reaps a clean drain,
                        # not a crash.
                        time.sleep(0.25)
                        self._stop.set()
                        break
                # a truly idle replica SLEEPS (an 0.5 ms spin here
                # measurably taxed every OTHER process on a small box);
                # a submit sets the event, so admission latency stays
                # ~one RPC, not one timeout. While sleeping, keep the
                # push subscribers' heartbeat warm.
                if time.monotonic() - self._last_push > 0.1:
                    with self._io_lock:
                        subs = list(self._subscribers)
                    for sub in subs:
                        try:
                            sub["q"].put_nowait(
                                {"kind": "hb", "t": time.monotonic()}
                            )
                        except Exception:
                            pass
                    self._last_push = time.monotonic()
                self._wake.wait(0.05)
                self._wake.clear()
        # give the shutdown reply a beat to flush before teardown
        time.sleep(0.1)

    def close(self) -> None:
        self._stop.set()
        self.rpc.close()
        self.telemetry.close()

    def ready_line(self) -> str:
        return READY_PREFIX + json.dumps({
            "pid": os.getpid(),
            "replica": self.spec.replica,
            "rpc_port": self.rpc.port,
            "telemetry_port": self.telemetry.port,
            "weights_digest": self.weights_digest,
        })


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ddp_practice_tpu_torch.serve.worker")
    p.add_argument("--spec", required=True,
                   help="WorkerSpec JSON, or @path to a JSON file")
    args = p.parse_args(argv)
    text = args.spec
    if text.startswith("@"):
        with open(text[1:]) as f:
            text = f.read()
    spec = WorkerSpec.from_json(text)
    if spec.device == "cpu":
        import torch

        # a CPU worker shares the host's cores with the other workers
        # and the process driving them: torch's default pool, one
        # spinning thread per core in each, oversubscribes them
        torch.set_num_threads(1)
    server = WorkerServer(spec)
    # graceful SIGTERM: finish in-flight work, refuse new submits, exit
    # 0 once idle (handler only sets flags — never runs mid-burst)
    import signal

    signal.signal(signal.SIGTERM, lambda *_: server.begin_drain())
    print(server.ready_line(), flush=True)
    try:
        server.serve_forever()
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
