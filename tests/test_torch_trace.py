"""The port's request-lifecycle recorder (utils/trace.py) against the JAX
package's, on the CPU.

- One scripted sequence of lane spans, request spans, instants and lane
  labels on a hand-advanced clock gives the reference's Chrome trace
  JSON, OTLP JSON (the instrumentation scope aside: the port names its
  own) and incremental OTLP drains; the exports pass
  tools/check_traces.py and tools/check_otlp.py, also read back from
  `save` and `save_otlp`.
- The same sampled sequence (head decisions, staged spans, markers,
  tail verdicts, stage overflow) gives the reference's timeline,
  counters and sampling header; the streaming sink receives the
  reference's records.
- The ring buffer keeps the newest `max_events` and counts what it
  dropped; a disabled recorder records nothing and hands out one shared
  null span.
- `head_keep` and `TraceSampler` decide alike over 2000 trace ids at
  several rates, with tenant overrides, and give the same tail reasons.
- The port's Scheduler + SlotEngine and the reference's, run on a
  FakeClock with the same requests and converted weights, record the
  same timeline event for event (span names, lanes, timestamps, args),
  the same flight records and the same tokens.
"""

import json

import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import build_pair
from ddp_practice_tpu.utils import metrics as jax_metrics
from ddp_practice_tpu.utils import trace as jax_trace
from ddp_practice_tpu_torch.utils import metrics as port_metrics
from ddp_practice_tpu_torch.utils import trace
from tools.check_otlp import crosscheck_chrome, validate_otlp
from tools.check_traces import validate

SCOPE = {"ddp_practice_tpu_torch.trace": "ddp_practice_tpu.trace"}


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _scope_as_reference(otlp):
    """The port's OTLP export with its scope renamed to the reference's
    (the one field where the two libraries name themselves)."""
    out = json.loads(json.dumps(otlp))
    for rs in out["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            ss["scope"]["name"] = SCOPE.get(ss["scope"]["name"],
                                            ss["scope"]["name"])
    return out


def _script(mod, clock, rec):
    """One recording session: labels, nested and zero-length lane spans,
    request spans, instants (with and without a trace_id)."""
    mod.label_replica(rec, 0, 2)
    mod.label_router(rec)
    with rec.span("outer", pid=0, tid=mod.ENGINE_LANE, step=1):
        clock.advance(0.5)
        with rec.span("inner", pid=0, tid=mod.ENGINE_LANE):
            clock.advance(0.25)
        rec.instant("tick", pid=0, tid=0, n=3)
        clock.advance(0.25)
    for rid in (1, 2, 3):
        t = f"r{rid}"
        rec.record_async("queued", 0.0, 0.01 * rid, trace_id=t, pid=0)
        rec.record_span("prefill", 0.01 * rid, 0.02 * rid, trace_id=t,
                        pid=0, tid=mod.SLOT_LANE_BASE + rid % 2,
                        attrs={"bucket": 8, "prompt_len": rid})
        rec.record_instant("dispatch", 0.005, trace_id=t,
                           pid=mod.ROUTER_PID,
                           attrs={"replica": 0, "attempt": 0})
        rec.record_async("request", 0.0, 0.1 * rid, trace_id=t, pid=0,
                         attrs={"status": ("eos", "error", "length")[rid - 1],
                                "tokens": rid * 2, "ok": rid != 2,
                                "ratio": 0.5 * rid})
    rec.record_span("decode_burst", 0.05, 0.06, pid=0, tid=0,
                    attrs={"burst": 8, "active": 2})
    rec.record_span("a", 1.0, 1.0, pid=0, tid=2)
    rec.record_span("b", 1.0, 1.0, pid=0, tid=2)
    rec.instant("failover", trace_id="r2", pid=mod.ROUTER_PID,
                from_replica=0, salvaged=3)


def _session(mod, **kw):
    clock = Clock()
    rec = mod.TraceRecorder(clock=clock, **kw)
    sunk = []
    rec.set_sink(sunk.append)
    _script(mod, clock, rec)
    return rec, sunk


def test_chrome_and_otlp_exports_equal_the_references(tmp_path):
    ref, ref_sunk = _session(jax_trace)
    port, port_sunk = _session(trace)
    chrome = port.to_chrome_trace()
    assert chrome == ref.to_chrome_trace()
    assert validate(chrome) == []
    otlp = port.to_otlp()
    assert otlp["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] \
        == "ddp_practice_tpu_torch.trace"
    assert _scope_as_reference(otlp) == ref.to_otlp()
    assert validate_otlp(otlp) == []
    assert crosscheck_chrome(otlp, chrome) == []
    # the streaming sink saw the reference's records, labels first
    assert port_sunk == ref_sunk and port_sunk[0]["kind"] == "meta"
    # incremental drains: each record once, the root remembered
    for rec in (ref, port):
        rec.record_span("late", 2.0, 2.1, trace_id="r1", pid=0, tid=1)
    drains = [[_scope_as_reference(d) if d else d
               for d in (port.drain_otlp(), port.drain_otlp())],
              [ref.drain_otlp(), ref.drain_otlp()]]
    assert drains[0] == drains[1] and drains[0][1] is None
    path, opath = tmp_path / "t.json", tmp_path / "o.json"
    port.save(str(path))
    port.save_otlp(str(opath))
    assert validate(json.loads(path.read_text())) == []
    assert validate_otlp(json.loads(opath.read_text())) == []


def _sampled(mod):
    clock = Clock()
    rec = mod.TraceRecorder(clock=clock)
    reg_mod = (jax_metrics if mod is jax_trace else port_metrics)
    registry = reg_mod.MetricsRegistry()
    rec.set_sampler(mod.TraceSampler(0.3, keep_slow_s=0.5, stage_limit=4,
                                     tenant_rates={"gold": 1.0}),
                    registry=registry)
    mod.label_replica(rec, 0, 1)
    decisions, kept = [], []
    for i in range(40):
        tid = f"r{i}"
        decisions.append(rec.begin_trace(
            tid, tenant="gold" if i % 7 == 0 else None))
        rec.begin_trace(tid)                       # idempotent
        rec.record_async("queued", i * 0.1, i * 0.1 + 0.01, trace_id=tid)
        for k in range(3 + i % 4):                 # some overflow the stage
            rec.record_span("prefill", i * 0.1, i * 0.1 + 0.002 * k,
                            trace_id=tid, tid=1)
        if i % 11 == 5:
            rec.record_instant("preempt", i * 0.1 + 0.02, trace_id=tid)
        if i % 13 == 3:
            rec.note_keep(tid, "resumed")
        rec.record_span("decode_burst", i * 0.1, i * 0.1 + 0.01, tid=0,
                        sampled_only=True)
        status = ("eos", "error", "length", "shed", "eos")[i % 5]
        kept.append(rec.finish_trace(
            tid, status=status, latency_s=0.05 * (i % 15),
            retries=int(i % 9 == 2), failovers=int(i % 17 == 4)))
        kept.append(rec.finish_trace(tid, status="eos"))  # memoized
        kept.append(rec.trace_recorded(tid))
    return (decisions, kept, rec.to_chrome_trace(), rec.sampling_meta(),
            rec.dropped, registry.snapshot())


def test_sampled_timeline_and_counters_equal_the_references():
    ref, port = _sampled(jax_trace), _sampled(trace)
    for got, want in zip(port, ref):
        assert got == want
    decisions, kept, chrome, meta = port[:4]
    assert 0 < sum(decisions) < len(decisions)
    assert meta["traces_kept"] > 0 and meta["traces_suppressed"] > 0
    assert chrome["metadata"]["sampling"] == meta
    assert validate(chrome) == []


def test_ring_buffer_bound_and_disabled_recorder():
    outs = []
    for mod in (jax_trace, trace):
        r = mod.TraceRecorder(clock=Clock(), max_events=16)
        for i in range(1000):
            r.instant(f"e{i}", pid=0)
        outs.append((len(r), r.dropped, r.to_chrome_trace()))
    assert outs[1] == outs[0]
    n, dropped, chrome = outs[1]
    assert n == 16 and dropped == 984
    assert [e["name"] for e in chrome["traceEvents"] if e["ph"] == "i"] \
        == [f"e{i}" for i in range(984, 1000)]
    assert chrome["metadata"] == {"trace_events_dropped": 984}

    r = trace.TraceRecorder(clock=Clock(), enabled=False)
    s1, s2 = r.span("a", pid=0), r.span("b", pid=0)
    assert s1 is s2 is trace.NULL_SPAN
    with s1:
        pass
    r.instant("x", pid=0)
    r.record_async("request", 0.0, 1.0, trace_id="r0", pid=0)
    r.record_span("s", 0.0, 1.0)
    assert len(r) == 0 and r.begin_trace("r0") is True
    r.enable()
    r.instant("y", pid=0)
    assert len(r) == 1
    r.clear()
    assert len(r) == 0
    with pytest.raises(ValueError):
        trace.TraceRecorder(max_events=0)


def test_head_keep_and_sampler_decide_as_the_reference():
    ids = [f"r{i}" for i in range(1000)] + [f"t-{i:x}" for i in range(1000)]
    for rate in (0.0, 0.01, 0.1, 0.5, 0.99, 1.0):
        got = [trace.head_keep(t, rate) for t in ids]
        assert got == [jax_trace.head_keep(t, rate) for t in ids]
    kw = dict(keep_slow_s=0.2, tenant_rates={"a": 1.0, "b": 0.0})
    mine = trace.TraceSampler(0.05, **kw)
    ref = jax_trace.TraceSampler(0.05, **kw)
    tenants = (None, "a", "b", "c")
    assert [mine.sampled(t, tenants[i % 4]) for i, t in enumerate(ids)] \
        == [ref.sampled(t, tenants[i % 4]) for i, t in enumerate(ids)]
    assert sum(mine.sampled(t) for t in ids) in range(60, 141)
    grid = [dict(status=s, latency_s=lat, retries=r, failovers=f)
            for s in ("eos", "length", "error", "shed", "timeout", None)
            for lat in (None, 0.1, 0.3) for r in (0, 1) for f in (0, 2)]
    assert [mine.keep_reason(**g) for g in grid] \
        == [ref.keep_reason(**g) for g in grid]
    assert trace.KEEP_MARKERS == jax_trace.KEEP_MARKERS
    assert (trace.ENGINE_LANE, trace.SLOT_LANE_BASE, trace.ROUTER_PID) == (
        jax_trace.ENGINE_LANE, jax_trace.SLOT_LANE_BASE,
        jax_trace.ROUTER_PID)
    with pytest.raises(ValueError):
        trace.TraceSampler(stage_limit=0)


# ------------------------------------------------- scheduler + engine
@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=3, pos_emb="rope", max_len=64)


def _serve_run(pair, port: bool, sampled: bool = False):
    """4 requests on 2 slots of one engine on a FakeClock (two queue),
    traced; returns (chrome trace, flights, tokens)."""
    jm, params, tm = pair
    if port:
        from ddp_practice_tpu_torch.serve import engine as eng
        from ddp_practice_tpu_torch.serve import scheduler as sch
        mod = trace
    else:
        from ddp_practice_tpu.serve import engine as eng
        from ddp_practice_tpu.serve import scheduler as sch
        mod = jax_trace
    cfg = eng.EngineConfig(max_slots=2, max_len=64, prompt_buckets=(8,),
                           eos_id=None, decode_burst=2)
    engine = (eng.SlotEngine(tm, cfg) if port
              else eng.SlotEngine(jm, params, cfg))
    clock = sch.FakeClock(step_s=0.01)
    rec = mod.TraceRecorder(clock=clock)
    if sampled:
        rec.set_sampler(mod.TraceSampler(0.5))
    engine.set_tracer(rec, 0)
    mod.label_replica(rec, 0, 2)
    sched = sch.Scheduler(engine, clock=clock, tracer=rec, replica=0)
    for rid in range(4):
        sched.submit(sch.Request(rid=rid, prompt=[1 + rid, 2, 3],
                                 max_new_tokens=3 + rid))
    comps = sched.run_until_idle()
    return (rec.to_chrome_trace(), [c.flight for c in comps],
            {c.rid: list(c.tokens) for c in comps},
            [c.status for c in comps])


@pytest.mark.parametrize("sampled", [False, True])
def test_scheduler_and_engine_record_the_references_timeline(pair, sampled):
    want = _serve_run(pair, port=False, sampled=sampled)
    got = _serve_run(pair, port=True, sampled=sampled)
    chrome, flights, tokens, statuses = got
    assert statuses == ["length"] * 4
    assert tokens == want[2]
    assert flights == want[1]
    assert chrome == want[0]
    assert validate(chrome) == []
    names = {(e["name"], e["ph"]) for e in chrome["traceEvents"]}
    if not sampled:
        assert {("prefill", "B"), ("decode_burst", "B"), ("queued", "b"),
                ("request", "b")} <= names
    lanes = {(e["name"], e["tid"]) for e in chrome["traceEvents"]
             if e["ph"] == "B"}
    assert all(tid == trace.ENGINE_LANE for n, tid in lanes
               if n == "decode_burst")
    assert all(tid >= trace.SLOT_LANE_BASE for n, tid in lanes
               if n == "prefill")
