"""The port's worker fleet (serve/rpc.py, worker.py, supervisor.py).

- the RPC framing writes the reference's bytes, and the client, server,
  timeouts, retries and push streams work in-process;
- the reference's host-pure Supervisor and RemoteReplicaHandle cases
  (tests/test_worker_supervisor.py), ported: `spawn_fn` is injected with
  fakes and time is a FakeClock, so the restart-backoff schedule, the
  restart-budget breaker, drain, shrink/grow and the handle's salvage
  and heartbeat accounting replay deterministically;
- one real worker process on the CPU, started as the supervisor starts
  it, whose greedy tokens over RPC equal the in-process scheduler's;
- real SIGKILL and SIGSTOP of a worker mid-decode (`slow`, as the
  reference marks its fleet e2e cases).
"""

import socket
import threading
import time

import pytest

import ddp_practice_tpu.serve.rpc as jrpc
from ddp_practice_tpu_torch.serve.faults import (
    FaultPlan,
    FaultSpec,
    FleetFaultDriver,
    ReplicaCrashed,
)
from ddp_practice_tpu_torch.serve.rpc import (
    MAX_FRAME_BYTES,
    RpcClient,
    RpcError,
    RpcRemoteError,
    RpcServer,
    RpcTimeout,
    open_stream,
    recv_frame,
    send_frame,
)
from ddp_practice_tpu_torch.serve.scheduler import FakeClock, Request
from ddp_practice_tpu_torch.serve.supervisor import (
    BACKOFF,
    DRAINING,
    FAILED,
    RUNNING,
    SPAWNING,
    STOPPED,
    RemoteReplicaHandle,
    Supervisor,
    SupervisorConfig,
    fleet_targets,
    live_worker_pids,
    make_fleet_router,
    reap_all,
)
from ddp_practice_tpu_torch.serve.worker import WorkerSpec
from ddp_practice_tpu_torch.utils.backoff import backoff_delay


@pytest.fixture(autouse=True)
def _no_orphans():
    """Every case leaves no worker process behind, however it ends."""
    yield
    leaked = reap_all()
    assert leaked == [], f"worker processes outlived the case: {leaked}"


# ----------------------------------------------------------------- framing
@pytest.mark.parametrize("msg", [
    {"op": "ping"},
    {"op": "submit", "request": {"rid": 3, "prompt": [1, 2, 3],
                                 "deadline": None, "tenant": "acme"}},
    {"ok": True, "s": "naïve — ünïcödé", "nested": {"a": [1, {"b": None}]},
     "tokens": list(range(300)), "t": 12.5},
])
def test_send_frame_bytes_match_the_reference(msg):
    out = []
    for fn in (send_frame, jrpc.send_frame):
        a, b = socket.socketpair()
        try:
            fn(a, msg)
            a.close()
            chunks = []
            while True:
                got = b.recv(65536)
                if not got:
                    break
                chunks.append(got)
            out.append(b"".join(chunks))
        finally:
            b.close()
    assert out[0] == out[1]
    a, b = socket.socketpair()
    try:
        send_frame(a, msg)
        assert jrpc.recv_frame(b) == msg
    finally:
        a.close()
        b.close()


def test_frame_rejects_oversize_and_truncation():
    a, b = socket.socketpair()
    try:
        with pytest.raises(RpcError):
            send_frame(a, {"big": "x" * (MAX_FRAME_BYTES + 1)})
        a.sendall(b"\xff\xff\xff\xff")
        with pytest.raises(RpcError):
            recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    a.sendall(b"\x00\x00\x00\x10half")
    a.close()
    try:
        with pytest.raises(RpcError):
            recv_frame(b)
    finally:
        b.close()


# ------------------------------------------------------- client <-> server
@pytest.mark.net
def test_server_dispatch_remote_error_and_cast():
    calls = []
    seen = threading.Event()

    def echo(req):
        calls.append(req)
        return {"echo": req.get("payload")}

    def note(req):
        calls.append(req)
        seen.set()
        return {}

    def boom(req):
        raise ValueError("handler exploded")

    with RpcServer({"echo": echo, "note": note, "boom": boom}) as srv:
        with RpcClient("127.0.0.1", srv.port, timeout_s=5.0) as c:
            r = c.call("echo", payload=[1, 2, 3])
            assert r["ok"] and r["echo"] == [1, 2, 3]
            with pytest.raises(RpcRemoteError, match="handler exploded"):
                c.call("boom")
            with pytest.raises(RpcRemoteError, match="unknown op"):
                c.call("nope")
            c.cast("note", payload="one-way")
            assert seen.wait(5.0)
            assert c.call("echo", payload="still alive")["echo"] \
                == "still alive"
    assert [x.get("payload") for x in calls] == [[1, 2, 3], "one-way",
                                                 "still alive"]


@pytest.mark.net
def test_call_times_out_on_stalled_handler():
    """A handler that never answers (the SIGSTOP stand-in) raises
    RpcTimeout within the per-call budget instead of hanging."""
    release = threading.Event()

    def stall(req):
        release.wait(10.0)
        return {}

    with RpcServer({"stall": stall}) as srv:
        c = RpcClient("127.0.0.1", srv.port, timeout_s=0.2, retries=0)
        t0 = time.monotonic()
        with pytest.raises(RpcTimeout):
            c.call("stall")
        assert time.monotonic() - t0 < 5.0
        c.close()
        release.set()


@pytest.mark.net
def test_transport_retry_reconnects_with_backoff():
    srv = RpcServer({"ping": lambda req: {"pong": 1}})
    port = srv.port
    slept = []
    c = RpcClient("127.0.0.1", port, timeout_s=2.0, retries=3,
                  retry_base_s=0.01, sleep=slept.append)
    assert c.call("ping")["pong"] == 1
    srv.close()
    replacement = {}

    def bring_back():
        time.sleep(0.05)
        replacement["srv"] = RpcServer({"ping": lambda req: {"pong": 2}},
                                       port=port)

    t = threading.Thread(target=bring_back)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        while True:
            try:
                r = c.call("ping")
                break
            except RpcError:
                assert time.monotonic() < deadline
        assert r["pong"] == 2
        assert slept, "no backoff sleeps recorded on the retry path"
    finally:
        t.join()
        c.close()
        replacement["srv"].close()


@pytest.mark.net
def test_connect_refused_raises_after_retries():
    slept = []
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    c = RpcClient("127.0.0.1", port, timeout_s=0.5, retries=2,
                  retry_base_s=0.001, sleep=slept.append)
    with pytest.raises(RpcError):
        c.call("ping")
    assert len(slept) == 2  # one backoff per extra attempt


@pytest.mark.net
def test_push_stream_delivers_queued_frames():
    """A handler answering with a queue turns its connection into a push
    stream (the worker's `subscribe`): frames arrive in order on
    `drain()`, and the close hook runs when the stream dies."""
    import queue

    closed = threading.Event()
    q = queue.Queue()

    def subscribe(req):
        return {"_stream_queue": q, "_stream_closed": closed.set}

    with RpcServer({"subscribe": subscribe}) as srv:
        stream = open_stream("127.0.0.1", srv.port, watermark=0,
                             timeout_s=2.0)
        for i in range(3):
            q.put({"kind": "pub", "i": i})
        got = []
        deadline = time.monotonic() + 5.0
        while len(got) < 3 and time.monotonic() < deadline:
            got.extend(stream.drain())
            time.sleep(0.01)
        assert [f["i"] for f in got] == [0, 1, 2]
        assert stream.fileno() >= 0
        q.put(None)
        assert closed.wait(5.0)
        stream.close()


# ------------------------------------------------------------- supervisor
class FakeClient:
    """Scriptable RPC client: `handler(op, fields)` -> dict or raise."""

    def __init__(self, handler=None):
        self.handler = handler or (lambda op, fields: {})
        self.calls = []
        self.closed = False

    def call(self, op, **fields):
        self.calls.append((op, fields))
        return {"ok": True, **self.handler(op, fields)}

    def close(self):
        self.closed = True


class FakeWorker:
    _next_pid = [1000]

    def __init__(self, spec, handler=None):
        FakeWorker._next_pid[0] += 1
        self.pid = FakeWorker._next_pid[0]
        self.spec = spec
        self.rc = None
        self.signals = []
        self.reaped = False
        self.telemetry_port = 9000 + self.pid % 100
        self.client = FakeClient(handler)

    def poll(self):
        return self.rc

    def kill_signal(self, sig):
        self.signals.append(sig)
        if sig in ("SIGKILL", "SIGTERM"):
            self.rc = -9

    def die(self, rc=1):
        self.rc = rc

    def reap(self, timeout_s=5.0):
        self.reaped = True
        self.client.close()


SPEC = WorkerSpec(engine={"max_slots": 2, "prompt_buckets": [8, 16]},
                  max_queue=4)
CFG = SupervisorConfig(restart_base_s=0.2, restart_factor=2.0,
                       restart_max_s=10.0, restart_jitter=0.0,
                       restart_budget=3)


def make_sup(n=1, handler=None, cfg=CFG):
    spawned = []

    def spawn(spec):
        w = FakeWorker(spec, handler)
        spawned.append(w)
        return w

    clock = FakeClock(step_s=0.01)
    sup = Supervisor([SPEC] * n, cfg, spawn_fn=spawn,
                     spawn_in_thread=False, clock=clock)
    sup.start()
    return sup, clock, spawned


# ------------------------------------------------------------- supervisor
def test_restart_backoff_schedule_is_the_shared_backoff():
    """A dying worker respawns at exactly backoff_delay(k) after each
    death — the same utils/backoff.py schedule every other retry loop
    uses, per-slot seeded."""
    sup, clock, spawned = make_sup()
    assert sup.state(0) == RUNNING and len(spawned) == 1
    for k in range(3):
        spawned[-1].die()
        t_death = clock.now()
        sup.poll()
        assert sup.state(0) == BACKOFF
        assert spawned[-1].reaped          # the corpse was collected
        want = backoff_delay(k, base_s=0.2, factor=2.0, max_s=10.0,
                             jitter=0.0, seed=CFG.seed + 0)
        # one tick before due: nothing spawns
        clock.advance(want - 0.001 - (clock.now() - t_death))
        sup.poll()
        assert sup.state(0) == BACKOFF and len(spawned) == 1 + k
        clock.advance(0.002)
        sup.poll()
        assert sup.state(0) == RUNNING and len(spawned) == 2 + k
        assert sup.restarts[0] == k + 1
        # a restarted slot is a NEW process (new pid, new client)
        assert spawned[-1].pid != spawned[-2].pid


def test_restart_budget_circuit_breaker_goes_failed():
    sup, clock, spawned = make_sup()
    for _ in range(CFG.restart_budget):
        spawned[-1].die()
        sup.poll()
        clock.advance(60.0)  # well past any backoff
        sup.poll()
        assert sup.state(0) == RUNNING
    # one death past the budget: FAILED for good, no more spawns
    spawned[-1].die()
    sup.poll()
    assert sup.state(0) == FAILED
    clock.advance(3600.0)
    sup.poll()
    assert sup.state(0) == FAILED
    assert len(spawned) == 1 + CFG.restart_budget
    assert sup.worker(0) is None


def test_rolling_window_budget_half_closes_after_storm_ages_out():
    """With restart_window_s configured, FAILED is a cool-down, not a
    grave: only restarts inside the rolling window count against the
    budget, so once the crash storm ages out the breaker half-closes
    and the slot respawns on its own — no operator in the loop."""
    cfg = SupervisorConfig(restart_base_s=0.2, restart_factor=2.0,
                           restart_max_s=10.0, restart_jitter=0.0,
                           restart_budget=3, restart_window_s=300.0)
    sup, clock, spawned = make_sup(cfg=cfg)
    for _ in range(cfg.restart_budget):       # deaths at t=0, 60, 120
        spawned[-1].die()
        sup.poll()
        clock.advance(60.0)
        sup.poll()
        assert sup.state(0) == RUNNING
    spawned[-1].die()                         # 4th death inside window
    sup.poll()
    assert sup.state(0) == FAILED and sup.worker(0) is None
    # still inside the window: the breaker stays open, nothing spawns
    clock.advance(100.0)                      # t=280; oldest was t=0
    sup.poll()
    assert sup.state(0) == FAILED
    assert len(spawned) == 1 + cfg.restart_budget
    # the t=0 restart leaves the 300 s window: half-close and rejoin
    clock.advance(30.0)                       # t=310
    sup.poll()
    assert sup.state(0) == BACKOFF
    sup.poll()                                # due immediately
    assert sup.state(0) == RUNNING
    assert len(spawned) == 2 + cfg.restart_budget


def test_revive_escape_hatch_resets_budget_and_respawns():
    """revive(slot) is the operator's override for a lifetime-budget
    FAILED slot: back in play NOW with a FRESH budget (a revive that
    instantly re-tripped would be no escape), lifetime restart
    telemetry preserved. A no-op on any non-FAILED slot."""
    sup, clock, spawned = make_sup()
    sup.revive(0)                             # no-op on a live slot
    assert sup.state(0) == RUNNING
    for _ in range(CFG.restart_budget + 1):
        spawned[-1].die()
        sup.poll()
        clock.advance(60.0)
        sup.poll()
    assert sup.state(0) == FAILED
    lifetime = sup.restarts[0]
    assert lifetime == CFG.restart_budget
    clock.advance(3600.0)                     # no window: FAILED stays
    sup.poll()
    assert sup.state(0) == FAILED
    sup.revive(0)
    assert sup.state(0) == BACKOFF
    sup.poll()                                # due immediately
    assert sup.state(0) == RUNNING
    assert len(spawned) == 2 + CFG.restart_budget
    assert sup.restarts[0] == lifetime        # telemetry preserved
    # the budget really is fresh: the next death restarts, no re-trip
    spawned[-1].die()
    sup.poll()
    assert sup.state(0) == BACKOFF
    clock.advance(60.0)
    sup.poll()
    assert sup.state(0) == RUNNING


def test_spawn_failure_consumes_budget_and_reschedules():
    """A spec that cannot boot must walk the same backoff->budget->
    FAILED path as a crash loop, not spin forever."""
    boots = []

    def flaky_spawn(spec):
        boots.append(1)
        raise RuntimeError("no ready line")

    clock = FakeClock()
    sup = Supervisor([SPEC], CFG, spawn_fn=flaky_spawn,
                     spawn_in_thread=False, clock=clock)
    # start() itself failing is the caller's problem; enter the loop
    # with a worker that dies immediately instead
    ok = FakeWorker(SPEC)
    sup.workers[0] = ok
    sup.states[0] = RUNNING
    ok.die()
    while sup.state(0) not in (FAILED,):
        sup.poll()
        clock.advance(60.0)
    assert sup.state(0) == FAILED
    assert len(boots) == CFG.restart_budget


def test_stop_drains_gracefully_and_reaps():
    shutdowns = []

    def handler(op, fields):
        if op == "shutdown":
            shutdowns.append(1)
        return {}

    sup, clock, spawned = make_sup(n=2, handler=handler)

    # graceful workers exit when told to (rpc shutdown -> rc 0)
    def exiting_handler(op, fields):
        out = handler(op, fields)
        if op == "shutdown":
            for w in spawned:
                w.rc = 0
        return out

    for w in spawned:
        w.client.handler = exiting_handler
    sup.stop()
    assert all(w.reaped for w in spawned)
    assert all(sup.state(i) == STOPPED for i in range(2))
    assert len(shutdowns) == 2            # one graceful ask per worker
    assert all(not w.signals for w in spawned)   # never escalated
    assert all(w.client.closed for w in spawned)


# ------------------------------------------------------------- the handle
def make_handle(handler=None, heartbeat_timeout_s=2.0):
    sup, clock, spawned = make_sup(handler=handler)
    h = RemoteReplicaHandle(0, sup, SPEC, clock=clock,
                            heartbeat_timeout_s=heartbeat_timeout_s)
    return h, sup, clock, spawned


def _poll_reply(completions=(), inflight=(), queue=0, active=0):
    return {
        "completions": list(completions), "inflight": list(inflight),
        "watermark": len(completions),
        "stats": {"queue": queue, "active": active, "max_slots": 2,
                  "compile_stats": {"prefill": 1}},
    }


def test_handle_salvage_point_feeds_evacuate():
    """poll refreshes tokens-so-far; a later death evacuates exactly the
    last salvage — the cross-process mirror of Scheduler.evacuate."""
    state = {"inflight": []}

    def handler(op, fields):
        if op == "poll":
            return _poll_reply(inflight=state["inflight"])
        return {"accepted": True}

    h, sup, clock, spawned = make_handle(handler)
    req = Request(rid=7, prompt=[1, 2, 3], max_new_tokens=8,
                  arrival=0.0, trace_id="r7")
    h.submit(req)
    assert 7 in h.outstanding
    state["inflight"] = [{"rid": 7, "tokens": [5, 6], "ftt": 0.5,
                          "phases": {"queue_s": 0.1, "prefill_s": 0.2,
                                     "decode_s": 0.3}}]
    h.step()
    assert h.outstanding[7]["tokens"] == [5, 6]
    # the worker dies for real: step raises, evacuate hands back the
    # ORIGINAL request with the salvaged tokens
    spawned[-1].die()
    with pytest.raises(ReplicaCrashed):
        h.step()
    ev = h.evacuate()
    assert len(ev) == 1
    evreq, tokens, ftt, phases = ev[0]
    assert evreq is req and tokens == [5, 6] and ftt == 0.5
    assert phases["decode_s"] == 0.3
    assert h.outstanding == {}


def test_handle_completion_consumption_clears_outstanding():
    comp = {"rid": 3, "tokens": [9, 9], "status": "length",
            "arrival": 0.0, "finish": 1.0, "ttft": 0.1, "tpot": 0.05,
            "flight": None}
    replies = {"n": 0}

    def handler(op, fields):
        if op == "poll":
            replies["n"] += 1
            return _poll_reply(completions=[comp] if replies["n"] == 1
                               else [])
        return {"accepted": True}

    h, sup, clock, spawned = make_handle(handler)
    h.submit(Request(rid=3, prompt=[1], max_new_tokens=2, arrival=0.0))
    h.step()
    got = h.poll()
    assert [c.rid for c in got] == [3] and got[0].status == "length"
    assert h.outstanding == {}
    assert h.poll() == []  # consume-once


def test_handle_stale_heartbeat_sigkills_and_raises():
    """A worker alive by waitpid but silent on the wire (SIGSTOP) must
    be put down with a REAL SIGKILL once the heartbeat budget runs out
    — silence is death, but only after the budget, so one slow tick
    isn't a failover."""

    def handler(op, fields):
        if op == "poll":
            raise RpcTimeout("stalled")
        return {}

    h, sup, clock, spawned = make_handle(handler, heartbeat_timeout_s=1.0)
    h.step()      # first silent tick: starts the staleness clock
    assert spawned[-1].signals == []
    clock.advance(0.5)
    h.step()      # still inside the budget: no kill, no crash
    assert spawned[-1].signals == []
    clock.advance(0.6)
    with pytest.raises(ReplicaCrashed, match="stale"):
        h.step()
    assert spawned[-1].signals == ["SIGKILL"]


def test_handle_submit_failure_breaks_on_next_step_and_keeps_request():
    def handler(op, fields):
        if op == "submit":
            raise RpcTimeout("wire down")
        return _poll_reply()

    h, sup, clock, spawned = make_handle(handler)
    req = Request(rid=1, prompt=[1], max_new_tokens=2, arrival=0.0)
    h.submit(req)
    with pytest.raises(ReplicaCrashed):
        h.step()
    assert [t[0] for t in h.evacuate()] == [req]


def test_handle_probe_and_restart_resync():
    """probe_ok needs a RUNNING process that answers ping; restart()
    resets the watermark to the new process's empty completions."""
    h, sup, clock, spawned = make_handle(
        lambda op, fields: _poll_reply() if op == "poll" else {}
    )
    h.step()
    h.consumed = 17
    spawned[-1].die()
    with pytest.raises(ReplicaCrashed):
        h.step()
    assert not h.probe_ok(clock.now())     # corpse: no process
    # supervisor brings a replacement up after the backoff
    clock.advance(60.0)
    sup.poll()
    assert sup.state(0) == RUNNING
    assert h.probe_ok(clock.now())
    h.restart()
    assert h.consumed == 0 and h.heartbeat_age() == 0.0


def test_fleet_fault_driver_fires_each_kill_once_in_order():
    """`kill` specs fire at their at_s edge, exactly once, through the
    injected kill_fn — and never leak into the per-scheduler injector
    (they target processes, not schedulers)."""
    plan = FaultPlan([
        FaultSpec(kind="kill", at_s=2.0, replica=1, sig="SIGSTOP"),
        FaultSpec(kind="kill", at_s=1.0, replica=0),
    ])
    fired = []
    drv = FleetFaultDriver(plan, lambda r, s: fired.append((r, s)))
    drv.poll(0.5)
    assert fired == [] and not drv.done
    drv.poll(1.0)
    assert fired == [(0, "SIGKILL")]
    drv.poll(5.0)   # a LATE poll still fires everything due
    assert fired == [(0, "SIGKILL"), (1, "SIGSTOP")] and drv.done
    drv.poll(9.0)
    assert len(fired) == 2          # once means once
    # kill specs never reach a scheduler's fault hook
    assert plan.injector(0) is None and plan.injector(1) is None
    # and they survive the JSON round trip like every other fault kind
    plan2 = FaultPlan.from_json(plan.to_json())
    assert [(f.replica, f.sig) for f in plan2.kills()] \
        == [(0, "SIGKILL"), (1, "SIGSTOP")]
    with pytest.raises(ValueError, match="signal"):
        FaultSpec(kind="kill", sig="SIGWINCH")


def test_fleet_targets_shape():
    h, sup, clock, spawned = make_handle(
        lambda op, fields: _poll_reply() if op == "poll" else {}
    )
    h.step()
    t = fleet_targets(sup, [h])
    assert t[0]["up"] and t[0]["pid"] == spawned[-1].pid
    assert t[0]["port"] == spawned[-1].telemetry_port
    assert t[0]["heartbeat_age_s"] == 0.0
    spawned[-1].die()
    sup.poll()
    t = fleet_targets(sup, [h])
    assert not t[0]["up"] and t[0]["pid"] is None
    assert t[0]["state"] in (BACKOFF, SPAWNING)


# ------------------------------------------------- elastic actuators
class DrainingWorker(FakeWorker):
    """A FakeWorker that honors SIGTERM as a REQUEST, not a death:
    only SIGKILL fells it, so the DRAINING window is observable (the
    harness FakeWorker drops dead on SIGTERM, which pins the fast path
    but hides the deadline machinery)."""

    def kill_signal(self, sig):
        self.signals.append(sig)
        if sig == "SIGKILL":
            self.rc = -9


def make_sup_draining(n=1, handler=None, cfg=None):
    spawned = []

    def spawn(spec):
        w = DrainingWorker(spec, handler)
        spawned.append(w)
        return w

    clock = FakeClock(step_s=0.01)
    sup = Supervisor([SPEC] * n, cfg or CFG, spawn_fn=spawn,
                     spawn_in_thread=False, clock=clock)
    sup.start()
    return sup, clock, spawned


def test_shrink_running_drains_rpc_then_sigterm_no_budget():
    """shrink() of a RUNNING slot: drain rpc first (refusals start even
    if signal delivery lags), then SIGTERM -> DRAINING; the exit is
    retired to STOPPED with zero budget charge and zero respawn."""
    sup, clock, spawned = make_sup(n=2)
    assert sup.active_slots() == 2
    assert sup.shrink(1) == DRAINING
    w = spawned[1]
    assert ("drain", {"timeout_s": 1.0, "retries": 0}) in w.client.calls
    assert w.signals == ["SIGTERM"]
    # a DRAINING worker is still a live process to the handle's eyes
    assert sup.worker(1) is w and not sup.alive(1)
    assert sup.draining(1) and sup.active_slots() == 1
    # the harness FakeWorker exits on SIGTERM: next poll retires it
    sup.poll()
    assert sup.state(1) == STOPPED and w.reaped
    assert sup.worker(1) is None
    # an intentional goodbye is not a crash: no budget, no respawn
    assert sup.restarts[1] == 0 and sup._budget_used[1] == 0
    clock.advance(3600.0)
    sup.poll()
    assert sup.state(1) == STOPPED and len(spawned) == 2
    # slot 0 untouched throughout
    assert sup.state(0) == RUNNING


def test_shrink_draining_deadline_escalates_to_sigkill():
    """A drain that never converges is put down at shrink_kill_after_s
    — and the SIGKILLed corpse still retires to STOPPED, not BACKOFF."""
    cfg = SupervisorConfig(restart_base_s=0.2, restart_jitter=0.0,
                           restart_budget=3, shrink_kill_after_s=5.0)
    sup, clock, spawned = make_sup_draining(cfg=cfg)
    sup.shrink(0)
    w = spawned[0]
    assert sup.state(0) == DRAINING and w.signals == ["SIGTERM"]
    clock.advance(4.9)
    sup.poll()                      # inside the grace window: no kill
    assert sup.state(0) == DRAINING and w.signals == ["SIGTERM"]
    clock.advance(0.2)
    sup.poll()                      # past the deadline: SIGKILL
    assert w.signals == ["SIGTERM", "SIGKILL"]
    sup.poll()                      # corpse collected
    assert sup.state(0) == STOPPED and w.reaped
    assert sup.restarts[0] == 0 and sup._budget_used[0] == 0


def test_shrink_chaos_sigkill_mid_drain_is_not_a_crash():
    """Chaos SIGKILLs the worker WHILE it drains: the slot must retire
    to STOPPED — a draining slot that respawned would undo the
    scale-down, and a budget charge would punish an intentional act."""
    sup, clock, spawned = make_sup_draining()
    sup.shrink(0)
    assert sup.state(0) == DRAINING
    spawned[0].die(rc=-9)           # external SIGKILL, not ours
    sup.poll()
    assert sup.state(0) == STOPPED and spawned[0].reaped
    assert sup.restarts[0] == 0 and sup._budget_used[0] == 0
    clock.advance(3600.0)
    sup.poll()
    assert sup.state(0) == STOPPED and len(spawned) == 1


def test_shrink_backoff_cancels_pending_respawn_without_budget():
    """Satellite pin: shrink() of a slot sitting in BACKOFF cancels the
    scheduled respawn outright — the slot goes STOPPED, the backoff
    timer never fires, and the budget ledger is exactly what the crash
    alone made it."""
    sup, clock, spawned = make_sup()
    spawned[-1].die()
    sup.poll()
    assert sup.state(0) == BACKOFF
    used_before = sup._budget_used[0]
    restarts_before = sup.restarts[0]
    assert sup.shrink(0) == STOPPED
    clock.advance(3600.0)           # way past every backoff delay
    sup.poll()
    assert sup.state(0) == STOPPED and len(spawned) == 1
    assert sup._budget_used[0] == used_before
    assert sup.restarts[0] == restarts_before


def test_shrink_spawning_cancels_inflight_attempt():
    """Satellite pin: shrink() of a slot whose RESPAWN is in flight on
    a spawn thread flags the attempt; _collect_spawn reaps the fresh
    worker instead of seating it, and the cancellation itself charges
    no budget beyond what the original crash already did."""
    import threading
    import time as _time

    release = threading.Event()
    spawned = []

    def spawn(spec):
        if spawned:                     # first boot is synchronous
            release.wait(5.0)
        w = FakeWorker(spec)
        spawned.append(w)
        return w

    clock = FakeClock(step_s=0.01)
    sup = Supervisor([SPEC], CFG, spawn_fn=spawn,
                     spawn_in_thread=True, clock=clock)
    sup.start()
    assert sup.state(0) == RUNNING
    spawned[0].die()
    sup.poll()                          # death -> BACKOFF (1 budget)
    clock.advance(60.0)
    sup.poll()                          # due -> SPAWNING, blocked
    assert sup.state(0) == SPAWNING
    used = sup._budget_used[0]
    rest = sup.restarts[0]
    assert sup.shrink(0) == SPAWNING    # stays until the attempt lands
    assert sup.active_slots() == 1      # still in the pipeline... just
    release.set()
    deadline = _time.monotonic() + 5.0
    while sup.state(0) == SPAWNING and _time.monotonic() < deadline:
        sup.poll()
        _time.sleep(0.005)
    assert sup.state(0) == STOPPED
    assert len(spawned) == 2
    assert spawned[1].reaped            # born cancelled, reaped
    assert sup.worker(0) is None
    assert sup._budget_used[0] == used and sup.restarts[0] == rest
    assert sup.active_slots() == 0


def test_grow_appends_warm_and_cold_slots():
    """grow() is append-only: a warm standby seats RUNNING immediately
    (promotion is a list append, not a spawn); a cold grow rides the
    normal BACKOFF->spawn pipeline due NOW, with zero budget charge."""
    sup, clock, spawned = make_sup()
    warm = FakeWorker(SPEC)
    slot = sup.grow(SPEC, worker=warm)
    assert slot == 1
    assert sup.state(1) == RUNNING and sup.worker(1) is warm
    assert sup.active_slots() == 2 and len(spawned) == 1  # no spawn
    cold = sup.grow(SPEC)
    assert cold == 2 and sup.state(2) == BACKOFF
    sup.poll()                          # due immediately
    assert sup.state(2) == RUNNING and len(spawned) == 2
    assert sup.restarts[2] == 0 and sup._budget_used[2] == 0
    # slot ids are stable: shrink leaves a tombstone, never a hole
    sup.shrink(1)
    sup.poll()
    assert sup.state(1) in (DRAINING, STOPPED)
    assert sup.grow(SPEC, worker=FakeWorker(SPEC)) == 3


def test_shrink_out_of_range_raises():
    sup, clock, spawned = make_sup()
    with pytest.raises(ValueError, match="shrink targets slot 5"):
        sup.shrink(5)


def test_fleet_targets_reports_draining_and_kv():
    """Federated labels survive a scale-down: a DRAINING slot is still
    a target (its last heartbeats matter) but flagged so the verdict
    and tools/check_fleet.py can skip it; kv summaries ride along."""
    h, sup, clock, spawned = make_handle(
        lambda op, fields: _poll_reply() if op == "poll" else {}
    )
    h.step()
    t = fleet_targets(sup, [h])
    assert t[0]["draining"] is False
    assert "kv" in t[0]
    sup.shrink(0)
    t = fleet_targets(sup, [h])
    assert t[0]["draining"] is True


# ------------------------------------ the supervisor held to the reference
class _TwinWorker:
    """A fake worker for the lockstep runs: `index` is its order of
    birth in its run (pids differ between runs); SIGTERM fells it unless
    it drains, SIGKILL always does."""

    def __init__(self, index, drains):
        self.index = index
        self.pid = 50_000 + index
        self.drains = drains
        self.rc = None
        self.signals = []
        self.reaped = False
        self.client = FakeClient()

    def poll(self):
        return self.rc

    def kill_signal(self, sig):
        self.signals.append(sig)
        if sig == "SIGKILL" or (sig == "SIGTERM" and not self.drains):
            self.rc = -9

    def die(self, rc):
        self.rc = rc

    def reap(self, timeout_s=5.0):
        self.reaped = True


class _Twin:
    """One package's Supervisor under a scripted spawn and a fake clock."""

    def __init__(self, sup_mod, spec, clock, cfg_kw, n, drains):
        self.born = []
        self.spawn_calls = 0
        self.fail_next = False
        self.drains = drains
        self.spec = spec
        self.clock = clock
        self.sup = sup_mod.Supervisor(
            [spec] * n, sup_mod.SupervisorConfig(**cfg_kw),
            spawn_fn=self._spawn, spawn_in_thread=False, clock=clock)
        self.sup.start()

    def _new(self):
        w = _TwinWorker(len(self.born), self.drains)
        self.born.append(w)
        return w

    def _spawn(self, spec):
        self.spawn_calls += 1
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("no ready line")
        return self._new()

    def act(self, action):
        kind, arg = action
        sup = self.sup
        try:
            if kind == "die":
                w = sup.workers[arg[0]] if arg[0] < len(sup.workers) else None
                if w is not None:
                    w.die(arg[1])
            elif kind == "advance":
                self.clock.advance(arg)
            elif kind == "poll":
                sup.poll()
            elif kind == "shrink":
                return sup.shrink(arg)
            elif kind == "grow_cold":
                return sup.grow(self.spec)
            elif kind == "grow_warm":
                return sup.grow(self.spec, worker=self._new())
            elif kind == "revive":
                if arg < len(sup.states):
                    sup.revive(arg)
            elif kind == "kill":
                sup.kill(arg[0], arg[1])
            elif kind == "fail_next":
                self.fail_next = True
            elif kind == "stop":
                sup.stop()
        except ValueError as e:
            return f"ValueError: {e}"
        return None

    def snapshot(self, result):
        sup = self.sup
        return {
            "result": result,
            "states": list(sup.states),
            "restarts": list(sup.restarts),
            "budget_used": list(sup._budget_used),
            "restart_times": [list(t) for t in sup._restart_times],
            "next_at": list(sup._next_at),
            "drain_deadline": list(sup._drain_deadline),
            "seated": [None if w is None else w.index for w in sup.workers],
            "active_slots": sup.active_slots(),
            "spawn_calls": self.spawn_calls,
            "born": [(w.index, w.rc, tuple(w.signals), w.reaped,
                      tuple(op for op, _ in w.client.calls))
                     for w in self.born],
        }


def _script(seed):
    """A seeded scenario: the fleet's size and policy, then 80 actions
    (deaths, clock steps, polls, shrinks, grows, revives, signals and
    failed spawns) and a stop."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 4))
    cfg_kw = {
        "restart_base_s": float(rng.choice([0.2, 1.0])),
        "restart_factor": 2.0,
        "restart_max_s": 10.0,
        "restart_jitter": float(rng.choice([0.0, 0.25])),
        "restart_budget": int(rng.randint(1, 4)),
        "restart_window_s": [None, 30.0][int(rng.randint(2))],
        "shrink_kill_after_s": 5.0,
        "seed": int(rng.randint(100)),
    }
    drains = bool(rng.randint(2))
    kinds = ["die", "die", "advance", "advance", "poll", "poll", "poll",
             "shrink", "grow_cold", "grow_warm", "revive", "kill",
             "fail_next"]
    actions = []
    for _ in range(80):
        kind = kinds[int(rng.randint(len(kinds)))]
        slot = int(rng.randint(n + 2))
        if kind == "die":
            arg = (slot, int(rng.choice([1, -9, 0])))
        elif kind == "advance":
            arg = float(rng.choice([0.05, 0.3, 1.0, 5.1, 40.0, 400.0]))
        elif kind == "kill":
            arg = (slot, str(rng.choice(["SIGKILL", "SIGTERM"])))
        elif kind in ("shrink", "revive"):
            arg = slot
        else:
            arg = None
        actions.append((kind, arg))
    actions.append(("stop", None))
    return n, cfg_kw, drains, actions


@pytest.mark.parametrize("seed", range(16))
def test_supervisor_state_machine_steps_with_the_reference(seed):
    """The port's Supervisor and the reference's, each under the same
    scripted fake spawn and its own fake clock, go through the same
    states, restarts, budget, backoff deadlines (`_next_at`, jitter
    included), drain deadlines, spawns, signals and reaps after every
    action of a seeded scenario."""
    import ddp_practice_tpu.serve.scheduler as jsched
    import ddp_practice_tpu.serve.supervisor as jsup
    import ddp_practice_tpu.serve.worker as jworker
    import ddp_practice_tpu_torch.serve.supervisor as psup

    n, cfg_kw, drains, actions = _script(seed)
    ref = _Twin(jsup, jworker.WorkerSpec(), jsched.FakeClock(step_s=0.0),
                cfg_kw, n, drains)
    port = _Twin(psup, WorkerSpec(device="cpu"), FakeClock(step_s=0.0),
                 cfg_kw, n, drains)
    assert port.snapshot(None) == ref.snapshot(None)
    seen = set()
    for i, action in enumerate(actions):
        want = ref.snapshot(ref.act(action))
        got = port.snapshot(port.act(action))
        assert got == want, (i, action)
        seen |= set(got["states"])
    # the scenario went through the restart path, and stop() ended it
    assert {RUNNING, BACKOFF} <= seen and sum(port.sup.restarts) >= 1
    assert set(port.sup.states) == {STOPPED}


# ------------------------------------------------------- the worker spec
def test_worker_spec_defaults_to_the_card_and_round_trips():
    spec = WorkerSpec(model={"vocab_size": 64}, engine={"max_slots": 2})
    assert spec.device == "cuda"
    again = WorkerSpec.from_json(spec.to_json())
    assert again == spec


def test_worker_on_cuda_without_a_card_raises_instead_of_falling_back():
    """`device` "cuda" on a machine without a card raises in the model
    build, before any READY line, and never serves on the CPU."""
    import torch

    from ddp_practice_tpu_torch.serve.worker import build_model

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model({"vocab_size": 64, "hidden_dim": 64, "depth": 1,
                     "num_heads": 1, "mlp_dim": 64, "max_len": 32},
                    "cuda")


def _bench_model(seed=0):
    from ddp_practice_tpu_torch.serve.bench import _build_model

    return _build_model(vocab=64, max_len=64, hidden=64, depth=2, heads=4,
                        mlp=128, device="cpu", seed=seed)


def test_bench_worker_spec_carries_the_models_weights_digest():
    """The bench's WorkerSpec carries its model's digest, and a worker's
    seed-0 rebuild of the spec's model dict gives that digest."""
    from ddp_practice_tpu_torch.serve.bench import _worker_spec
    from ddp_practice_tpu_torch.serve.worker import (
        build_model,
        weights_digest,
    )

    spec = _worker_spec(_bench_model(), ENGINE_KW)
    assert spec.device == "cpu"
    assert spec.weights_digest == weights_digest(
        build_model(spec.model, "cpu"))
    assert WorkerSpec.from_json(spec.to_json()) == spec


@pytest.mark.parametrize("how", ["another seed", "trained"])
def test_worker_refuses_weights_it_cannot_rebuild(how):
    """A caller whose model is not the seed-0 draw of its widths (another
    seed, or weights moved by training) gets a worker that raises at
    boot, before any port is bound, instead of a fleet that serves other
    weights than the in-process arms it is compared with."""
    import torch

    from ddp_practice_tpu_torch.serve.bench import _worker_spec
    from ddp_practice_tpu_torch.serve.worker import WorkerServer

    if how == "another seed":
        model = _bench_model(seed=1)
    else:
        model = _bench_model()
        with torch.no_grad():
            model.tok_embed.weight.add_(1e-3)
    with pytest.raises(RuntimeError, match="weights_digest"):
        WorkerServer(_worker_spec(model, ENGINE_KW))


def test_fleet_trace_plane_and_federation_name_a6d():
    from ddp_practice_tpu_torch.serve.supervisor import (
        make_federated_server,
    )

    with pytest.raises(NotImplementedError, match="A6d"):
        make_fleet_router(WorkerSpec(trace=True, device="cpu"), 1,
                          spawn_fn=lambda spec: None)
    with pytest.raises(NotImplementedError, match="A6d"):
        make_federated_server(None, [])


# ------------------------------------------------- a real worker process
MODEL_KW = {"vocab_size": 64, "max_len": 64, "hidden_dim": 64,
            "depth": 2, "num_heads": 4, "mlp_dim": 128, "pos_emb": "rope"}
ENGINE_KW = {"max_slots": 2, "max_len": 64, "prompt_buckets": [8, 16],
             "temperature": 0.0, "decode_burst": 4, "eos_id": None}
CPU_SPEC = WorkerSpec(model=MODEL_KW, engine=ENGINE_KW, max_queue=64,
                      device="cpu")
SUP_CFG = SupervisorConfig(restart_base_s=0.25, restart_budget=5,
                           ready_timeout_s=120.0)


def _trace(n=6, seed=3, max_new=(5, 9)):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"rid": i,
             "prompt": rng.integers(1, 64, int(rng.integers(3, 9))).tolist(),
             "max_new_tokens": int(rng.integers(*max_new))}
            for i in range(n)]


def _expected_tokens(trace, model_kw=MODEL_KW):
    """The greedy oracle: the worker's model served by one in-process
    scheduler (greedy tokens do not depend on the batch)."""
    from ddp_practice_tpu_torch.serve.engine import EngineConfig, SlotEngine
    from ddp_practice_tpu_torch.serve.scheduler import Scheduler
    from ddp_practice_tpu_torch.serve.worker import build_model

    eng_kw = dict(ENGINE_KW, prompt_buckets=tuple(ENGINE_KW[
        "prompt_buckets"]))
    sched = Scheduler(SlotEngine(build_model(model_kw, "cpu"),
                                 EngineConfig(**eng_kw)), max_queue=64)
    for t in _trace_requests(trace):
        sched.submit(t)
    comps = sched.run_until_idle()
    assert all(c.status == "length" for c in comps)
    return {c.rid: list(c.tokens) for c in comps}


def _trace_requests(trace):
    return [Request(**t) for t in trace]


@pytest.mark.net
def test_one_worker_process_matches_the_in_process_scheduler():
    """One worker started as the supervisor starts it (a fresh
    `python -m ddp_practice_tpu_torch.serve.worker`, one torch thread on
    the CPU):
    greedy tokens over the RPC seam equal one in-process scheduler's,
    every request terminal, and the worker's published stats carry its
    decode steps and kernel launches (none on the CPU)."""
    from ddp_practice_tpu_torch.serve.worker import (
        build_model,
        weights_digest,
    )

    trace = _trace()
    expected = _expected_tokens(trace)
    router, sup, handles = make_fleet_router(CPU_SPEC, 1,
                                             sup_config=SUP_CFG)
    try:
        pid = sup.worker(0).pid
        assert pid in live_worker_pids()
        for r in _trace_requests(trace):
            router.submit(r)
        comps = router.run_until_idle()
        stats = sup.worker(0).client.call("ping")["stats"]
    finally:
        sup.stop()
    assert {c.rid: c.status for c in comps} == {t["rid"]: "length"
                                                for t in trace}
    assert {c.rid: c.tokens for c in comps} == expected
    assert stats["decode_steps"] > 0
    assert not any(stats["kernel_launches"].values())
    assert stats["weights_digest"] == weights_digest(
        build_model(MODEL_KW, "cpu"))
    assert pid not in live_worker_pids()


# --------------------------------------------- real signals (slow)
@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.net
def test_sigkill_mid_decode_failover_restart_and_readmission():
    """SIGKILL one of two workers mid-decode: zero lost requests, the
    survivor's output greedy token-identical to the fault-free oracle,
    and the killed worker respawned by the supervisor and readmitted to
    dispatch only after a passing health probe."""
    # a deeper model and long budgets, so that worker 0 is still
    # decoding when the signal lands (a victim that finished first
    # migrates nothing)
    model_kw = dict(MODEL_KW, hidden_dim=256, depth=4, mlp_dim=1024)
    trace = _trace(n=6, seed=5, max_new=(32, 41))
    expected = _expected_tokens(trace, model_kw)
    spec = WorkerSpec(model=model_kw, engine=ENGINE_KW, max_queue=64,
                      device="cpu")
    router, sup, handles = make_fleet_router(spec, 2, sup_config=SUP_CFG)
    try:
        for r in _trace_requests(trace):
            router.submit(r)
        deadline = time.monotonic() + 60
        while not any(st["tokens"]
                      for st in handles[0].outstanding.values()):
            assert time.monotonic() < deadline, "never saw decode"
            router.step()
        # freeze worker 0 where it was seen mid-decode, so the requests
        # it still owes cannot all finish before the kill lands
        sup.kill(0, "SIGSTOP")
        victims = sorted(handles[0].outstanding)
        pid0 = sup.worker(0).pid
        sup.kill(0, "SIGKILL")
        comps = router.run_until_idle()
        by_rid = {c.rid: c for c in comps}
        assert set(by_rid) == {t["rid"] for t in trace}
        assert all(c.status == "length" for c in by_rid.values())
        for rid, want in expected.items():
            assert by_rid[rid].tokens == want, f"rid {rid} diverged"
        assert [rid for rid in victims
                if by_rid[rid].flight["failovers"] >= 1]
        deadline = time.monotonic() + 120
        while router.states()[0] != "healthy":
            assert time.monotonic() < deadline, (sup.state(0),
                                                 router.states())
            router.step()
            time.sleep(0.05)
        assert sup.restarts[0] >= 1 and sup.state(0) == RUNNING
        assert sup.worker(0).pid != pid0
        router.submit(Request(rid=999, prompt=[1, 2, 3], max_new_tokens=4))
        assert 999 in handles[0].outstanding
        tail = router.run_until_idle()
        assert {c.rid: c.status for c in tail}[999] == "length"
    finally:
        sup.stop()


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.net
def test_sigstop_stale_heartbeat_put_down_and_failover():
    """SIGSTOP leaves the process alive but silent: the handle's
    heartbeat budget SIGKILLs it for real, fails its work over, and the
    supervisor restarts it, every request still terminal."""
    trace = _trace(n=4, seed=9)
    router, sup, handles = make_fleet_router(
        CPU_SPEC, 2, sup_config=SUP_CFG, heartbeat_timeout_s=1.0)
    try:
        for r in _trace_requests(trace):
            router.submit(r)
        deadline = time.monotonic() + 60
        while not handles[0].outstanding:
            assert time.monotonic() < deadline
            router.step()
        pid0 = sup.worker(0).pid
        sup.kill(0, "SIGSTOP")
        comps = router.run_until_idle()
        by_rid = {c.rid: c for c in comps}
        assert set(by_rid) == {t["rid"] for t in trace}
        assert all(c.status == "length" for c in by_rid.values())
        deadline = time.monotonic() + 30
        while sup.workers[0] is not None \
                and getattr(sup.workers[0], "pid", None) == pid0:
            assert time.monotonic() < deadline
            sup.poll()
            time.sleep(0.05)
        assert pid0 not in live_worker_pids()
    finally:
        sup.stop()
    assert live_worker_pids() == []
