"""The port's front door (serve/sse.py, admission.py, frontdoor.py)
against the reference's.

- the SSE codec: the same events encode to the same bytes, and the same
  bytes, split the same ways, parse to the same events;
- admission: one scripted sequence of acquires, releases and clock steps
  gets the same admit and refuse decisions from both controllers;
- the door's refusal paths and /healthz on a real socket over a stub
  router (no engine: the door turns these away before it needs one);
- a port Frontdoor over a port router, weights converted from the
  reference bench's recipe (a packable head_dim 64), gives the same
  greedy SSE token frames over 127.0.0.1 sockets as the reference's
  Frontdoor over its JAX router, then drains.
"""

import http.client
import threading
import time

import numpy as np
import pytest

import ddp_practice_tpu.serve.admission as jadm
import ddp_practice_tpu.serve.sse as jsse
from ddp_practice_tpu.serve.router import StreamEvent as JStreamEvent
from ddp_practice_tpu_torch.serve import (
    AdmissionController,
    EngineConfig,
    FakeClock,
    Frontdoor,
    FrontdoorConfig,
    FrontdoorMetrics,
    Request,
    TenantPolicy,
    make_router,
    sse_request,
)
from ddp_practice_tpu_torch.serve.fairshare import VirtualTokenCounter
from ddp_practice_tpu_torch.serve.router import StreamEvent
from ddp_practice_tpu_torch.serve.sse import KINDS, SSEParser, encode_event
from ddp_practice_tpu_torch.serve.sse import encode_stream_event
from tests._torch_port import build_pair

EVENTS = [
    ("tokens", 0, {"start": 0, "tokens": [3, 1]}),
    ("resumed", 1, {"start": 2, "tokens": [], "attrs": {"from": 1}}),
    ("tokens", 2, {"start": 2, "tokens": [7, 7, 2], "trace_id": "r9"}),
    ("end", 3, {"start": 5, "tokens": [], "status": "eos"}),
    ("error", 0, {"error": "draining", "reason": None}),
]


# --------------------------------------------------------- the SSE codec
@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_encode_event_bytes_match_the_reference(i):
    kind, seq, data = EVENTS[i]
    assert kind in KINDS
    assert encode_event(kind, seq, data) == jsse.encode_event(kind, seq,
                                                              data)


@pytest.mark.parametrize("kw", [
    dict(kind="tokens", seq=0, start=0, tokens=[5, 9], trace_id=None),
    dict(kind="resumed", seq=1, start=2, tokens=[], trace_id=None,
         attrs={"replica": 1}),
    dict(kind="end", seq=4, start=7, tokens=[3], status="length",
         trace_id="r3"),
])
def test_encode_stream_event_bytes_match_the_reference(kw):
    ev = StreamEvent(t=1.5, **kw)
    jev = JStreamEvent(t=1.5, **kw)
    assert encode_stream_event(ev) == jsse.encode_stream_event(jev)


@pytest.mark.parametrize("step", [1, 3, 7, 64, 10_000])
def test_sse_parser_matches_the_reference_over_any_split(step):
    wire = b"".join(encode_event(*ev) for ev in EVENTS)
    wire += (b": keep-alive\r\n\r\nid: 9\r\nevent: tokens\r\nretry: 5\r\n"
             b"data: {\"tokens\":[7]}\r\n\r\nevent: end\ndata: not json\n\n")
    ours, theirs = SSEParser(), jsse.SSEParser()
    got, want = [], []
    for i in range(0, len(wire), step):
        got.append(ours.feed(wire[i:i + step]))
        want.append(theirs.feed(wire[i:i + step]))
    assert got == want
    flat = [e for batch in got for e in batch]
    assert [(e["event"], e["id"], e["data"]) for e in flat[:5]] == [
        (k, i, d) for k, i, d in EVENTS]
    assert flat[-1]["data"] == "not json" and flat[-2]["id"] == 9


# ------------------------------------------------------------- admission
def _script(adm, clock):
    """One scripted run of the door's admission calls; every decision
    and counter it produces, in order."""
    out = []
    for _ in range(3):
        out.append(adm.try_acquire("t"))
    clock.advance(0.5)
    out.append(adm.try_acquire("t"))
    out.append(adm.try_acquire("t"))
    out.append(adm.try_acquire("capped"))
    out.append(adm.try_acquire("capped"))
    adm.release("capped")
    clock.advance(1.0)
    out.append(adm.try_acquire("capped"))
    out.append(adm.try_acquire("someone-else"))
    for _ in range(5):
        clock.advance(0.13)
        out.append(adm.try_acquire("t"))
        adm.release("t")
    out.append((adm.inflight("t"), adm.inflight("capped"),
                dict(adm.refused)))
    return out


def test_admission_decisions_match_the_reference():
    from ddp_practice_tpu.serve.scheduler import FakeClock as JFakeClock

    policies = {"t": dict(rate_rps=2.0, burst=2),
                "capped": dict(rate_rps=100.0, burst=1, max_concurrent=1)}
    clock, jclock = FakeClock(), JFakeClock()
    ours = AdmissionController(
        {k: TenantPolicy(**v) for k, v in policies.items()}, clock=clock)
    theirs = jadm.AdmissionController(
        {k: jadm.TenantPolicy(**v) for k, v in policies.items()},
        clock=jclock)
    got = _script(ours, clock)
    assert got == _script(theirs, jclock)
    assert got[2] == (False, "rate") and got[6] == (False, "concurrency")


def test_admission_fairness_gate_matches_the_reference():
    from ddp_practice_tpu.serve.fairshare import (
        VirtualTokenCounter as JVTC,
    )

    def run(vtc_cls, adm_cls):
        vtc = vtc_cls()
        vtc.charge("bulk", decode=100)
        vtc.touch("acme")
        adm = adm_cls(vtc=vtc, fair_max_inflight=2)
        out = [adm.try_acquire(t) for t in ("bulk", "acme", "bulk",
                                            "acme")]
        adm.release("bulk")
        out.append(adm.try_acquire("bulk"))
        return out, dict(adm.refused)

    got = run(VirtualTokenCounter, AdmissionController)
    assert got == run(JVTC, jadm.AdmissionController)
    assert got[0][2] == (False, "fairness")


# ------------------------------------------- refusal paths, stub router
class _StubRouter:
    """The slice of Router the door touches before submit: enough for
    every refusal path and /healthz, with no engine behind it."""

    def __init__(self):
        self.tracked = {}
        self.streams = {}
        self.idle = True
        self._pending = 0
        self.clock = FakeClock()

    def step(self):
        pass

    def states(self):
        return [{"replica": 0, "state": "up"}]


@pytest.fixture
def stub_door():
    adm = AdmissionController({"capped": TenantPolicy(max_concurrent=1)})
    fd = Frontdoor(
        _StubRouter(),
        config=FrontdoorConfig(auth_token="sekrit", max_prompt_len=64),
        admission=adm, metrics=FrontdoorMetrics(),
    )
    fd.start()
    yield fd, adm
    fd.close()


@pytest.mark.net
def test_door_refusals_are_typed_json(stub_door):
    fd, adm = stub_door
    auth = {"Authorization": "Bearer sekrit"}
    status, ev = sse_request("127.0.0.1", fd.port, {"prompt": [1, 2]})
    assert status == 401
    for body, needle in (
        ({"prompt": []}, "prompt"),
        ({"prompt": [1, -2]}, "prompt"),
        ({"prompt": [1] * 65}, "too long"),
        ({"prompt": [1, 2], "max_new_tokens": 0}, "max_new_tokens"),
    ):
        status, ev = sse_request("127.0.0.1", fd.port, body, headers=auth)
        assert status == 400, (body, status, ev)
        assert needle in ev[0]["data"]["error"], (body, ev)
    ok, _ = adm.try_acquire("capped")
    assert ok
    status, ev = sse_request(
        "127.0.0.1", fd.port, {"prompt": [1], "tenant": "capped"},
        headers=auth)
    assert status == 429 and ev[0]["data"]["reason"] == "concurrency"
    adm.release("capped")


@pytest.mark.net
def test_door_fairness_refusal_is_typed_429():
    vtc = VirtualTokenCounter()
    vtc.charge("bulk", decode=100)
    vtc.touch("acme")
    adm = AdmissionController(vtc=vtc, fair_max_inflight=2)
    fd = Frontdoor(_StubRouter(), config=FrontdoorConfig(),
                   admission=adm, metrics=FrontdoorMetrics())
    fd.start()
    try:
        for t in ("bulk", "acme"):   # reach the pressure threshold
            assert adm.try_acquire(t) == (True, None)
        status, ev = sse_request(
            "127.0.0.1", fd.port, {"prompt": [1], "tenant": "bulk"})
        assert status == 429 and ev[0]["data"]["reason"] == "fairness"
        status, ev = sse_request(
            "127.0.0.1", fd.port, {"prompt": [1], "tenant": "acme"})
        assert status != 429
        assert adm.refused["fairness"] == 1
    finally:
        fd.close()


@pytest.mark.net
def test_healthz_and_drain_refusal(stub_door):
    import json

    fd, _ = stub_door
    conn = http.client.HTTPConnection("127.0.0.1", fd.port, timeout=10)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    hz = json.loads(resp.read())
    assert resp.status == 200 and hz["status"] == "ok"
    assert hz["inflight_streams"] == 0 and hz["replicas"]
    conn = http.client.HTTPConnection("127.0.0.1", fd.port, timeout=10)
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404
    fd.begin_drain()
    status, ev = sse_request(
        "127.0.0.1", fd.port, {"prompt": [1, 2]},
        headers={"Authorization": "Bearer sekrit"})
    assert status == 503 and ev[0]["data"]["error"] == "draining"
    assert fd.drain(timeout_s=5)


# ------------------------------------------- the wire, both packages
def _frames(port, prompts, max_new):
    """Each prompt POSTed in turn; its (id, event, data) frames."""
    out = []
    for p in prompts:
        status, events = sse_request(
            "127.0.0.1", port,
            {"prompt": p, "max_new_tokens": max_new, "seed": 0})
        assert status == 200, (status, events)
        out.append([(e["id"], e["event"], e["data"]) for e in events])
    return out


@pytest.mark.net
def test_greedy_sse_frames_match_the_reference_front_door():
    """The reference bench's recipe (serve/bench.py _build_model: a RoPE
    lm_tiny, here at head_dim 64 so the JAX decode reaches its kernel's
    interpret path), its weights converted into the port: the port door
    over the port router and the reference door over its JAX router send
    the same greedy frames, ids contiguous from 0 with one terminal."""
    import ddp_practice_tpu.serve as jserve

    jm, params, tm = build_pair(seed=3, max_len=128, pos_emb="rope")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 64, int(rng.integers(4, 14))).tolist()
               for _ in range(3)]
    cfg = dict(max_slots=4, prompt_buckets=(16,), max_len=64,
               decode_burst=4)
    router = make_router(tm, 1, EngineConfig(**cfg))
    router.warmup()
    fd = Frontdoor(router, config=FrontdoorConfig(max_buffered_events=64))
    fd.start()
    try:
        got = _frames(fd.port, prompts, 6)
    finally:
        fd.close()
    jrouter = jserve.make_router(jm, params, 1, jserve.EngineConfig(**cfg))
    jrouter.warmup()
    jfd = jserve.Frontdoor(jrouter, config=jserve.FrontdoorConfig(
        max_buffered_events=64))
    jfd.start()
    try:
        want = _frames(jfd.port, prompts, 6)
    finally:
        jfd.close()
    assert got == want
    for frames in got:
        assert [i for i, _, _ in frames] == list(range(len(frames)))
        kinds = [k for _, k, _ in frames]
        assert kinds.count("end") == 1 and kinds[-1] == "end"
        assert len([t for _, k, d in frames for t in d["tokens"]]) == 6


@pytest.mark.net
def test_drain_finishes_in_flight_and_refuses_new():
    """begin_drain: a stream already started runs to its end while a new
    request gets a typed 503, and drain() returns once it has."""
    from ddp_practice_tpu_torch.models import create_model

    model = create_model("lm_tiny", device="cpu", vocab_size=64,
                         max_len=128, hidden_dim=64, depth=2, num_heads=4,
                         mlp_dim=128, pos_emb="rope")
    router = make_router(model, 1, EngineConfig(
        max_slots=2, prompt_buckets=(16,), max_len=96, decode_burst=4))
    router.warmup()
    fd = Frontdoor(router, config=FrontdoorConfig(max_buffered_events=64))
    fd.start()
    try:
        results = []

        def consume():
            results.append(sse_request(
                "127.0.0.1", fd.port,
                {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 40,
                 "seed": 0}, read_delay_s=0.02))

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.2)
        fd.begin_drain()
        status, ev = sse_request("127.0.0.1", fd.port, {"prompt": [1, 2]})
        assert status == 503 and ev[0]["data"]["error"] == "draining"
        t.join()
        status, events = results[0]
        assert status == 200 and events[-1]["event"] == "end"
        assert events[-1]["data"]["status"] == "length"
        assert fd.drain(timeout_s=15)
    finally:
        fd.close()


# ------------------------------------------------- the driver's pump loop
class _CountingRouter:
    """A router stand-in that counts the driver's loop passes (one
    `idle` read each) and steps; `busy` flips it between a router with
    work and an idle one. `handles` with `stream_fileno` make it a fleet
    whose push-stream fds are `fds`."""

    def __init__(self, busy, fds=()):
        self.busy = busy
        self.passes = 0
        self.steps = 0
        self.tracked = {}
        self.streams = {}
        self.handles = [_FdHandle(fd) for fd in fds]

    @property
    def idle(self):
        self.passes += 1
        return not self.busy

    def step(self):
        self.steps += 1


class _FdHandle:
    def __init__(self, fd):
        self.fd = fd

    def stream_fileno(self):
        return self.fd


def _pump(router, seconds, **kw):
    from ddp_practice_tpu_torch.serve.frontdoor import RouterDriver

    driver = RouterDriver(router, **kw)
    driver.start()
    time.sleep(seconds)
    driver.stop()
    return router


def test_idle_driver_sleeps_between_passes():
    """An idle in-process router has no stream fds: the driver waits
    `idle_sleep_s` between passes instead of spinning on the lock."""
    r = _pump(_CountingRouter(busy=False), 0.3, idle_sleep_s=0.02)
    assert r.steps == 0
    # 0.3 s / 20 ms = 15 waits; a spinning loop makes thousands
    assert 1 <= r.passes <= 40, r.passes


def test_busy_in_process_driver_never_sleeps():
    """A busy in-process router decodes inside step(): the driver steps
    it back to back, never waiting `idle_sleep_s` after a step."""
    r = _pump(_CountingRouter(busy=True), 0.3, idle_sleep_s=0.05)
    # a driver that slept 50 ms after each step would make at most 6
    assert r.steps >= 100, r.steps


@pytest.mark.net
def test_busy_fleet_driver_parks_on_its_streams():
    """A busy fleet router's decode runs in other processes: between
    steps the driver parks on the push-stream fds (here a socket pair
    with nothing to read) for 2 ms a pass, so it neither spins nor waits
    the idle interval."""
    import socket

    a, b = socket.socketpair()
    try:
        r = _pump(_CountingRouter(busy=True, fds=[a.fileno()]), 0.3,
                  idle_sleep_s=0.05)
    finally:
        a.close()
        b.close()
    # 0.3 s / 2 ms = 150 parks; 50 ms sleeps would allow 6
    assert 20 <= r.steps <= 200, r.steps


class _SlowRouter(_CountingRouter):
    """A busy router whose every step takes `step_s` under the driver's
    lock, and whose submit raises for a prompt of [13]."""

    def __init__(self, step_s):
        super().__init__(busy=True)
        self.step_s = step_s
        self.submitted = []

    def step(self):
        super().step()
        time.sleep(self.step_s)

    def submit(self, req):
        if list(req.prompt) == [13]:
            raise ValueError("unlucky prompt")
        self.submitted.append(req.rid)


class _DirectLoop:
    """Stands in for a connection's asyncio loop: runs the callback."""

    def call_soon_threadsafe(self, fn):
        fn()


def test_handlers_never_wait_for_a_step():
    """A connection's submit and drain return while the driver is inside
    a step (they take only the subscribers' lock), and the driver submits
    the queued request on its next pass. A submit the router refuses by
    raising ends its own stream with a typed error terminal and leaves
    the pump running."""
    from ddp_practice_tpu_torch.serve.frontdoor import RouterDriver

    router = _SlowRouter(step_s=0.3)
    driver = RouterDriver(router)
    driver.start()
    try:
        time.sleep(0.05)                      # the first step is running
        t0 = time.monotonic()
        rid, sub = driver.submit({"prompt": [1, 2]}, None, _DirectLoop(),
                                 threading.Event())
        assert driver.take(sub) == []
        assert time.monotonic() - t0 < 0.1    # a step lasts 0.3 s
        bad, bad_sub = driver.submit({"prompt": [13]}, None, _DirectLoop(),
                                     threading.Event())
        deadline = time.monotonic() + 5.0
        while rid not in router.submitted and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rid in router.submitted
        while not bad_sub.wake.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert driver.take(bad_sub) == [
            ("end", {"status": "error",
                     "error": "ValueError: unlucky prompt"})]
        steps = router.steps
        time.sleep(0.7)
        assert router.steps > steps           # the pump still runs
    finally:
        driver.stop()
