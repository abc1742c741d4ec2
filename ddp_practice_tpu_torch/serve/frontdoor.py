"""The serving front door: HTTP/SSE over `Router.stream`.

(Host-pure Python: a copy of ddp_practice_tpu/serve/frontdoor.py with its
imports pointed at the port; the port imports nothing of the
reference package. One divergence, in `RouterDriver`: the reference's
connection handlers take the router's lock, which the driver holds
across each step, to submit and to drain their buffers, and its loop has
its two waits swapped: a busy in-process router sleeps after every step,
which is what lets the handlers in, and an idle one spins on the lock.
Here the handlers hand submits over through an intake queue and drain
under a lock of the subscribers' own, a busy loop parks only on a
fleet's push streams, and an idle one waits for the next submit.)

Everything below this module terminates at a Python API — `Router.submit`
plus a `TokenStream` readable only in-process. This module is the wire
surface the ROADMAP's "heavy traffic" story needs: a hand-rolled
asyncio HTTP/1.1 server speaking

    POST /v1/generate        -> 200 text/event-stream (chunked)
    GET  /healthz            -> 200 application/json

where the SSE frames ARE the router's typed StreamEvents (serve/sse.py
— ``tokens`` / ``resumed`` / ``end``, contiguous ids, exactly one
terminal), so the exactly-once contract the in-process consumer gets
is the contract the socket consumer gets, auditable by the same tool
(tools/check_stream.py --sse).

Architecture — one pump, many readers:

- `RouterDriver` owns the router on a dedicated thread: it holds THE
  lock, submits what the handlers queued, calls `router.step()`
  whenever work is pending, and fans each stream's new events out to
  per-connection subscribers. The router and everything under it
  (scheduler, engine, CUDA launches) stay single-threaded — exactly the
  discipline the rest of the repo assumes — and the asyncio side never
  touches router state directly, nor waits for a step.
- Each connection gets a bounded event buffer. The asyncio writer
  applies real TCP backpressure (`await drain()`); when a consumer is
  slower than its stream for long enough to fill the buffer, the
  subscription is SHED: buffered frames are dropped, the wire gets one
  synthetic terminal (``end`` / status ``slow_consumer``), and the
  request itself keeps running to completion on the engine. A slow
  reader therefore never pins KV blocks or stalls the decode loop —
  the engine never waits on any consumer, and the bound caps what a
  dead-slow socket can hold in router-side memory.
- Intake order at the door: parse -> auth (401) -> validation (400) ->
  drain check (503) -> per-tenant admission (429, serve/admission.py)
  -> `router.submit`. Anything past submit is SSE: even a brown-out
  shed at the router door rides out as a 200 stream whose only frame
  is the typed ``end`` — never silence, never a dropped connection.
- Graceful drain mirrors the worker's SIGTERM path (serve/worker.py):
  `begin_drain()` flips new generates to 503 while in-flight streams
  finish; `install_sigterm()` hangs that on the signal, and `drain()`
  blocks until the floor is clear (bounded by a timeout).

The client half (`sse_request`) lives here too — a blocking
socket-level SSE consumer the bench and tests use, sharing the codec
with the server so the wire format is pinned by construction on both
ends.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import select
import signal
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ddp_practice_tpu_torch.serve.admission import AdmissionController
from ddp_practice_tpu_torch.serve.scheduler import Request
from ddp_practice_tpu_torch.serve.sse import SSEParser, encode_event
from ddp_practice_tpu_torch.utils.trace import ROUTER_PID


@dataclasses.dataclass(frozen=True)
class FrontdoorConfig:
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral (the test default)
    # request validation bounds (400 past either)
    max_prompt_len: int = 4096
    max_new_tokens: int = 1024
    max_body_bytes: int = 1 << 20
    # static bearer-token auth when set (the `auth` hook overrides)
    auth_token: Optional[str] = None
    # consumer backpressure: per-connection buffered SSE events before
    # the stream is shed with a synthetic ``end``/``slow_consumer``.
    # The event bound only bites while the writer is parked on TCP
    # backpressure, so the two buffer knobs below size how much a slow
    # reader can absorb before `drain()` blocks: the asyncio transport
    # high-watermark and the kernel send buffer (SO_SNDBUF, inherited
    # by accepted connections; None = platform default). Tests shrink
    # all three to provoke the shed path deterministically.
    max_buffered_events: int = 256
    write_buffer_bytes: int = 65536
    sndbuf: Optional[int] = None
    # driver pacing while the fleet is idle (busy loops never sleep)
    idle_sleep_s: float = 0.002
    header_timeout_s: float = 10.0


def wait_for_streams(router, timeout_s: float) -> bool:
    """Park on the push-stream fds of `router`'s fleet handles until a
    frame lands or `timeout_s` passes. Returns False at once, without
    waiting, when there is no fd to wait on: an in-process router, or a
    fleet whose streams are all down."""
    fds = []
    for h in getattr(router, "handles", ()):
        fn = getattr(h, "stream_fileno", None)
        fd = fn() if fn is not None else None
        if fd is not None:
            fds.append(fd)
    if not fds:
        return False
    try:
        select.select(fds, [], [], timeout_s)
    except (OSError, ValueError):
        pass  # a stream died mid-select: the next step resyncs
    return True


class _Subscriber:
    """One connection's slice of a TokenStream: the driver appends
    events under its `events_lock`; the asyncio handler drains under the
    same lock and blocks on the socket in between. `shed` is one-way."""

    __slots__ = ("rid", "tenant", "events", "limit", "shed", "loop",
                 "wake", "cursor")

    def __init__(self, rid: int, tenant: Optional[str], limit: int,
                 loop, wake) -> None:
        self.rid = rid
        self.tenant = tenant
        self.events: deque = deque()
        self.limit = limit
        self.shed = False
        self.loop = loop
        self.wake = wake          # asyncio.Event, set via the loop
        self.cursor = 0           # TokenStream.events consumed so far


class RouterDriver:
    """The router's single-threaded pump with a fan-out seam.

    All router access — the step loop, the submits it takes in from
    connection handlers, event fan-out, reaping — happens on the driver
    thread under `self.lock`, so the stack below keeps its
    single-threaded invariants. Connection handlers never wait for a
    step: they hand submits over through an intake queue and drain their
    own buffers under `events_lock`, which guards only the subscribers
    and is never held across `router.step()`."""

    def __init__(self, router, *, idle_sleep_s: float = 0.002,
                 max_buffered_events: int = 256) -> None:
        self.router = router
        self.lock = threading.RLock()
        self.events_lock = threading.Lock()
        self.idle_sleep_s = idle_sleep_s
        self.max_buffered_events = max_buffered_events
        self._subs: Dict[int, _Subscriber] = {}
        self._owned: set = set()   # rids this driver submitted
        self._intake: deque = deque()   # Requests for the driver thread
        # rids must never repeat for the router's lifetime (duplicate
        # detection keys on them) — continue past anything already
        # tracked so a driver can share a router with in-process traffic
        self._next_rid = (max(router.tracked) + 1) if router.tracked else 0
        self._stop = threading.Event()
        self._kick = threading.Event()   # a submit wakes an idle driver
        self._thread: Optional[threading.Thread] = None
        self.sheds = 0            # slow-consumer sheds (cumulative)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="frontdoor-router", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                while self._intake:
                    req = self._intake.popleft()
                    try:
                        self.router.submit(req)
                    except Exception as e:  # noqa: BLE001
                        # one bad submit ends its own stream, not the pump
                        self._end(req.rid, f"{type(e).__name__}: {e}")
                busy = not self.router.idle
                if busy:
                    self.router.step()
                self._publish_locked()
            if busy:
                # fleet router: decode runs in worker processes — park
                # on their push-stream fds instead of spinning step()
                # hot (a spinning parent preempts the workers on small
                # boxes). In-process routers decode INSIDE step(), so
                # their loop must never sleep while busy; they expose
                # no stream fds and go straight back to step().
                wait_for_streams(self.router, 0.002)
            else:
                # idle: wait for a submit instead of spinning the lock
                # and the GIL against the connection handlers
                self._kick.wait(self.idle_sleep_s)
                self._kick.clear()

    # -------------------------------------------------------------- intake
    def submit(self, fields: dict, tenant: Optional[str], loop, wake
               ) -> Tuple[int, _Subscriber]:
        """Allocate a rid, subscribe and queue the request for the
        driver thread, which submits it to the router on its next pass:
        the subscriber is in place before the router sees the rid, so it
        observes every event from seq 0, the typed ``end`` of a submit
        that finalizes at the door (shed/rejected) included."""
        with self.events_lock:
            rid = self._next_rid
            self._next_rid += 1
            sub = _Subscriber(rid, tenant, self.max_buffered_events,
                              loop, wake)
            self._subs[rid] = sub
            self._owned.add(rid)
            self._intake.append(Request(rid=rid, **fields))
        self._kick.set()
        return rid, sub

    # ------------------------------------------------------------- fan-out
    def _publish_locked(self) -> None:
        with self.events_lock:
            self._publish_events()

    def _publish_events(self) -> None:
        for rid, sub in list(self._subs.items()):
            st = self.router.streams.get(rid)
            if st is None or sub.shed:
                continue
            new = st.events[sub.cursor:]
            if not new:
                continue
            sub.cursor = len(st.events)
            if len(sub.events) + len(new) > sub.limit:
                # slow consumer: everything it hasn't read is dropped in
                # one stroke and replaced by a single typed terminal —
                # the request itself keeps decoding (the engine never
                # waits on a socket, so no KV block is pinned by this
                # reader being slow); only delivery is cut short
                sub.events.clear()
                sub.events.append(("end", {"status": "slow_consumer"}))
                sub.shed = True
                self.sheds += 1
            else:
                sub.events.extend(new)
            self._wake(sub)
        # reap: a finished, shed or disconnected reader's request keeps
        # decoding (nothing pins KV on a consumer), so its router-side
        # record can only be dropped once the stream actually closed
        for rid in list(self._owned):
            if rid in self._subs:
                continue
            st = self.router.streams.get(rid)
            tr = self.router.tracked.get(rid)
            if (st is None or st.closed) and (tr is None or tr.done):
                self._owned.discard(rid)
                self.router.streams.pop(rid, None)
                self.router.tracked.pop(rid, None)

    def _end(self, rid: int, error: str) -> None:
        """End `rid`'s stream with a typed terminal the router never
        produced (its submit raised)."""
        with self.events_lock:
            sub = self._subs.get(rid)
            if sub is None:
                return
            sub.events.append(("end", {"status": "error", "error": error}))
            sub.shed = True
            self._wake(sub)

    @staticmethod
    def _wake(sub: _Subscriber) -> None:
        try:
            sub.loop.call_soon_threadsafe(sub.wake.set)
        except RuntimeError:
            pass  # connection's loop already closed

    def take(self, sub: _Subscriber) -> list:
        """The events buffered for `sub` since the last take."""
        with self.events_lock:
            batch = list(sub.events)
            sub.events.clear()
        return batch

    def finish(self, rid: int) -> None:
        """The connection is done with this stream (terminal written,
        or the socket died): unsubscribe. The driver's next pass reaps
        the router-side record once the request is done and its stream
        closed, so a long-lived front door stays bounded; a request
        still decoding (shed reader / dropped socket) is not reaped
        before — popping its tracked entry would strand
        `router._pending` and the drain floor with it."""
        with self.events_lock:
            self._subs.pop(rid, None)
        self._kick.set()

    @property
    def inflight(self) -> int:
        with self.events_lock:
            return len(self._subs)


class Frontdoor:
    """The HTTP/SSE server. `start()` binds (resolving an ephemeral
    port into `self.port`) and spins the asyncio loop plus the router
    driver on daemon threads; `close()` tears both down. Use as a
    context manager in tests."""

    def __init__(self, router, *, config: FrontdoorConfig = FrontdoorConfig(),
                 admission: Optional[AdmissionController] = None,
                 auth: Optional[Callable[[dict], bool]] = None,
                 validate: Optional[Callable[[dict], Optional[str]]] = None,
                 metrics=None, tracer=None) -> None:
        self.config = config
        self.admission = admission or AdmissionController()
        self._auth = auth
        self._validate = validate
        self.metrics = metrics
        self.tracer = tracer
        self.driver = RouterDriver(
            router, idle_sleep_s=config.idle_sleep_s,
            max_buffered_events=config.max_buffered_events,
        )
        self.port: Optional[int] = None
        self.draining = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._open_conns = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Frontdoor":
        self.driver.start()
        self._thread = threading.Thread(
            target=self._serve_thread, name="frontdoor-http", daemon=True
        )
        self._thread.start()
        if not self._ready.wait(timeout=30.0):
            raise RuntimeError("frontdoor failed to bind")
        return self

    def _serve_thread(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self.config.host, self.config.port
            )
            if self.config.sndbuf is not None:
                for s in self._server.sockets:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                 self.config.sndbuf)
            self.port = self._server.sockets[0].getsockname()[1]
            self._ready.set()

        try:
            loop.run_until_complete(boot())
            loop.run_forever()
        finally:
            try:
                if self._server is not None:
                    self._server.close()
                    loop.run_until_complete(self._server.wait_closed())
            finally:
                loop.close()

    def close(self) -> None:
        if self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.driver.stop()

    def __enter__(self) -> "Frontdoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- drain
    def begin_drain(self) -> None:
        """Refuse new generates (503) while in-flight streams finish —
        the same typed-refusal-then-finish shape as the worker's
        SIGTERM path, one layer up."""
        self.draining = True

    def drain(self, timeout_s: float = 30.0) -> bool:
        """begin_drain + block until the floor is clear (True) or the
        timeout lapses with streams still in flight (False)."""
        self.begin_drain()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.driver.inflight == 0 and self.driver.router.idle:
                return True
            time.sleep(0.01)
        return self.driver.inflight == 0 and self.driver.router.idle

    def install_sigterm(self) -> None:
        """SIGTERM -> begin_drain, mirroring serve/worker.py. Main
        thread only (signal module constraint)."""
        signal.signal(signal.SIGTERM, lambda *_: self.begin_drain())

    # ------------------------------------------------------------- metrics
    def _count(self, what: str, **labels) -> None:
        m = self.metrics
        if m is not None:
            m.count(what, **labels)

    def _instant(self, name: str, **attrs) -> None:
        rec = self.tracer
        if rec is not None and getattr(rec, "enabled", False):
            rec.instant(name, pid=ROUTER_PID, **attrs)

    # ------------------------------------------------------------ handler
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._open_conns += 1
        try:
            await self._handle_inner(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass  # client went away mid-anything: nothing to answer
        finally:
            self._open_conns -= 1
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_inner(self, reader, writer) -> None:
        try:
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"),
                timeout=self.config.header_timeout_s,
            )
        except asyncio.LimitOverrunError:
            return await self._respond(writer, 431, {"error": "headers too large"})
        method, path, headers = _parse_head(head)
        if method is None:
            return await self._respond(writer, 400, {"error": "malformed request"})
        if method == "GET" and path == "/healthz":
            return await self._healthz(writer)
        if method != "POST" or path != "/v1/generate":
            return await self._respond(writer, 404, {"error": f"no route {method} {path}"})
        # ---- body
        try:
            n = int(headers.get("content-length", ""))
        except ValueError:
            return await self._respond(writer, 411, {"error": "content-length required"})
        if n > self.config.max_body_bytes:
            return await self._respond(writer, 413, {"error": "body too large"})
        body = await reader.readexactly(n)
        # ---- auth (hook wins; else static bearer token when configured)
        if not self._authorized(headers):
            self._count("http", code=401)
            return await self._respond(writer, 401, {"error": "unauthorized"})
        # ---- validation
        try:
            req = json.loads(body)
        except ValueError:
            self._count("http", code=400)
            return await self._respond(writer, 400, {"error": "body is not JSON"})
        err = self._validate_request(req)
        if err is not None:
            self._count("http", code=400)
            return await self._respond(writer, 400, {"error": err})
        # ---- drain gate: typed refusal, retryable elsewhere
        if self.draining:
            self._count("http", code=503)
            return await self._respond(
                writer, 503, {"error": "draining"}, retry_after=1)
        # ---- per-tenant admission
        tenant = req.get("tenant")
        ok, why = self.admission.try_acquire(tenant)
        if not ok:
            self._count("http", code=429)
            self._count("admission_refused", reason=why)
            return await self._respond(
                writer, 429,
                {"error": "admission refused", "reason": why,
                 "tenant": tenant},
                retry_after=1)
        try:
            await self._stream_generate(writer, req, tenant)
        finally:
            self.admission.release(tenant)

    # ------------------------------------------------- the streaming path
    async def _stream_generate(self, writer, req: dict,
                               tenant: Optional[str]) -> None:
        loop = asyncio.get_running_loop()
        wake = asyncio.Event()
        fields = dict(
            prompt=[int(t) for t in req["prompt"]],
            max_new_tokens=int(req.get("max_new_tokens", 32)),
            seed=int(req.get("seed", 0)),
            priority=int(req.get("priority", 0)),
            tenant=tenant,
            temperature=_opt_float(req.get("temperature")),
            top_k=_opt_int(req.get("top_k")),
            top_p=_opt_float(req.get("top_p")),
        )
        if req.get("timeout_s") is not None:
            dl = float(req["timeout_s"])
            fields["deadline"] = self.driver.router.clock.now() + dl
        rid, sub = self.driver.submit(fields, tenant, loop, wake)
        # the backpressure trip point: drain() parks once this much is
        # queued in the transport (beyond whatever the kernel absorbs)
        writer.transport.set_write_buffer_limits(
            high=self.config.write_buffer_bytes)
        self._count("http", code=200)
        self._instant("http_request", rid=rid,
                      tenant=tenant or "", n_prompt=len(fields["prompt"]))
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n"
        )
        # wire ids are assigned by delivery order here (== StreamEvent
        # seq whenever nothing was shed): contiguity on the wire is a
        # construction, not a hope, and the synthetic slow_consumer
        # terminal slots in without a gap
        next_id = 0
        try:
            while True:
                batch = self.driver.take(sub)
                if not batch:
                    await wake.wait()
                    wake.clear()
                    continue
                done = False
                out = bytearray()
                for ev in batch:
                    if isinstance(ev, tuple):   # synthetic (shed) frame
                        kind, data = ev
                    else:
                        kind = ev.kind
                        data = {"start": ev.start,
                                "tokens": list(ev.tokens)}
                        if ev.status is not None:
                            data["status"] = ev.status
                        if ev.attrs:
                            data["attrs"] = ev.attrs
                    out += _chunk(encode_event(kind, next_id, data))
                    next_id += 1
                    if kind == "end":
                        done = True
                if done:
                    out += b"0\r\n\r\n"   # terminating chunk
                writer.write(bytes(out))
                # REAL backpressure: a slow socket parks us here while
                # the driver keeps filling (and, past the bound,
                # shedding) the subscriber buffer
                await writer.drain()
                if done:
                    self._instant("http_stream_end", rid=rid,
                                  frames=next_id)
                    return
        finally:
            self.driver.finish(rid)

    # ------------------------------------------------------------- helpers
    def _authorized(self, headers: dict) -> bool:
        if self._auth is not None:
            return bool(self._auth(headers))
        tok = self.config.auth_token
        if tok is None:
            return True
        return headers.get("authorization", "") == f"Bearer {tok}"

    def _validate_request(self, req) -> Optional[str]:
        if not isinstance(req, dict):
            return "body must be a JSON object"
        prompt = req.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and t >= 0 for t in prompt)):
            return "prompt must be a non-empty list of token ids"
        if len(prompt) > self.config.max_prompt_len:
            return (f"prompt too long ({len(prompt)} > "
                    f"{self.config.max_prompt_len})")
        mnt = req.get("max_new_tokens", 32)
        if not isinstance(mnt, int) or not (
                1 <= mnt <= self.config.max_new_tokens):
            return (f"max_new_tokens must be an int in "
                    f"[1, {self.config.max_new_tokens}]")
        for key, typ in (("temperature", (int, float)),
                         ("top_p", (int, float)), ("top_k", int),
                         ("seed", int), ("priority", int)):
            v = req.get(key)
            if v is not None and (not isinstance(v, typ)
                                  or isinstance(v, bool)):
                return f"{key} must be a number"
        if self._validate is not None:
            return self._validate(req)
        return None

    async def _healthz(self, writer) -> None:
        with self.driver.lock:
            r = self.driver.router
            body = {
                "status": "draining" if self.draining else "ok",
                "pending": r._pending,
                "inflight_streams": self.driver.inflight,
                "replicas": r.states(),
                "slow_consumer_sheds": self.driver.sheds,
            }
        await self._respond(writer, 200, body)

    @staticmethod
    async def _respond(writer, code: int, body: dict,
                       retry_after: Optional[int] = None) -> None:
        reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                  404: "Not Found", 411: "Length Required",
                  413: "Payload Too Large", 429: "Too Many Requests",
                  431: "Headers Too Large", 503: "Service Unavailable",
                  }.get(code, "Error")
        payload = json.dumps(body).encode()
        head = (f"HTTP/1.1 {code} {reason}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n"
                + (f"Retry-After: {retry_after}\r\n" if retry_after else "")
                + "Connection: close\r\n\r\n")
        writer.write(head.encode() + payload)
        await writer.drain()


# -------------------------------------------------------------- wire parse
def _parse_head(head: bytes):
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, path, _version = lines[0].split(" ", 2)
    except (UnicodeDecodeError, ValueError):
        return None, None, {}
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return method, path, headers


def _chunk(payload: bytes) -> bytes:
    return f"{len(payload):x}\r\n".encode() + payload + b"\r\n"


def _opt_float(v):
    return None if v is None else float(v)


def _opt_int(v):
    return None if v is None else int(v)


# ------------------------------------------------------------- the client
def sse_request(host: str, port: int, body: dict, *,
                headers: Optional[dict] = None,
                timeout_s: float = 60.0,
                read_delay_s: float = 0.0,
                rcvbuf: Optional[int] = None,
                ) -> Tuple[int, List[dict]]:
    """Blocking SSE client over a raw socket: POST the JSON body, parse
    the response, return ``(status_code, events)``. Non-200 responses
    return the JSON error payload as a single ``{"event": "http_error",
    "data": ...}`` pseudo-event so callers always get a typed answer.

    `read_delay_s` sleeps between socket reads and `rcvbuf` shrinks the
    client's receive window (set before connect, so it negotiates) —
    the levers the bench's slow-consumer arm uses to provoke the shed
    path with a genuinely slow reader rather than a mocked one. Shares
    serve/sse.py's parser with the server's encoder, so both ends of
    the wire are pinned to one codec.

    Each returned event carries a ``"t"`` monotonic receive timestamp
    (stamped when its frame was parsed off the socket) so callers can
    score client-side TTFT/inter-token latency without wrapping the
    read loop."""
    payload = json.dumps(body).encode()
    req_headers = {"Host": f"{host}:{port}",
                   "Content-Type": "application/json",
                   "Content-Length": str(len(payload)),
                   "Connection": "close"}
    req_headers.update(headers or {})
    head = "POST /v1/generate HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in req_headers.items()) + "\r\n"
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        if rcvbuf is not None:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        s.settimeout(timeout_s)
        s.connect((host, port))
        s.sendall(head.encode() + payload)
        raw = b""
        while b"\r\n\r\n" not in raw:
            got = s.recv(65536)
            if not got:
                return 0, []
            raw += got
        head_raw, rest = raw.split(b"\r\n\r\n", 1)
        status = int(head_raw.split(b" ", 2)[1])
        head_text = head_raw.decode("latin-1").lower()
        if status != 200 or "text/event-stream" not in head_text:
            while True:
                got = s.recv(65536)
                if not got:
                    break
                rest += got
            try:
                data = json.loads(rest.decode("utf-8", "replace")
                                  .split("\r\n")[-1] or "{}")
            except ValueError:
                data = {}
            return status, [{"id": None, "event": "http_error",
                             "data": data}]
        parser = SSEParser()
        events: List[dict] = []
        dechunk = _Dechunker()

        def take(data: bytes) -> None:
            new = parser.feed(dechunk.feed(data))
            now = time.monotonic()
            for ev in new:
                ev["t"] = now
            events.extend(new)

        take(rest)
        while not dechunk.done:
            if read_delay_s:
                time.sleep(read_delay_s)
            got = s.recv(512 if read_delay_s else 65536)
            if not got:
                break
            take(got)
        return status, events


class _Dechunker:
    """Minimal HTTP/1.1 chunked-transfer decoder for the client side."""

    def __init__(self) -> None:
        self._buf = b""
        self.done = False

    def feed(self, data: bytes) -> bytes:
        self._buf += data
        out = b""
        while True:
            nl = self._buf.find(b"\r\n")
            if nl < 0:
                return out
            try:
                size = int(self._buf[:nl], 16)
            except ValueError:
                # not at a chunk boundary somehow — surface raw to fail
                # loudly in the parser rather than hang silently
                out += self._buf
                self._buf = b""
                return out
            if len(self._buf) < nl + 2 + size + 2:
                return out
            out += self._buf[nl + 2:nl + 2 + size]
            self._buf = self._buf[nl + 2 + size + 2:]
            if size == 0:
                self.done = True
                return out
