"""Transport seam for the cross-process serving fleet.

(Host-pure Python: a copy of ddp_practice_tpu/serve/rpc.py with its
imports pointed at the port; the port imports nothing of the
reference package.)

The router <-> replica boundary was DESIGNED to be exactly
two operations — `Scheduler.submit(request)` going down and the
completions watermark coming back up (plus the health/evacuate edges
around them) — so making a replica a real OS process only requires a
wire under those two calls. This module is that wire: length-prefixed
JSON over a localhost TCP socket, stdlib only.

Framing: every message is a 4-byte big-endian length followed by that
many bytes of UTF-8 JSON. One request frame in, one response frame out,
strictly alternating per connection. JSON because every payload already
IS json-shaped (requests carry rid/prompt/deadline/priority/trace_id/
tenant, completions carry tokens/status/tenant/flight records — the
same dicts the telemetry stream writes), and because a human can
tcpdump it. The live ``trace`` op carries the sampling levers the same
way: ``sample`` (fleet head rate) and ``tenant_rates`` (per-tenant
overrides), applied by the worker without a restart.

Failure semantics (the part that matters for a chaos-tested fleet):

- every call has a TIMEOUT (socket-level). A worker that was SIGSTOPped
  mid-decode doesn't hang the router — the call raises `RpcTimeout`,
  the caller's heartbeat accounting decides whether that is a blip or a
  death (serve/supervisor.py feeds serve/health.py breakers).
- transport errors RETRY with the shared utils/backoff.py schedule —
  bounded attempts, deterministic jitter — reconnecting each time.
  Retrying is safe only because every operation is IDEMPOTENT at the
  worker: `submit` is deduplicated by rid, `poll` is a watermark read,
  `ping`/`shed`/`drain` are repeat-safe (serve/worker.py holds up that
  contract).
- an error REPLY (`{"ok": false, "error": ...}`) raises
  `RpcRemoteError` and is NOT retried: the frame made it, the handler
  rejected it — retrying would re-run a failing operation.

The server is deliberately small: an accept loop on a daemon thread,
one thread per connection, handlers dispatched from a dict. A handler
exception becomes an error reply, never a dead connection.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Callable, Dict, Optional

from ddp_practice_tpu_torch.utils.backoff import backoff_delay

# one frame must hold a few thousand completions of a saturated poll;
# 64 MiB is ~3 orders of magnitude above that and still refuses a
# corrupt length prefix before it allocates the moon
MAX_FRAME_BYTES = 64 * 1024 * 1024
_LEN = struct.Struct(">I")


class RpcError(RuntimeError):
    """Transport-level failure: connect refused, peer closed, bad frame."""


class RpcTimeout(RpcError):
    """The per-call deadline expired (a stalled or SIGSTOPped peer)."""


class RpcRemoteError(RuntimeError):
    """The peer processed the frame and answered with an error —
    NOT a transport failure, never retried."""


# ----------------------------------------------------------------- framing
def send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    if len(data) > MAX_FRAME_BYTES:
        raise RpcError(f"frame too large: {len(data)} bytes")
    try:
        sock.sendall(_LEN.pack(len(data)) + data)
    except socket.timeout as e:
        raise RpcTimeout(f"send timed out: {e}") from e
    except OSError as e:
        raise RpcError(f"send failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout as e:
            raise RpcTimeout(f"recv timed out: {e}") from e
        except OSError as e:
            raise RpcError(f"recv failed: {e}") from e
        if not chunk:
            raise RpcError("peer closed the connection mid-frame"
                           if buf else "peer closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME_BYTES:
        raise RpcError(f"frame length {n} exceeds {MAX_FRAME_BYTES}")
    try:
        return json.loads(_recv_exact(sock, n).decode("utf-8"))
    except ValueError as e:
        raise RpcError(f"bad frame payload: {e}") from e


# ------------------------------------------------------------------ client
class RpcClient:
    """One persistent connection to a worker, with per-call timeouts and
    bounded reconnect-retries on transport failure.

    NOT thread-safe by design — the router's tick loop is the single
    caller (`call` holds a lock anyway as a belt, so a stray second
    thread serializes instead of interleaving frames).
    """

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 5.0,
                 retries: int = 2,
                 retry_base_s: float = 0.02,
                 retry_max_s: float = 0.5,
                 seed: int = 0,
                 sleep: Callable[[float], None] = None) -> None:
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.retries = retries
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.seed = seed
        self._sleep = sleep if sleep is not None else time.sleep
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s
            )
        except OSError as e:
            raise RpcError(f"connect to {self.host}:{self.port} "
                           f"failed: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def call(self, op: str, *, timeout_s: Optional[float] = None,
             retries: Optional[int] = None, **fields) -> dict:
        """One request/response round trip. Raises RpcTimeout /
        RpcError after the retry budget, RpcRemoteError immediately on
        an error reply. `timeout_s`/`retries` override the client
        defaults per call (a heartbeat wants to fail FAST and let the
        caller's staleness accounting judge; a submit can afford the
        full budget)."""
        req = {"op": op, **fields}
        deadline = timeout_s if timeout_s is not None else self.timeout_s
        budget = retries if retries is not None else self.retries
        last: Optional[Exception] = None
        with self._lock:
            for attempt in range(budget + 1):
                if attempt:
                    self._sleep(backoff_delay(
                        attempt - 1, base_s=self.retry_base_s,
                        max_s=self.retry_max_s, seed=self.seed,
                    ))
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    self._sock.settimeout(deadline)
                    send_frame(self._sock, req)
                    reply = recv_frame(self._sock)
                except RpcError as e:
                    # transport failure: the connection state is
                    # unknowable (a frame may be half-written) — drop
                    # it and reconnect on the next attempt. Safe
                    # because worker ops are idempotent (module doc).
                    self._drop()
                    last = e
                    continue
                if not reply.get("ok", False):
                    raise RpcRemoteError(
                        f"{op}: {reply.get('error', 'unknown error')}"
                    )
                return reply
        raise last  # type: ignore[misc]

    def cast(self, op: str, *, timeout_s: Optional[float] = None,
             **fields) -> None:
        """One-way send: ship the frame, read NO reply. The frame is
        flagged `oneway` so the server skips its response (see
        _serve_conn) — an unread reply left in the socket would desync
        the next call() on this connection. Delivery is NOT confirmed:
        callers must be idempotent and reconcile (the fleet submit path
        confirms by rid on the next poll and resubmits what never
        landed). One reconnect attempt on transport failure, then the
        error propagates — the caller's breaker accounting judges."""
        req = {"op": op, "oneway": True, **fields}
        deadline = timeout_s if timeout_s is not None else self.timeout_s
        last: Optional[Exception] = None
        with self._lock:
            for _ in range(2):
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    self._sock.settimeout(deadline)
                    send_frame(self._sock, req)
                    return
                except RpcError as e:
                    self._drop()
                    last = e
        raise last  # type: ignore[misc]

    def close(self) -> None:
        with self._lock:
            self._drop()

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------- client-side stream
class FrameStream:
    """Buffered NON-BLOCKING frame reader over a connected socket — the
    client side of a push subscription (serve/worker.py `subscribe`).
    `drain()` returns every complete frame currently available without
    ever waiting: the router calls it once per tick, so steady-state
    completion delivery costs no round trips at all (the poll op stays
    as the reconciliation/recovery path)."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._sock.setblocking(False)
        self._buf = bytearray()
        self._closed = False

    def fileno(self) -> int:
        """The underlying fd — a select()-driven caller sleeps on this
        and wakes exactly when the server pushes (no polling, no
        sleep-quantized consumption lag)."""
        return self._sock.fileno()

    def drain(self) -> list:
        while not self._closed:
            try:
                chunk = self._sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                raise RpcError(f"stream recv failed: {e}") from e
            if not chunk:
                # peer closed (e.g. the worker died) — but the kernel
                # buffer may still hold frames pushed BEFORE the death:
                # parse and return them first, raise on the NEXT drain.
                # A SIGKILLed worker's final pub frame carries the
                # freshest salvage point + chunk slice; discarding it
                # here would widen every failover's resume gap.
                self._closed = True
                break
            self._buf.extend(chunk)
        frames = []
        while len(self._buf) >= _LEN.size:
            (n,) = _LEN.unpack(bytes(self._buf[:_LEN.size]))
            if n > MAX_FRAME_BYTES:
                raise RpcError(f"stream frame length {n} exceeds cap")
            if len(self._buf) < _LEN.size + n:
                break
            try:
                frames.append(json.loads(
                    bytes(self._buf[_LEN.size:_LEN.size + n])
                ))
            except ValueError as e:
                raise RpcError(f"bad stream frame: {e}") from e
            del self._buf[:_LEN.size + n]
        if self._closed and not frames:
            raise RpcError("stream peer closed")
        return frames

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def open_stream(host: str, port: int, op: str = "subscribe",
                timeout_s: float = 5.0, **fields) -> FrameStream:
    """Connect, send one `op` frame, await the ok reply, then hand the
    socket over as a FrameStream the SERVER pushes to from now on."""
    try:
        sock = socket.create_connection((host, port), timeout=timeout_s)
    except OSError as e:
        raise RpcError(f"stream connect failed: {e}") from e
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(timeout_s)
    send_frame(sock, {"op": op, **fields})
    reply = recv_frame(sock)
    if not reply.get("ok", False):
        sock.close()
        raise RpcRemoteError(
            f"{op}: {reply.get('error', 'unknown error')}"
        )
    return FrameStream(sock)


# ------------------------------------------------------------------ server
class RpcServer:
    """Threaded frame server: `handlers[op](request_dict) -> dict`.

    A handler's return dict is sent as `{"ok": true, **result}`; a
    handler exception becomes `{"ok": false, "error": ...}` on the same
    connection (the caller sees RpcRemoteError, the connection lives).
    `port=0` binds an ephemeral port (read `.port`). Handlers run on
    the connection's thread — the worker serializes state mutation with
    its own lock (serve/worker.py), not here.

    PUSH MODE: a handler may return ``{"_stream_queue": q, ...}`` — the
    ok reply (without that key) is sent, then the connection's thread
    stops reading requests and instead DRAINS `q` (a queue.Queue),
    sending each item as a frame until the queue yields a ``None``
    sentinel, the peer goes away, or the server closes. The producer
    (serve/worker.py `_publish`) never touches the socket — one thread
    owns it for life, so pushes cannot interleave with replies.

    Pushed frames are kind-tagged dicts; the worker currently emits
    ``pub`` (completions watermark + per-burst TokenChunk slice with
    its own ``chunks_watermark`` + inflight salvage + stats — chunks
    ride IN the pub frame, not a separate kind, so a dropped frame
    loses the chunk slice and the salvage point together and the
    client's resume cursor can never outrun delivery), ``hb`` (idle
    heartbeat), and ``trace`` (batched span records for the fleet
    TraceCollector, seq-numbered with a cumulative drop count).
    The transport is deliberately agnostic: new kinds ride for free,
    and unknown kinds are skipped by consumers.
    """

    def __init__(self, handlers: Dict[str, Callable[[dict], dict]], *,
                 host: str = "127.0.0.1", port: int = 0,
                 start: bool = True) -> None:
        self.handlers = handlers
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.host = host
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list = []
        self._conns: set = set()       # live sockets, closed on close()
        self._conn_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> None:
        if self._accept_thread is not None:
            return
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        try:
            self._listener.settimeout(0.2)
        except OSError:
            return  # close() won the race before the first accept
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us (close())
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.add(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="rpc-conn", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        req = recv_frame(conn)
                    except RpcError:
                        return  # peer went away (or garbage): done
                    op = req.get("op")
                    handler = self.handlers.get(op)
                    stream_q = stream_closed = None
                    try:
                        if handler is None:
                            raise KeyError(f"unknown op {op!r}")
                        reply = {"ok": True, **(handler(req) or {})}
                        stream_q = reply.pop("_stream_queue", None)
                        stream_closed = reply.pop("_stream_closed", None)
                    except BaseException as e:  # a handler bug must
                        reply = {"ok": False,   # answer, not kill the
                                 "error":       # connection
                                 f"{type(e).__name__}: {e}"}
                    if req.get("oneway"):
                        # fire-and-forget frame (RpcClient.cast): the
                        # client reads no reply, so sending one — even
                        # an error — would be read as the NEXT call's
                        # response and desync the connection. Errors
                        # surface through the caller's reconcile path.
                        continue
                    try:
                        send_frame(conn, reply)
                    except RpcError:
                        return
                    if stream_q is not None:
                        try:
                            self._push_loop(conn, stream_q)
                        finally:
                            # tell the producer its subscriber is gone
                            # (a reconnect-happy client must not leak
                            # one dead queue per drop)
                            if stream_closed is not None:
                                try:
                                    stream_closed()
                                except Exception:
                                    pass
                        return
        finally:
            with self._conn_lock:
                self._conns.discard(conn)

    def _push_loop(self, conn: socket.socket, q) -> None:
        """Own the connection as a push stream: send queue items as
        frames until a None sentinel, peer loss, or server stop."""
        import queue as _queue

        # a subscriber that stops reading must not wedge this thread:
        # a timed-out send drops the stream (the client's poll path is
        # the recovery)
        conn.settimeout(1.0)
        while not self._stop.is_set():
            try:
                item = q.get(timeout=0.25)
            except _queue.Empty:
                continue
            if item is None:
                return
            try:
                send_frame(conn, item)
            except RpcError:
                return

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # close live connections so their threads' blocking recv wakes
        # up NOW — a closed server must stop answering, not keep serving
        # stale handlers through established sockets
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None
        for t in self._threads:
            t.join(timeout=0.5)
        self._threads.clear()

    def __enter__(self) -> "RpcServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
