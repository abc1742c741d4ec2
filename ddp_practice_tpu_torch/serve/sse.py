"""Server-Sent Events codec for the serving front door.

(Host-pure Python: a copy of ddp_practice_tpu/serve/sse.py with its
imports pointed at the port; the port imports nothing of the
reference package.)

One StreamEvent (serve/router.py) maps to one SSE frame, losslessly::

    id: <seq>
    event: <tokens|resumed|end>
    data: {"start": 0, "tokens": [5, 9], ...}
    <blank line>

The mapping is deliberately 1:1 with the in-process exactly-once
contract: ``id`` IS the stream's contiguous ``seq`` (so a wire capture
can be audited by the same rules tools/check_stream.py applies to the
router's telemetry JSONL — contiguous ids from 0, exactly one terminal
frame), ``event`` IS the typed kind, and ``data`` carries the rest of
the StreamEvent as JSON. Nothing is added on the wire that the
in-process consumer would not see, and nothing is dropped — a consumer
reading frames learns exactly what `TokenStream.events` records.

Both halves live here: `encode_event` (server -> wire) and `SSEParser`
(wire -> events, incremental, boundary-safe), so the bench's client
and the server share one codec and a framing bug cannot hide between
two implementations. Pure stdlib, no I/O — the front door owns sockets.
"""

from __future__ import annotations

import json
from typing import List, Optional

# the event kinds the wire may carry — the StreamEvent kinds plus
# "error", the front door's pre-stream failure frame (a request that
# never reached the router still ends with a typed terminal, never a
# dropped connection)
KINDS = ("tokens", "resumed", "end", "error")


def encode_event(kind: str, seq: int, data: dict) -> bytes:
    """One SSE frame. `data` must be JSON-serializable; newlines inside
    the payload are impossible by construction (json.dumps never emits
    raw newlines), so the single `data:` line framing is safe."""
    payload = json.dumps(data, separators=(",", ":"), sort_keys=True)
    return (f"id: {seq}\nevent: {kind}\ndata: {payload}\n\n").encode()


def encode_stream_event(ev) -> bytes:
    """A router StreamEvent onto the wire, field-for-field."""
    data = {"start": ev.start, "tokens": list(ev.tokens)}
    if ev.status is not None:
        data["status"] = ev.status
    if ev.attrs:
        data["attrs"] = ev.attrs
    if ev.trace_id is not None:
        data["trace_id"] = ev.trace_id
    return encode_event(ev.kind, ev.seq, data)


class SSEParser:
    """Incremental SSE decoder: feed raw bytes (any chunking — a frame
    may arrive split across TCP segments, or many per segment), collect
    complete events. Tolerates \\r\\n and \\n line endings; unknown
    field names are ignored per the SSE spec."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, data: bytes) -> List[dict]:
        """Returns the events completed by this chunk, in order. Each
        is ``{"id": int|None, "event": str, "data": dict|str}`` —
        `data` is parsed JSON when it parses, the raw string otherwise
        (the audit distinguishes malformed payloads from absent ones)."""
        self._buf += data
        out: List[dict] = []
        while True:
            # a frame ends at the first blank line (either ending)
            cut, sep = self._find_frame_end()
            if cut < 0:
                return out
            frame, self._buf = self._buf[:cut], self._buf[cut + sep:]
            ev = self._parse_frame(frame)
            if ev is not None:
                out.append(ev)

    def _find_frame_end(self):
        a = self._buf.find(b"\n\n")
        b = self._buf.find(b"\r\n\r\n")
        if a < 0 and b < 0:
            return -1, 0
        if b < 0 or (0 <= a < b):
            return a, 2
        return b, 4

    @staticmethod
    def _parse_frame(frame: bytes) -> Optional[dict]:
        ev_id: Optional[int] = None
        kind = "message"          # the SSE default event name
        data_lines: List[str] = []
        for raw in frame.decode("utf-8", "replace").splitlines():
            if not raw or raw.startswith(":"):
                continue          # comment / keep-alive line
            name, _, value = raw.partition(":")
            value = value[1:] if value.startswith(" ") else value
            if name == "id":
                try:
                    ev_id = int(value)
                except ValueError:
                    ev_id = None
            elif name == "event":
                kind = value
            elif name == "data":
                data_lines.append(value)
        if not data_lines and ev_id is None and kind == "message":
            return None           # pure comment frame
        text = "\n".join(data_lines)
        try:
            data = json.loads(text) if text else {}
        except ValueError:
            data = text
        return {"id": ev_id, "event": kind, "data": data}
