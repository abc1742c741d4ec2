"""The one HTTP POST helper every push-plane producer shares.

(Host-pure Python: a copy of ddp_practice_tpu/utils/http_post.py: the
port imports nothing of the reference package.)

Two subsystems deliver JSON payloads to an HTTP endpoint: the SLO
webhook sink (serve/slo.py AlertSinks) and the OTLP trace pusher
(utils/telemetry.py OtlpPusher). Both wrap the call in their own
breaker/backoff machinery and both treat "False or raised" as one
failed delivery attempt — so the transport itself lives here, once,
stdlib-only (urllib.request; no new dependency for a POST).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional


def post_json(url: str, payload, *, timeout_s: float = 3.0,
              headers: Optional[dict] = None) -> bool:
    """POST `payload` as application/json; True iff the server answered
    with a success status (< 400). `payload` may be a dict/list (dumped
    here), a pre-encoded str, or raw bytes. Network errors and HTTP
    error statuses RAISE (urllib turns 4xx/5xx into URLError) — callers'
    breaker loops already treat an exception exactly like False, and
    swallowing it here would cost them the reason."""
    if isinstance(payload, (bytes, bytearray)):
        data = bytes(payload)
    elif isinstance(payload, str):
        data = payload.encode("utf-8")
    else:
        # compact separators: both producers post machine-read JSON on
        # a hot path — the pretty-print spaces are pure wire/CPU tax
        data = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    hdrs = {"Content-Type": "application/json"}
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(url, data=data, headers=hdrs)
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        return r.status < 400
