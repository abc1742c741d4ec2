"""Live telemetry plane, the part a worker process boots: the rolling
flight window and the HTTP scrape endpoints.

(Host-pure Python: `FlightStats`, `_overall_health` and `TelemetryServer`
copied from ddp_practice_tpu/utils/telemetry.py; the port imports
nothing of the reference package. The JSONL `TelemetryExporter`, the OTLP
pusher and its stub collector, the fleet `ScrapeFederator` and the
train-side `StepAnomalyDetector` are the telemetry plane's (ROADMAP A6d).)

- **TelemetryServer** — an embedded stdlib ThreadingHTTPServer (port 0
  for tests) exposing ``/metrics`` (utils/metrics.py render_text
  Prometheus exposition), ``/healthz`` (per-replica HEALTHY/DEGRADED/
  DEAD via an injected callback; 503 only when the whole fleet is dead),
  ``/flight`` (rolling per-phase queue/prefill/decode/stall percentiles
  from flight records) and ``/tenants`` (the per-tenant QoS rollup).
- **FlightStats** — the rolling window behind ``/flight``: last-N
  flight records summarized through utils/metrics.percentile_summary,
  the same percentile math the bench and the SLO tools use.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from ddp_practice_tpu_torch.utils.metrics import (
    MetricsRegistry,
    percentile_summary,
)


class FlightStats:
    """Rolling window of flight records -> per-phase percentiles.

    The live counterpart of the bench's offline phase breakdown: the
    last `window` completions' queue/prefill/decode/stall seconds plus
    TTFT/TPOT, summarized on demand for the ``/flight`` endpoint and
    anything else that wants "where is latency going RIGHT NOW".
    Thread-safe: the serve loop appends, the HTTP thread reads.
    """

    PHASES = ("queue_s", "prefill_s", "decode_s", "stall_s")
    # non-phase flight fields summarized the same way; kept separate
    # from PHASES so phase-sum invariants elsewhere stay honest.
    # spec_accept_rate only appears on flights that actually drafted
    # (speculative decoding, serve/spec.py) — the `key in f` guards
    # below make mixed windows work.
    EXTRAS = ("spec_accept_rate",)
    # raw samples shipped per report, newest last, for fleet rollup
    # (ScrapeFederator.flight pools every worker's samples and
    # recomputes TRUE fleet percentiles — percentiles of percentiles
    # would be a lie)
    SAMPLES_PER_REPORT = 256

    def __init__(self, window: int = 512) -> None:
        self._lock = threading.Lock()
        self._flights: deque = deque(maxlen=window)
        self._ttft: deque = deque(maxlen=window)    # (value, trace_id)
        self._tpot: deque = deque(maxlen=window)

    def on_completion(self, completion, **_kw) -> None:
        tid = getattr(completion, "trace_id", None)
        if not getattr(completion, "trace_sampled", True):
            # suppressed by sampling: the latency sample still counts,
            # but the p99 exemplar must not point at a trace that is
            # not in the timeline
            tid = None
        with self._lock:
            if completion.flight is not None:
                self._flights.append(completion.flight)
            if completion.ttft is not None:
                self._ttft.append((completion.ttft, tid))
            if completion.tpot is not None:
                self._tpot.append((completion.tpot, tid))

    @staticmethod
    def _p99_exemplar(pairs, p99):
        """trace_id of the sample AT the rolling p99 (nearest-rank
        returns an actual sample value, so an exact match exists);
        None when no sample carried a trace_id."""
        for v, tid in pairs:
            if v == p99 and tid is not None:
                return {"trace_id": tid, "value": v}
        return None

    def report(self) -> dict:
        with self._lock:
            flights = list(self._flights)
            ttft = list(self._ttft)
            tpot = list(self._tpot)
        out: dict = {"window": len(flights)}
        for key in self.PHASES + self.EXTRAS:
            out[key] = percentile_summary(
                [f[key] for f in flights if key in f]
            )
        out["ttft_s"] = percentile_summary([v for v, _ in ttft])
        out["tpot_s"] = percentile_summary([v for v, _ in tpot])
        # p99 -> trace pointers (the /flight mirror of the /metrics
        # bucket exemplars) + raw sample tails for fleet federation
        exemplars = {}
        ex = self._p99_exemplar(ttft, out["ttft_s"]["p99"])
        if ex is not None:
            exemplars["ttft_p99"] = ex
        ex = self._p99_exemplar(tpot, out["tpot_s"]["p99"])
        if ex is not None:
            exemplars["tpot_p99"] = ex
        if exemplars:
            out["exemplars"] = exemplars
        cap = self.SAMPLES_PER_REPORT
        samples = {"ttft_s": [v for v, _ in ttft[-cap:]],
                   "tpot_s": [v for v, _ in tpot[-cap:]]}
        for key in self.PHASES + self.EXTRAS:
            samples[key] = [f[key] for f in flights[-cap:] if key in f]
        out["samples"] = samples
        return out


# --------------------------------------------------------------- HTTP plane
# /healthz overall verdict: DEAD only when EVERY replica is dead (a fleet
# with one live replica still serves — degraded is a routing concern, not
# an availability one); 503 only on DEAD so orchestrators restart the
# process exactly when it can no longer serve at all.
def _overall_health(states: Dict) -> str:
    vals = [str(v).lower() for v in states.values()]
    if vals and all(v == "dead" for v in vals):
        return "DEAD"
    if any(v != "healthy" for v in vals):
        return "DEGRADED"
    return "HEALTHY"


class TelemetryServer:
    """Embedded scrape endpoint: /metrics, /healthz, /flight.

    stdlib ThreadingHTTPServer on its own daemon thread — no framework,
    no dependency, good enough for a scraper hitting it a few times a
    second. `port=0` binds an ephemeral port (tests read `.port`).
    Handlers only READ (render_text snapshot, health callback, flight
    window), so they never contend with the serve loop beyond the
    registry's create-lock.
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 health_fn: Optional[Callable[[], Dict]] = None,
                 flight_fn: Optional[Callable[[], dict]] = None,
                 healthz_fn: Optional[Callable[[], dict]] = None,
                 tenants_fn: Optional[Callable[[], dict]] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 start: bool = True) -> None:
        # `registry` is duck-typed: anything with render_text() serves
        # /metrics (a MetricsRegistry, or a ScrapeFederator rolling a
        # whole fleet up). `healthz_fn`, when set, returns the FULL
        # /healthz body (the federated shape carries per-worker
        # heartbeat ages — richer than health_fn's flat state map);
        # the 503-on-DEAD contract is keyed off its "status" field.
        # `tenants_fn` serves the per-tenant QoS rollup (a
        # serve/fairshare.py TenantLedger.report, or a federator's
        # tenants() for the fleet view).
        self.registry = registry
        self.health_fn = health_fn
        self.flight_fn = flight_fn
        self.healthz_fn = healthz_fn
        self.tenants_fn = tenants_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr spam per scrape
                pass

            def do_GET(self):
                try:
                    body, status, ctype = outer._route(self.path)
                except Exception as e:  # a broken callback must not
                    body = f"internal error: {e}".encode()
                    status, ctype = 500, "text/plain"  # kill the server
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def _route(self, path: str):
        path = path.split("?", 1)[0]
        if path == "/metrics":
            text = (self.registry.render_text()
                    if self.registry is not None else "")
            return text.encode(), 200, "text/plain; version=0.0.4"
        if path == "/healthz":
            if self.healthz_fn is not None:
                body_obj = self.healthz_fn()
                overall = str(body_obj.get("status", "")).upper()
                return (json.dumps(body_obj).encode(),
                        503 if overall == "DEAD" else 200,
                        "application/json")
            states = dict(self.health_fn()) if self.health_fn else {}
            overall = _overall_health(states)
            body = json.dumps({"status": overall, "replicas": states})
            return (body.encode(),
                    503 if overall == "DEAD" else 200,
                    "application/json")
        if path == "/flight":
            report = self.flight_fn() if self.flight_fn else {}
            return json.dumps(report).encode(), 200, "application/json"
        if path == "/tenants":
            report = self.tenants_fn() if self.tenants_fn else {}
            return json.dumps(report).encode(), 200, "application/json"
        return b"not found", 404, "text/plain"

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="telemetry-http", daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        if self._thread is None:
            return
        self._server.shutdown()
        self._thread.join(timeout=5.0)
        self._server.server_close()
        self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
