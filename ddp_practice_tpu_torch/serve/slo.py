"""Declarative SLOs with multi-window burn-rate alerting.

(Host-pure Python: a copy of ddp_practice_tpu/serve/slo.py with its
imports pointed at the port's backoff, registry and trace recorder: the
port imports nothing of the reference package.)

The router's brown-out (serve/router.py) trips on instantaneous fleet
pressure — a PROXY for what actually matters to users: are first tokens
late (TTFT), are streams stuttering (TPOT), are requests erroring, are
answers arriving at all. This module watches the real thing, Google-SRE
style:

- **Everything is a bad-event rate.** Each objective classifies every
  completion as good or bad — TTFT over target, TPOT over target,
  status "error", not-served — and carries an error BUDGET (for a p99
  latency target the budget is 1%: up to 1% of requests may exceed the
  target and the SLO still holds). Burn rate = observed bad fraction /
  budget: 1.0 means consuming budget exactly as fast as allowed,
  10 means ten times too fast.
- **Two windows, asymmetric edges.** An alert TRIPS when burn exceeds
  `trip_burn` in BOTH the fast and the slow window (the fast window
  makes detection quick, the slow window stops a two-request blip from
  paging), and RESOLVES only when the SLOW window's burn falls to
  `resolve_burn` (< trip_burn). Trip fast, resolve slow, and the gap
  between the thresholds is the hysteresis band — no flapping when burn
  hovers at the boundary (pinned in tests/test_slo.py).
- **Clock-injected and host-pure.** Time comes from the same clock the
  scheduler uses, so a FakeClock chaos replay produces bit-identical
  alert timelines; nothing here touches the device.

Alert/resolve edges are emitted three ways so every consumer of the
telemetry plane sees them: tracer instants (``slo_alert`` /
``slo_resolve``, streamed through the TelemetryExporter sink), an
``alert`` JSONL line (kind="alert"), and registry metrics
(``slo_alerts_total``, per-objective ``slo_burn_rate`` /
``slo_alert_active`` gauges). The router consumes `active` as a
brown-out trigger: degradation driven by measured SLO violation, not
just occupancy (serve/router.py _update_brownout).

PUSH delivery (`AlertSinks`): edges additionally fan out to operator
sinks — a command to run, a webhook URL to POST, a JSONL file to append
— because a burning SLO that only lands in a scrape endpoint pages
nobody. Per sink: bounded pending queue, exponential backoff between
delivery retries (utils/backoff.py), and a DEAD-SINK BREAKER — after
`max_failures` consecutive failures the sink is abandoned for good
(``alert_sink_dead`` gauge; a flapping webhook must not hold the serve
loop's alert path hostage forever). `FleetAlerts` federates the same
edges at fleet level: a worker the ScrapeFederator judges dead/stale
raises a trip through the same sinks, its recovery a resolve.

tools/check_slo.py evaluates the same objectives OFFLINE over a
telemetry JSONL (bench artifacts, post-mortems), sharing
`SLOConfig` and the percentile implementation.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

from ddp_practice_tpu_torch.utils.backoff import backoff_delay
from ddp_practice_tpu_torch.utils.metrics import labelled
from ddp_practice_tpu_torch.utils.trace import ROUTER_PID, _resolve_clock

# statuses that count as "served" for the availability objective;
# everything else (timeout/shed/rejected/error) spent the user's
# patience without an answer
OK_STATUSES = ("eos", "length")

# latency objectives are p99-shaped: the budget is the 1% of requests
# allowed over the target
_LATENCY_BUDGET = 0.01


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Targets (None = objective off) + window/threshold tuning.

    JSON-round-trippable so `--slo` takes a literal or a file path:
    ``{"ttft_p99_s": 0.5, "error_rate": 0.01, "availability": 0.99}``.
    """

    ttft_p99_s: Optional[float] = None   # p99 TTFT target (seconds)
    tpot_p99_s: Optional[float] = None   # p99 TPOT target (seconds)
    error_rate: Optional[float] = None   # max fraction status=="error"
    availability: Optional[float] = None  # min fraction served ok
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    trip_burn: float = 2.0      # both windows >= this trips
    resolve_burn: float = 1.0   # slow window <= this resolves
    min_events: int = 5         # don't alert on fewer fast-window events

    def __post_init__(self):
        if self.slow_window_s < self.fast_window_s:
            raise ValueError("slow_window_s must be >= fast_window_s")
        if self.resolve_burn > self.trip_burn:
            raise ValueError(
                "resolve_burn must be <= trip_burn (the hysteresis band)"
            )

    @classmethod
    def from_json(cls, source) -> "SLOConfig":
        """A dict, a JSON string, or a path to a JSON file."""
        if isinstance(source, cls):
            return source
        if isinstance(source, str):
            stripped = source.strip()
            if stripped.startswith("{"):
                source = json.loads(stripped)
            elif os.path.exists(source):
                with open(source) as f:
                    source = json.load(f)
            else:
                raise ValueError(
                    f"--slo wants a JSON object or an existing file path, "
                    f"got {source!r}"
                )
        if not isinstance(source, dict):
            raise TypeError(f"cannot build SLOConfig from {type(source)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(source) - known
        if unknown:
            raise ValueError(f"unknown SLO config keys: {sorted(unknown)}")
        return cls(**source)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def objectives(self) -> Dict[str, float]:
        """Active objectives -> error budget (bad fraction allowed)."""
        out: Dict[str, float] = {}
        if self.ttft_p99_s is not None:
            out["ttft_p99"] = _LATENCY_BUDGET
        if self.tpot_p99_s is not None:
            out["tpot_p99"] = _LATENCY_BUDGET
        if self.error_rate is not None:
            out["error_rate"] = self.error_rate
        if self.availability is not None:
            out["availability"] = 1.0 - self.availability
        if not out:
            raise ValueError("SLO config enables no objective")
        for name, budget in out.items():
            if budget <= 0:
                raise ValueError(
                    f"objective {name} has zero error budget — a single "
                    "bad event would be an infinite burn; relax the target"
                )
        return out


def classify(config: SLOConfig, *, status: str,
             ttft: Optional[float] = None,
             tpot: Optional[float] = None) -> Dict[str, bool]:
    """One event's per-objective bad flags (shared with check_slo.py).

    Latency objectives only judge events that HAVE the measurement
    (a request that never produced a token has no TTFT — its failure is
    the availability objective's business, and double-counting it as a
    latency breach would overstate burn)."""
    flags: Dict[str, bool] = {}
    if config.ttft_p99_s is not None and ttft is not None:
        flags["ttft_p99"] = ttft > config.ttft_p99_s
    if config.tpot_p99_s is not None and tpot is not None:
        flags["tpot_p99"] = tpot > config.tpot_p99_s
    if config.error_rate is not None:
        flags["error_rate"] = status == "error"
    if config.availability is not None:
        flags["availability"] = status not in OK_STATUSES
    return flags


class SLOWatchdog:
    """Rolling-window burn-rate evaluation with per-objective alerts."""

    def __init__(self, config: SLOConfig, *, clock=None,
                 registry=None, tracer=None, telemetry=None,
                 sinks=None, pid: int = ROUTER_PID,
                 tenant: Optional[str] = None) -> None:
        self.config = config
        self.budgets = config.objectives()
        self.tracer = tracer
        self.telemetry = telemetry
        self.registry = registry
        # optional AlertSinks: every trip/resolve edge is also PUSHED
        # (command/webhook/jsonl); evaluate() drives the retry backoff
        self.sinks = sinks
        self.pid = pid
        # tenant-scoped watchdog (TenantSLORegistry member): gauges and
        # edge events carry the tenant label; None keeps the single-
        # watchdog surface byte-identical to before the registry existed
        self.tenant = tenant
        self._labels = {} if tenant is None else {"tenant": tenant}
        # default time source when a caller omits `now`/`t` (the router
        # always passes its own clock reading explicitly — same domain)
        self._now = _resolve_clock(clock)
        # (t, {objective: bad}) — pruned past the slow window
        self._events: deque = deque()
        # evaluation is O(events-in-slow-window) per objective, and the
        # router calls evaluate() every tick: throttle the rescan to 5%
        # of the fast window (detection latency <= interval, cost
        # amortized). Callers that need an immediate verdict (tests,
        # edge-of-window assertions) pass force=True.
        self._eval_interval = config.fast_window_s / 20.0
        self._last_eval: Optional[float] = None
        self._last_report: Dict[str, dict] = {}
        self.alerts: Dict[str, bool] = {o: False for o in self.budgets}
        # (t, "trip"|"resolve", objective) history — tests and reports
        self.alert_log: List[Tuple[float, str, str]] = []
        self._alerts_ctr = (
            registry.counter("slo_alerts_total")
            if registry is not None else None
        )

    # ------------------------------------------------------------ intake
    def observe(self, completion) -> None:
        """Feed one scheduler/router Completion."""
        self.observe_event(
            t=completion.finish, status=completion.status,
            ttft=completion.ttft, tpot=completion.tpot,
        )

    def observe_event(self, *, t: Optional[float] = None,
                      status: str = "eos",
                      ttft: Optional[float] = None,
                      tpot: Optional[float] = None) -> None:
        """Generic event intake — the train loop feeds step outcomes
        through here (an anomalous step is status="error"). `t`
        defaults to the injected clock."""
        flags = classify(self.config, status=status, ttft=ttft, tpot=tpot)
        if flags:
            self._events.append(
                (t if t is not None else self._now(), flags)
            )

    # -------------------------------------------------------- evaluation
    def _window_burn(self, objective: str, now: float,
                     window_s: float) -> Tuple[float, int]:
        """(burn rate, events judged) for one objective over one window."""
        lo = now - window_s
        total = bad = 0
        for t, flags in self._events:
            if t <= lo or objective not in flags:
                continue
            total += 1
            bad += flags[objective]
        if total == 0:
            return 0.0, 0
        return (bad / total) / self.budgets[objective], total

    def evaluate(self, now: Optional[float] = None,
                 force: bool = False) -> Dict[str, dict]:
        """Prune, recompute both windows per objective, walk the alert
        state machine; returns the per-objective burn report. `now`
        defaults to the injected clock. Called more often than the
        throttle interval, it returns the cached report (see
        `_eval_interval`) unless `force`."""
        if now is None:
            now = self._now()
        if (not force and self._last_eval is not None
                and now - self._last_eval < self._eval_interval):
            if self.sinks is not None:
                self.sinks.flush(now)   # retry backoffs ride the tick
            return self._last_report
        self._last_eval = now
        cfg = self.config
        lo = now - cfg.slow_window_s
        while self._events and self._events[0][0] <= lo:
            self._events.popleft()
        report: Dict[str, dict] = {}
        for objective in self.budgets:
            fast, n_fast = self._window_burn(
                objective, now, cfg.fast_window_s)
            slow, n_slow = self._window_burn(
                objective, now, cfg.slow_window_s)
            active = self.alerts[objective]
            if (not active and n_fast >= cfg.min_events
                    and fast >= cfg.trip_burn and slow >= cfg.trip_burn):
                self._edge(objective, "trip", now, fast, slow)
                active = True
            elif active and slow <= cfg.resolve_burn:
                self._edge(objective, "resolve", now, fast, slow)
                active = False
            self.alerts[objective] = active
            report[objective] = {
                "burn_fast": fast, "burn_slow": slow,
                "events_fast": n_fast, "events_slow": n_slow,
                "active": active,
            }
            if self.registry is not None:
                self.registry.gauge(labelled(
                    "slo_burn_rate", objective=objective, window="fast",
                    **self._labels,
                )).set(fast)
                self.registry.gauge(labelled(
                    "slo_burn_rate", objective=objective, window="slow",
                    **self._labels,
                )).set(slow)
                self.registry.gauge(labelled(
                    "slo_alert_active", objective=objective,
                    **self._labels,
                )).set(float(active))
        if self.sinks is not None:
            # both paths flush: a backed-off retry must come due even
            # when every evaluate() lands on the full-evaluation branch
            # (low-rate traffic spaced past the throttle interval)
            self.sinks.flush(now)
        self._last_report = report
        return report

    def _edge(self, objective: str, edge: str, now: float,
              fast: float, slow: float) -> None:
        self.alert_log.append((now, edge, objective))
        if edge == "trip" and self._alerts_ctr is not None:
            self._alerts_ctr.inc()
            if self.tenant is not None and self.registry is not None:
                # per-tenant attribution ALONGSIDE the shared total: a
                # fleet dashboard sums one series, a tenant page reads
                # its own
                self.registry.counter(labelled(
                    "slo_alerts_total", tenant=self.tenant,
                )).inc()
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                f"slo_{edge}" if edge == "resolve" else "slo_alert",
                pid=self.pid, objective=objective,
                burn_fast=round(fast, 3), burn_slow=round(slow, 3),
                **self._labels,
            )
        if self.telemetry is not None:
            self.telemetry.emit(
                "alert", event=edge, objective=objective,
                burn_fast=fast, burn_slow=slow, **self._labels,
            )
        if self.sinks is not None:
            self.sinks.send({
                "kind": "alert", "t": now, "scope": "slo",
                "event": edge, "objective": objective,
                "burn_fast": fast, "burn_slow": slow, **self._labels,
            })

    @property
    def active(self) -> bool:
        """Any objective currently alerting — the router's brown-out
        trigger."""
        return any(self.alerts.values())

    def burn_signal(self) -> dict:
        """The autoscaler's compressed view of the last evaluation:
        worst fast/slow burn across objectives, whether anything is
        alerting, and whether the SLOW window has settled under the
        resolve threshold everywhere. Trip fast rides `active`;
        `resolved` is the scale-DOWN precondition — burn that merely
        dipped out of the fast window is not calm, it is noise."""
        rep = self._last_report or {}
        fast = max((o.get("burn_fast", 0.0) for o in rep.values()),
                   default=0.0)
        slow = max((o.get("burn_slow", 0.0) for o in rep.values()),
                   default=0.0)
        return {
            "burn_fast": fast,
            "burn_slow": slow,
            "active": self.active,
            "resolved": (not self.active
                         and slow <= self.config.resolve_burn),
        }


class TenantSLORegistry:
    """Keyed SLO watchdogs: one error budget per tenant.

    A single fleet-wide watchdog averages a hostile tenant's burn into
    everyone's, so the tenant being starved never pages and the tenant
    doing the starving never stands out. This registry gives each
    tenant its own `SLOWatchdog` (lazily, keyed off `Request.tenant`,
    None folding to the shared "default" tenant), each with its own
    windows, alert edges, and ``slo_burn_rate{tenant,objective}``
    gauges.

    It presents the SAME surface the router consumes from a single
    watchdog — `observe` / `evaluate` / `active` / `burn_signal` — so
    `Router(slo=...)` takes either interchangeably, plus the
    tenant-scoped queries the brown-out needs to shed ONLY the burning
    tenant's work: `is_burning(tenant)` and `burning_tenants()`.

    Cardinality is bounded like the metric label guard: past
    `max_tenants` distinct tenants, newcomers share one "other"
    watchdog (an unbounded hostile tenant-id space must not mint
    unbounded deques and gauge families). Per-tenant objective
    overrides ride `overrides` (e.g. a batch tenant with a relaxed
    TTFT target).
    """

    OVERFLOW = "other"
    DEFAULT_TENANT = "default"

    def __init__(self, config: SLOConfig, *, clock=None, registry=None,
                 tracer=None, telemetry=None, sinks=None,
                 pid: int = ROUTER_PID, max_tenants: int = 64,
                 overrides: Optional[Dict[str, SLOConfig]] = None) -> None:
        self.config = SLOConfig.from_json(config)
        self.overrides = {
            name: SLOConfig.from_json(cfg)
            for name, cfg in (overrides or {}).items()
        }
        self.max_tenants = max_tenants
        self._deps = dict(clock=clock, registry=registry, tracer=tracer,
                          telemetry=telemetry, sinks=sinks, pid=pid)
        self._dogs: Dict[str, SLOWatchdog] = {}

    def _name(self, tenant: Optional[str]) -> str:
        return tenant if tenant is not None else self.DEFAULT_TENANT

    def _key(self, tenant: Optional[str]) -> str:
        name = self._name(tenant)
        if name in self._dogs or len(self._dogs) < self.max_tenants:
            return name
        return self.OVERFLOW

    def watchdog(self, tenant: Optional[str]) -> SLOWatchdog:
        """The tenant's watchdog, created on first sight (or the shared
        overflow dog past the cap)."""
        name = self._key(tenant)
        dog = self._dogs.get(name)
        if dog is None:
            cfg = self.overrides.get(name, self.config)
            dog = SLOWatchdog(cfg, tenant=name, **self._deps)
            self._dogs[name] = dog
        return dog

    # ------------------------------------------------------------ intake
    def observe(self, completion) -> None:
        self.watchdog(getattr(completion, "tenant", None)).observe(
            completion)

    def observe_event(self, *, tenant: Optional[str] = None,
                      **kw) -> None:
        self.watchdog(tenant).observe_event(**kw)

    # -------------------------------------------------------- evaluation
    def evaluate(self, now: Optional[float] = None,
                 force: bool = False) -> Dict[str, dict]:
        """Evaluate every tenant's watchdog; returns
        {tenant: per-objective report}."""
        return {name: dog.evaluate(now, force)
                for name, dog in self._dogs.items()}

    @property
    def active(self) -> bool:
        return any(dog.active for dog in self._dogs.values())

    def is_burning(self, tenant: Optional[str]) -> bool:
        """Whether THIS tenant's budget is alerting — maps through the
        overflow fold (an over-cap tenant answers for the shared
        "other" dog, the price of bounded cardinality) but never
        creates a watchdog."""
        name = self._name(tenant)
        dog = self._dogs.get(name)
        if dog is None and len(self._dogs) >= self.max_tenants:
            dog = self._dogs.get(self.OVERFLOW)
        return dog is not None and dog.active

    def burning_tenants(self) -> List[str]:
        """Tenant names with an active alert — the brown-out's shed
        scope (sorted: deterministic trace attrs and tests)."""
        return sorted(
            name for name, dog in self._dogs.items() if dog.active
        )

    @property
    def alert_log(self) -> List[Tuple[float, str, str, str]]:
        """Merged (t, edge, objective, tenant) history, time-ordered."""
        out = [
            (t, edge, objective, name)
            for name, dog in self._dogs.items()
            for (t, edge, objective) in dog.alert_log
        ]
        out.sort(key=lambda e: e[0])
        return out

    def burn_signal(self) -> dict:
        """The autoscaler's view: WORST burn across tenants (capacity
        decisions answer the most-burning budget), resolved only when
        every tenant's slow window has settled."""
        sigs = [dog.burn_signal() for dog in self._dogs.values()]
        return {
            "burn_fast": max((s["burn_fast"] for s in sigs), default=0.0),
            "burn_slow": max((s["burn_slow"] for s in sigs), default=0.0),
            "active": self.active,
            "resolved": all(s["resolved"] for s in sigs),
        }


# ------------------------------------------------------------- push alerts
@dataclasses.dataclass(frozen=True)
class AlertSinkSpec:
    """One push destination. `kind` is ``command`` (run it, the alert
    JSON on stdin, exit 0 = delivered), ``webhook`` (POST the JSON to
    the URL, 2xx/3xx = delivered), or ``jsonl`` (append one line to the
    file)."""

    kind: str
    target: str
    timeout_s: float = 3.0

    _KINDS = ("command", "webhook", "jsonl")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(
                f"unknown alert sink kind {self.kind!r} "
                f"(one of {self._KINDS})"
            )

    @classmethod
    def parse(cls, text: str) -> "AlertSinkSpec":
        """``kind:target`` — e.g. ``jsonl:/var/log/alerts.jsonl``,
        ``webhook:http://pager.example/hook``, ``command:notify-team``.
        A bare ``http(s)://...`` is a webhook; anything else is
        rejected loudly (a silently-misparsed pager is no pager)."""
        if text.startswith(("http://", "https://")):
            return cls("webhook", text)
        kind, sep, target = text.partition(":")
        if not sep or not target:
            raise ValueError(
                f"alert sink wants kind:target, got {text!r}"
            )
        return cls(kind, target)


class AlertSinks:
    """Fan alert edges out to N sinks — bounded queue, retry backoff,
    dead-sink breaker per sink.

    `send(event)` enqueues on every live sink and attempts delivery;
    `flush(now)` retries sinks whose backoff came due (the SLO
    watchdog's evaluate() drives it, so retries ride the serve tick and
    nothing here owns a thread). Delivery failures back off
    exponentially and, after `max_failures` CONSECUTIVE failures, trip
    the sink's breaker: bulk pending drops (counted), the
    ``alert_sink_dead`` gauge flips, and the serve loop stops paying
    the sink's timeout per edge. Dead is HALF-OPEN, not forever: the
    sink keeps exactly ONE queued edge (always the newest — send() to
    a dead sink replaces it) and re-probes with it every
    `probe_cooldown_s` — a pager that was rebooted, rotated, or had
    its disk freed rejoins on its own instead of staying dead until a
    process restart. `deliver` is injectable so the state machine is
    host-pure testable (the real one shells out / POSTs / appends).
    """

    PENDING_CAP = 64

    def __init__(self, specs, *, clock=None, registry=None,
                 max_failures: int = 5, base_s: float = 0.5,
                 max_s: float = 30.0, seed: int = 0,
                 probe_cooldown_s: float = 30.0,
                 deliver=None) -> None:
        self._now = _resolve_clock(clock)
        self.registry = registry
        self.max_failures = max_failures
        self.base_s = base_s
        self.max_s = max_s
        self.seed = seed
        self.probe_cooldown_s = probe_cooldown_s
        self._deliver_fn = deliver
        self.sinks: List[dict] = []
        for spec in specs:
            if isinstance(spec, str):
                spec = AlertSinkSpec.parse(spec)
            self.sinks.append({
                "spec": spec, "pending": deque(maxlen=self.PENDING_CAP),
                "failures": 0, "next_at": 0.0, "dead": False,
                "delivered": 0, "dropped": 0,
            })

    def _metric(self, kind: str, sink: dict):
        if self.registry is None:
            return None
        # labelled() keys cannot represent "," or "=" (its documented
        # limit — they would shear into fabricated labels at exposition
        # time), and sink targets are operator strings that may carry
        # both (webhook query params, comma-joined command args)
        label = (f"{sink['spec'].kind}:{sink['spec'].target}"
                 .replace(",", "_").replace("=", "_"))
        return self.registry.counter(
            labelled(f"alert_sink_{kind}_total", sink=label)
        ) if kind != "dead" else self.registry.gauge(
            labelled("alert_sink_dead", sink=label)
        )

    # ------------------------------------------------------------ intake
    def send(self, event: dict) -> None:
        now = self._now()
        for s in self.sinks:
            if s["dead"]:
                # a dead sink holds exactly ONE edge for its next
                # half-open probe — the newest (a probe that succeeds
                # should deliver the current state of the world, not a
                # stale alarm); the displaced edge drops, counted
                if s["pending"]:
                    s["dropped"] += len(s["pending"])
                    s["pending"].clear()
                s["pending"].append(dict(event))
                continue
            if len(s["pending"]) == s["pending"].maxlen:
                s["dropped"] += 1  # oldest falls off the bounded deque
            s["pending"].append(dict(event))
        self.flush(now)

    # ---------------------------------------------------------- delivery
    def flush(self, now: Optional[float] = None) -> int:
        """Attempt delivery on every live sink whose backoff is due;
        returns events delivered this call."""
        now = self._now() if now is None else now
        delivered = 0
        for s in self.sinks:
            if not s["pending"] or now < s["next_at"]:
                continue
            if s["dead"]:
                # half-open probe: ONE attempt with the kept edge.
                # Success closes the breaker (failures reset, gauge
                # clears — the sink is a normal live sink again);
                # failure re-arms the fixed cool-down, never the
                # exponential schedule (a 30 s heartbeat against a
                # maybe-back pager, not a retry storm).
                if self._try_deliver(s["spec"], s["pending"][0]):
                    s["pending"].popleft()
                    s["dead"] = False
                    s["failures"] = 0
                    s["delivered"] += 1
                    delivered += 1
                    m = self._metric("delivered", s)
                    if m is not None:
                        m.inc()
                    g = self._metric("dead", s)
                    if g is not None:
                        g.set(0)
                else:
                    s["next_at"] = now + self.probe_cooldown_s
                continue
            while s["pending"]:
                ev = s["pending"][0]
                if self._try_deliver(s["spec"], ev):
                    s["pending"].popleft()
                    s["failures"] = 0
                    s["delivered"] += 1
                    delivered += 1
                    m = self._metric("delivered", s)
                    if m is not None:
                        m.inc()
                    continue
                s["failures"] += 1
                m = self._metric("failures", s)
                if m is not None:
                    m.inc()
                if s["failures"] >= self.max_failures:
                    # the dead-sink breaker: bulk pending drops so the
                    # serve loop stops paying this sink's timeout per
                    # edge — but ONE edge (the newest) stays queued for
                    # the half-open probe after `probe_cooldown_s`
                    s["dead"] = True
                    keep = s["pending"][-1]
                    s["dropped"] += len(s["pending"]) - 1
                    s["pending"].clear()
                    s["pending"].append(keep)
                    s["next_at"] = now + self.probe_cooldown_s
                    g = self._metric("dead", s)
                    if g is not None:
                        g.set(1)
                else:
                    s["next_at"] = now + backoff_delay(
                        s["failures"] - 1, base_s=self.base_s,
                        max_s=self.max_s, seed=self.seed,
                    )
                break
        return delivered

    def _try_deliver(self, spec: AlertSinkSpec, event: dict) -> bool:
        try:
            if self._deliver_fn is not None:
                return bool(self._deliver_fn(spec, event))
            return _deliver_real(spec, event)
        except Exception:
            return False

    # --------------------------------------------------------- observing
    @property
    def any_alive(self) -> bool:
        return any(not s["dead"] for s in self.sinks)

    def state(self) -> List[dict]:
        return [
            {"sink": f"{s['spec'].kind}:{s['spec'].target}",
             "dead": s["dead"], "failures": s["failures"],
             "pending": len(s["pending"]),
             "delivered": s["delivered"], "dropped": s["dropped"]}
            for s in self.sinks
        ]


def _deliver_real(spec: AlertSinkSpec, event: dict) -> bool:
    """The three transports. Failures return False (or raise — the
    caller treats both as a failed attempt)."""
    line = json.dumps(event)
    if spec.kind == "jsonl":
        with open(spec.target, "a") as f:
            f.write(line + "\n")
        return True
    if spec.kind == "webhook":
        from ddp_practice_tpu_torch.utils.http_post import post_json

        return post_json(spec.target, line, timeout_s=spec.timeout_s)
    if spec.kind == "command":
        import shlex
        import subprocess

        r = subprocess.run(
            shlex.split(spec.target), input=line + "\n",
            capture_output=True, text=True, timeout=spec.timeout_s,
        )
        return r.returncode == 0
    return False


class FleetAlerts:
    """Fleet-level alert edges from the federated health verdict.

    The SLO watchdog judges request outcomes; this judges the FLEET —
    the ScrapeFederator's per-worker status (healthy / degraded /
    stale / dead). Feed it each federated healthz body (`observe`):
    a worker leaving ``healthy`` raises a trip edge (objective
    ``worker_dead`` / ``worker_stale`` / ...), its return a resolve —
    through the same sinks/tracer/telemetry/counter paths as SLO
    edges, so a dead worker pages exactly like a burning SLO. Host-pure
    (callers do the scraping; tests feed dicts).
    """

    def __init__(self, sinks: Optional[AlertSinks] = None, *,
                 tracer=None, telemetry=None, registry=None,
                 clock=None, pid: int = ROUTER_PID) -> None:
        self.sinks = sinks
        self.tracer = tracer
        self.telemetry = telemetry
        self.pid = pid
        self._now = _resolve_clock(clock)
        self._last: Dict[str, str] = {}
        self.alert_log: List[Tuple[float, str, str, str]] = []
        self._ctr = (registry.counter("fleet_alerts_total")
                     if registry is not None else None)

    def observe(self, healthz: dict,
                now: Optional[float] = None) -> List[dict]:
        """Fold one federated /healthz body in; returns the edge events
        raised (empty when nothing changed)."""
        now = self._now() if now is None else now
        edges: List[dict] = []
        for wid, w in (healthz.get("workers") or {}).items():
            wid = str(wid)
            status = str(w.get("status", "dead")).lower()
            prev = self._last.get(wid, "healthy")
            if status == prev:
                continue
            self._last[wid] = status
            if status != "healthy":
                edges.append({"event": "trip",
                              "objective": f"worker_{status}",
                              "worker": wid})
            if prev != "healthy":
                # whatever it was before has ended — resolve it even
                # when moving between two bad states (stale -> dead),
                # so trips and resolves always pair per objective
                edges.append({"event": "resolve",
                              "objective": f"worker_{prev}",
                              "worker": wid})
        for e in edges:
            self.alert_log.append(
                (now, e["event"], e["objective"], e["worker"])
            )
            if e["event"] == "trip" and self._ctr is not None:
                self._ctr.inc()
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.instant(
                    ("fleet_alert" if e["event"] == "trip"
                     else "fleet_resolve"),
                    pid=self.pid, objective=e["objective"],
                    worker=e["worker"],
                )
            if self.telemetry is not None:
                self.telemetry.emit("alert", **e)
            if self.sinks is not None:
                self.sinks.send({"kind": "alert", "t": now,
                                 "scope": "fleet", **e})
        if self.sinks is not None:
            self.sinks.flush(now)
        return edges
