"""Weighted-fair service accounting + per-tenant cost metering.

(Host-pure Python: a copy of ddp_practice_tpu/serve/fairshare.py with
its imports pointed at the port's registry: the port imports nothing of
the reference package.)

The tenant label rides every seam (scheduler -> router -> RPC ->
worker), the admission layer can refuse one, and the SLO plane can now
burn one's budget — but none of those answers the operational question
a shared fleet actually poses: WHO is consuming the capacity, and is
the split fair? This module holds the two ledgers that answer it:

- **VirtualTokenCounter** — VTC-style weighted service accounting
  ("Fairness in Serving Large Language Models", OSDI'24): each tenant
  accrues ``decode_tokens + prefill_weight * prefill_tokens`` of
  service, normalized by its configured weight. Prefill is discounted
  because a prefill token costs one parallel pass over the prompt while
  a decode token costs a full serial step — charging them equally would
  let a chatty short-prompt tenant starve a long-prompt one. The
  counters drive BOTH enforcement points: the scheduler picks the
  least-served tenant's head when slots free up, and the admission
  layer refuses the most-over-served tenant first under pressure. A
  tenant arriving late (or idle long enough to be forgotten) registers
  at the current FLOOR (the minimum live counter), per the VTC paper:
  absence must not bank unbounded credit it can spend as a burst that
  starves everyone who stayed.
- **TenantLedger** — per-tenant cost metering folded from completion
  flight records: queue/prefill/decode/stall seconds, prompt + output +
  prefix-hit tokens, terminal statuses, and rolling TTFT/TPOT windows
  summarized through the shared ``percentile_summary``. `report()` is
  the ``/tenants`` endpoint body; like ``FlightStats.report`` it ships
  raw sample tails so ``ScrapeFederator.tenants()`` can pool them and
  recompute TRUE fleet percentiles (a percentile of per-worker
  percentiles would be a different, wrong number).

Fairness is summarized as Jain's index over the per-tenant weighted
service totals: 1.0 = perfectly even, 1/n = one tenant took everything.
Exported as the ``tenant_fairness_index`` gauge and paged on by
tools/check_fleet.py ``--min-fairness``.

Host-pure and lock-guarded (the serve loop writes, the HTTP scrape
thread reads); nothing here touches the device or owns a thread.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional

import threading

from ddp_practice_tpu_torch.utils.metrics import labelled, percentile_summary

# the display/accounting name for requests that carry no tenant label —
# shared with the SLO registry so "the unlabeled tenant" is one tenant
# everywhere, not a None that each consumer renders differently
DEFAULT_TENANT = "default"


def tenant_name(tenant: Optional[str]) -> str:
    return tenant if tenant is not None else DEFAULT_TENANT


def jains_index(values: Iterable[float]) -> float:
    """Jain's fairness index: (sum x)^2 / (n * sum x^2) in (0, 1].

    1.0 when every tenant received equal (weighted) service, 1/n when
    one tenant took everything. Empty or all-zero input is vacuously
    fair (nobody was served, nobody was starved) -> 1.0.
    """
    vals = [float(v) for v in values]
    if not vals:
        return 1.0
    total = sum(vals)
    sq = sum(v * v for v in vals)
    if sq <= 0.0:
        return 1.0
    return (total * total) / (len(vals) * sq)


class VirtualTokenCounter:
    """Per-tenant weighted service counters (the VTC of OSDI'24).

    `charge()` accrues service; `least_served` / `most_over_served`
    are the two enforcement queries (dispatch picks the former's work,
    admission refuses the latter's under pressure). Ties break on the
    tenant name so replays are deterministic regardless of dict order.
    """

    def __init__(self, *, prefill_weight: float = 0.5,
                 weights: Optional[Dict[str, float]] = None) -> None:
        if prefill_weight < 0:
            raise ValueError("prefill_weight must be >= 0")
        self.prefill_weight = prefill_weight
        # tenant -> relative share weight (default 1.0): a weight-2
        # tenant accrues service at half rate, so fair ordering grants
        # it twice the tokens — paid tiers without a second mechanism
        self.weights = dict(weights or {})
        for name, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"tenant {name!r} weight must be > 0")
        self._lock = threading.Lock()
        self._service: Dict[str, float] = {}

    def _weight(self, name: str) -> float:
        return self.weights.get(name, 1.0)

    def _register(self, name: str) -> None:
        # VTC lift: newcomers start at the current floor, not at zero —
        # an idle hour must not become a service credit that lets one
        # tenant monopolize the fleet until the books "catch up"
        if name not in self._service:
            self._service[name] = min(self._service.values(), default=0.0)

    def touch(self, tenant: Optional[str]) -> None:
        """Register a tenant at the current service floor (first
        sighting — queue intake, admission) without charging it."""
        with self._lock:
            self._register(tenant_name(tenant))

    def charge(self, tenant: Optional[str], *, decode: int = 0,
               prefill: int = 0) -> float:
        """Accrue one attempt's weighted service; returns the tenant's
        new counter. Decode tokens at full price, prefill tokens at
        `prefill_weight` (see module docstring)."""
        name = tenant_name(tenant)
        cost = (float(decode) + self.prefill_weight * float(prefill))
        with self._lock:
            self._register(name)
            self._service[name] += cost / self._weight(name)
            return self._service[name]

    def service(self, tenant: Optional[str]) -> float:
        with self._lock:
            return self._service.get(tenant_name(tenant), 0.0)

    def least_served(self, tenants: Iterable[Optional[str]]
                     ) -> Optional[str]:
        """The candidate tenant with the LOWEST weighted service — the
        one fair dispatch serves next. Returns the name as given
        (None stays None so callers can match raw request labels)."""
        best = None
        best_key = None
        with self._lock:
            for t in tenants:
                key = (self._service.get(tenant_name(t), 0.0),
                       tenant_name(t))
                if best_key is None or key < best_key:
                    best, best_key = t, key
        return best

    def most_over_served(self, tenants: Iterable[Optional[str]]
                         ) -> Optional[str]:
        """The candidate tenant with the HIGHEST weighted service — the
        one fair admission refuses first under pressure."""
        worst = None
        worst_key = None
        with self._lock:
            for t in tenants:
                key = (self._service.get(tenant_name(t), 0.0),
                       tenant_name(t))
                if worst_key is None or key > worst_key:
                    worst, worst_key = t, key
        return worst

    def jain(self) -> float:
        """Jain's index over every registered tenant's service total."""
        with self._lock:
            return jains_index(self._service.values())

    def snapshot(self) -> dict:
        with self._lock:
            service = dict(self._service)
        total = sum(service.values())
        return {
            "service": service,
            "share": {n: (v / total if total > 0 else 0.0)
                      for n, v in service.items()},
            "fairness_index": jains_index(service.values()),
        }


class TenantLedger:
    """Per-tenant cost meters folded from completions.

    One `on_completion` per terminal (the router's `_finalize` / the
    scheduler's `_finish` in standalone use — exactly one of them owns
    the hook per deployment, like the SLO watchdog). Registry export
    uses labelled() so the 64-value cardinality guard bounds a hostile
    tenant-id space to the shared "other" bucket.
    """

    PHASES = ("queue_s", "prefill_s", "decode_s", "stall_s")
    # raw TTFT/TPOT tail shipped per report for fleet federation —
    # same contract as FlightStats.SAMPLES_PER_REPORT
    SAMPLES_PER_REPORT = 256

    def __init__(self, *, registry=None, vtc: Optional[
            VirtualTokenCounter] = None, window: int = 512) -> None:
        self.registry = registry
        self.vtc = vtc
        self.window = window
        self._lock = threading.Lock()
        self._tenants: Dict[str, dict] = {}

    def _entry(self, name: str) -> dict:
        e = self._tenants.get(name)
        if e is None:
            e = {
                "requests": {},
                "prompt_tokens": 0,
                "output_tokens": 0,
                "prefix_hit_tokens": 0,
                "seconds": {ph: 0.0 for ph in self.PHASES},
                "ttft": deque(maxlen=self.window),
                "tpot": deque(maxlen=self.window),
            }
            self._tenants[name] = e
        return e

    def on_completion(self, completion, *, prompt_tokens: int = 0,
                      **_kw) -> None:
        """Fold one terminal completion in. `prompt_tokens` comes from
        the caller when it still holds the request (the router's
        _finalize does); otherwise it falls back to the flight record's
        prompt_tokens stamp (the scheduler's, so a worker-side ledger
        with no request back-pointer still bills prefill)."""
        name = tenant_name(getattr(completion, "tenant", None))
        flight = completion.flight or {}
        if not prompt_tokens:
            prompt_tokens = int(flight.get("prompt_tokens", 0) or 0)
        out_tokens = len(completion.tokens)
        hit = int(flight.get("prefix_hit_tokens", 0) or 0)
        with self._lock:
            e = self._entry(name)
            e["requests"][completion.status] = (
                e["requests"].get(completion.status, 0) + 1
            )
            e["prompt_tokens"] += int(prompt_tokens)
            e["output_tokens"] += out_tokens
            e["prefix_hit_tokens"] += hit
            for ph in self.PHASES:
                e["seconds"][ph] += float(flight.get(ph, 0.0) or 0.0)
            if completion.ttft is not None:
                e["ttft"].append(completion.ttft)
            if completion.tpot is not None:
                e["tpot"].append(completion.tpot)
        reg = self.registry
        if reg is not None:
            reg.counter(labelled("tenant_requests_total", tenant=name,
                                 status=completion.status)).inc()
            if prompt_tokens:
                reg.counter(labelled("tenant_prompt_tokens_total",
                                     tenant=name)).inc(prompt_tokens)
            if out_tokens:
                reg.counter(labelled("tenant_output_tokens_total",
                                     tenant=name)).inc(out_tokens)
            if hit:
                reg.counter(labelled("tenant_prefix_hit_tokens_total",
                                     tenant=name)).inc(hit)
            for ph in self.PHASES:
                v = float(flight.get(ph, 0.0) or 0.0)
                if v > 0:
                    reg.counter(labelled(
                        "tenant_cost_seconds_total", tenant=name,
                        phase=ph)).inc(v)
            if self.vtc is not None:
                reg.gauge("tenant_fairness_index").set(self.vtc.jain())

    def report(self) -> dict:
        """The ``/tenants`` endpoint body: per-tenant counters +
        TTFT/TPOT percentile summaries, service shares from the
        attached VTC, and the fleet-local Jain's index. "samples"
        carries the raw latency tails (ScrapeFederator.tenants pools
        them and recomputes — never percentiles of percentiles)."""
        with self._lock:
            snap = {
                name: {
                    "requests": dict(e["requests"]),
                    "prompt_tokens": e["prompt_tokens"],
                    "output_tokens": e["output_tokens"],
                    "prefix_hit_tokens": e["prefix_hit_tokens"],
                    "seconds": dict(e["seconds"]),
                    "ttft": list(e["ttft"]),
                    "tpot": list(e["tpot"]),
                }
                for name, e in self._tenants.items()
            }
        tenants: Dict[str, dict] = {}
        samples: Dict[str, dict] = {}
        cap = self.SAMPLES_PER_REPORT
        for name, e in sorted(snap.items()):
            ttft, tpot = e.pop("ttft"), e.pop("tpot")
            e["ttft_s"] = percentile_summary(ttft)
            e["tpot_s"] = percentile_summary(tpot)
            tenants[name] = e
            samples[name] = {"ttft_s": ttft[-cap:], "tpot_s": tpot[-cap:]}
        out: dict = {"tenants": tenants, "samples": samples}
        if self.vtc is not None:
            vs = self.vtc.snapshot()
            out["service"] = vs["service"]
            out["share"] = vs["share"]
            out["fairness_index"] = vs["fairness_index"]
        else:
            # no VTC attached (fair mode off): fairness over raw output
            # tokens — metering must not require the enforcement knob
            service = {n: float(e["output_tokens"])
                       for n, e in snap.items()}
            total = sum(service.values())
            out["service"] = service
            out["share"] = {n: (v / total if total > 0 else 0.0)
                            for n, v in service.items()}
            out["fairness_index"] = jains_index(service.values())
        return out


def federate_tenant_reports(reports: List[dict]) -> dict:
    """Fold per-worker ``/tenants`` bodies into one fleet view: sum the
    counters, pool the raw sample tails and recompute percentiles,
    re-derive shares + Jain over the SUMMED service. Shared by
    ScrapeFederator.tenants() (live) and tools/check_fleet.py
    (snapshots) so both quote the same numbers."""
    tenants: Dict[str, dict] = {}
    pooled: Dict[str, Dict[str, list]] = {}
    service: Dict[str, float] = {}
    for rep in reports:
        if not isinstance(rep, dict):
            continue
        for name, e in (rep.get("tenants") or {}).items():
            agg = tenants.setdefault(name, {
                "requests": {}, "prompt_tokens": 0, "output_tokens": 0,
                "prefix_hit_tokens": 0,
                "seconds": {ph: 0.0 for ph in TenantLedger.PHASES},
            })
            for st, n in (e.get("requests") or {}).items():
                agg["requests"][st] = agg["requests"].get(st, 0) + n
            for key in ("prompt_tokens", "output_tokens",
                        "prefix_hit_tokens"):
                agg[key] += int(e.get(key, 0) or 0)
            for ph in TenantLedger.PHASES:
                agg["seconds"][ph] += float(
                    (e.get("seconds") or {}).get(ph, 0.0) or 0.0)
        for name, s in (rep.get("samples") or {}).items():
            pool = pooled.setdefault(name, {"ttft_s": [], "tpot_s": []})
            for key in ("ttft_s", "tpot_s"):
                vals = s.get(key)
                if isinstance(vals, list):
                    pool[key].extend(vals)
        for name, v in (rep.get("service") or {}).items():
            service[name] = service.get(name, 0.0) + float(v)
    for name, agg in tenants.items():
        pool = pooled.get(name, {})
        agg["ttft_s"] = percentile_summary(pool.get("ttft_s", []))
        agg["tpot_s"] = percentile_summary(pool.get("tpot_s", []))
    total = sum(service.values())
    return {
        "tenants": {n: tenants[n] for n in sorted(tenants)},
        "service": service,
        "share": {n: (v / total if total > 0 else 0.0)
                  for n, v in service.items()},
        "fairness_index": jains_index(service.values()),
    }
