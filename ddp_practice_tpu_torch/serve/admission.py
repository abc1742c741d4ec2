"""Per-tenant admission control for the serving front door.

(Host-pure Python: a copy of ddp_practice_tpu/serve/admission.py with its
imports pointed at the port; the port imports nothing of the
reference package.)

The `Request.tenant` label already rides every seam (scheduler ->
router -> RPC -> worker, trace sampling, SLO attribution); this module
is the knob that makes it mean something at the door: each tenant gets
a token-bucket rate limit plus a concurrent-streams cap, and a request
that exceeds either is refused with a TYPED reason before it touches
the router — a 429 at the door instead of a queue slot a paying tenant
needed.

Token bucket over a leaky counter because burst tolerance is the
point: a tenant allowed 10 rps should be able to send its 10 requests
back-to-back at the top of the second (burst), not be clocked at one
per 100 ms. The bucket refills continuously at `rate_rps` up to
`burst`; each admission spends one token.

Deliberately host-pure and clock-injected (same FakeClock discipline
as the scheduler/router): admission decisions replay deterministically
in tests, and the front door passes its real clock in production.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's admission envelope. `rate_rps <= 0` disables the
    rate check (unlimited); `max_concurrent <= 0` disables the
    concurrency check. `burst` defaults to one second of rate (min 1)
    so a bare rate is usable without tuning."""

    rate_rps: float = 0.0
    burst: Optional[int] = None
    max_concurrent: int = 0

    def bucket_size(self) -> float:
        if self.burst is not None:
            return float(max(1, self.burst))
        return float(max(1.0, self.rate_rps))


class AdmissionController:
    """Thread-safe per-tenant gate: `try_acquire` at intake,
    `release` when the stream ends (any terminal — end frame, shed,
    connection drop). Unknown tenants (and `tenant=None`) fall under
    `default`; `TenantPolicy()` admits everything, so a front door
    built with no policies behaves exactly like one with no admission
    layer at all."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 *, default: TenantPolicy = TenantPolicy(),
                 clock=None, vtc=None,
                 fair_max_inflight: int = 0) -> None:
        self.policies = dict(policies or {})
        self.default = default
        self._clock = clock
        # optional serve/fairshare.py VirtualTokenCounter + pressure
        # threshold: with BOTH set, once total inflight reaches
        # `fair_max_inflight` the door refuses the MOST-OVER-SERVED
        # tenant's requests first (typed reason "fairness") — the VTC
        # paper's admission half. Static rate/concurrency envelopes
        # can't do this: they don't know who already ate the capacity.
        self.vtc = vtc
        self.fair_max_inflight = fair_max_inflight
        self._lock = threading.Lock()
        self._tokens: Dict[str, float] = {}     # bucket fill per tenant
        self._refill_at: Dict[str, float] = {}  # last refill timestamp
        self._inflight: Dict[str, int] = {}
        # cumulative per-reason refusal counts (the front door exports
        # these; kept here so a headless controller is still auditable)
        self.refused: Dict[str, int] = {
            "rate": 0, "concurrency": 0, "fairness": 0,
        }

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None \
            else time.monotonic()

    def policy_for(self, tenant: Optional[str]) -> TenantPolicy:
        if tenant is not None and tenant in self.policies:
            return self.policies[tenant]
        return self.default

    def _fairness_refuses(self, tenant: Optional[str]) -> bool:
        """Under pressure (total inflight >= fair_max_inflight), refuse
        the requester iff it is the MOST-OVER-SERVED tenant among those
        competing (tenants currently inflight, plus itself). Needs at
        least two competing tenants: with one there is no fairness
        question, only capacity — the rate/concurrency envelopes' job.
        Caller holds the lock."""
        if self.vtc is None or self.fair_max_inflight <= 0:
            return False
        if sum(self._inflight.values()) < self.fair_max_inflight:
            return False
        competing = {k or None for k, n in self._inflight.items()
                     if n > 0}
        competing.add(tenant)
        if len(competing) < 2:
            return False
        worst = self.vtc.most_over_served(competing)
        return (worst or "") == (tenant or "")

    def try_acquire(self, tenant: Optional[str]
                    ) -> Tuple[bool, Optional[str]]:
        """(admitted, refusal_reason). Reasons: "fairness" (the
        most-over-served tenant under pressure — see
        `_fairness_refuses`), "rate" (bucket empty) or "concurrency"
        (cap reached). Checks concurrency FIRST, then fairness, so a
        refused tenant does not also burn a rate token for a request
        that was never going to run."""
        pol = self.policy_for(tenant)
        key = tenant or ""
        with self._lock:
            if (pol.max_concurrent > 0
                    and self._inflight.get(key, 0) >= pol.max_concurrent):
                self.refused["concurrency"] += 1
                return False, "concurrency"
            if self._fairness_refuses(tenant):
                self.refused["fairness"] += 1
                return False, "fairness"
            if pol.rate_rps > 0:
                now = self._now()
                size = pol.bucket_size()
                fill = self._tokens.get(key, size)
                last = self._refill_at.get(key, now)
                fill = min(size, fill + (now - last) * pol.rate_rps)
                self._refill_at[key] = now
                if fill < 1.0:
                    self._tokens[key] = fill
                    self.refused["rate"] += 1
                    return False, "rate"
                self._tokens[key] = fill - 1.0
            self._inflight[key] = self._inflight.get(key, 0) + 1
            if self.vtc is not None:
                # register at the current service floor so the first
                # fairness comparison sees this tenant at all
                self.vtc.touch(tenant)
            return True, None

    def release(self, tenant: Optional[str]) -> None:
        """One admitted stream ended. Idempotence is the CALLER's job
        (release once per acquire); the floor-at-zero here only keeps a
        bookkeeping bug from turning into a negative cap that admits
        unboundedly."""
        key = tenant or ""
        with self._lock:
            n = self._inflight.get(key, 0)
            if n > 0:
                self._inflight[key] = n - 1

    def inflight(self, tenant: Optional[str]) -> int:
        with self._lock:
            return self._inflight.get(tenant or "", 0)
