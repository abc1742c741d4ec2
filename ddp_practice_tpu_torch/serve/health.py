"""Per-replica health: HEALTHY/DEGRADED/DEAD with a circuit breaker.

(Host-pure Python: a copy of ddp_practice_tpu/serve/health.py with its
imports pointed at the port's backoff: the port imports nothing of the
reference package.)

The serving mirror of train/elastic.py's fail-fast stance. A replica in
a fleet can fail three ways with three different right answers:

- a single bad completion (non-finite logits, injected admission
  failure) — keep routing to it but PREFER its peers (DEGRADED): one
  NaN is a request problem until it repeats;
- repeated consecutive failures — stop routing entirely (DEAD, breaker
  OPEN): the replica is burning requests, and every one routed there is
  a user-visible retry;
- a crash / hung dispatch — instant DEAD: there is nothing to degrade
  to, the in-flight work must migrate NOW (serve/router.py failover).

Recovery is half-open probing: after an exponentially-backed-off wait
(utils/backoff.py — the same helper the restart driver and the router's
retry budget use) the router asks the replica whether it is reachable
again; one successful probe closes the breaker, a failed probe doubles
the wait. Time is injected (the scheduler's clock domain), so breaker
timelines replay deterministically under FakeClock in the chaos tests.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from ddp_practice_tpu_torch.utils.backoff import backoff_delay


class HealthState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    # consecutive failures that trip the breaker (a crash trips instantly
    # regardless — see ReplicaHealth.mark_dead)
    trip_after: int = 3
    # half-open probe schedule: probe_base_s, then *factor per failed
    # probe, capped at probe_max_s; jittered per (seed, attempt)
    probe_base_s: float = 0.05
    probe_factor: float = 2.0
    probe_max_s: float = 5.0
    probe_jitter: float = 0.0
    seed: int = 0


class CircuitBreaker:
    """Consecutive-failure trip + exponential-backoff half-open probe.

    Pure host-side state machine in an injected clock domain: callers
    pass `now` explicitly (the router owns the clock), nothing here
    reads wall time.
    """

    def __init__(self, config: BreakerConfig = BreakerConfig()) -> None:
        self.config = config
        self.consecutive_failures = 0
        self.open = False
        self.probe_attempts = 0      # failed probes since the trip
        self.next_probe_at: Optional[float] = None
        self.trips = 0               # lifetime trip count (metrics)

    def _schedule_probe(self, now: float) -> None:
        c = self.config
        self.next_probe_at = now + backoff_delay(
            self.probe_attempts, base_s=c.probe_base_s,
            factor=c.probe_factor, max_s=c.probe_max_s,
            jitter=c.probe_jitter, seed=c.seed,
        )

    def record_success(self) -> None:
        self.consecutive_failures = 0

    def record_failure(self, now: float) -> bool:
        """Count one failure; returns True when this one trips the
        breaker (caller migrates in-flight work exactly once)."""
        self.consecutive_failures += 1
        if not self.open and (
            self.consecutive_failures >= self.config.trip_after
        ):
            self.trip(now)
            return True
        return False

    def trip(self, now: float) -> None:
        """Open immediately (crash path) and schedule the first probe."""
        self.open = True
        self.probe_attempts = 0
        self.trips += 1
        self._schedule_probe(now)

    def probe_due(self, now: float) -> bool:
        return self.open and self.next_probe_at is not None \
            and now >= self.next_probe_at

    def on_probe(self, ok: bool, now: float) -> None:
        """Half-open verdict: one good probe closes; a bad one doubles
        the wait (backoff attempt count advances)."""
        if ok:
            self.open = False
            self.consecutive_failures = 0
            self.probe_attempts = 0
            self.next_probe_at = None
        else:
            self.probe_attempts += 1
            self._schedule_probe(now)


class ReplicaHealth:
    """The router's view of one replica: breaker + three-state summary."""

    def __init__(self, config: BreakerConfig = BreakerConfig()) -> None:
        self.breaker = CircuitBreaker(config)

    @property
    def state(self) -> HealthState:
        if self.breaker.open:
            return HealthState.DEAD
        if self.breaker.consecutive_failures > 0:
            return HealthState.DEGRADED
        return HealthState.HEALTHY

    @property
    def alive(self) -> bool:
        return not self.breaker.open

    def mark_success(self) -> None:
        self.breaker.record_success()

    def mark_failure(self, now: float) -> bool:
        """One error-ish event (bad completion, failed admit). True when
        the breaker just tripped — the replica is now DEAD."""
        return self.breaker.record_failure(now)

    def mark_dead(self, now: float) -> None:
        """Crash: skip the consecutive-failure count, trip instantly."""
        if not self.breaker.open:
            self.breaker.trip(now)

    def probe_due(self, now: float) -> bool:
        return self.breaker.probe_due(now)

    def on_probe(self, ok: bool, now: float) -> None:
        self.breaker.on_probe(ok, now)
