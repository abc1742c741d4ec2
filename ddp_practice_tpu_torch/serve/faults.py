"""Deterministic fault injection for the serving fleet.

(Host-pure Python: a copy of ddp_practice_tpu/serve/faults.py; the port
imports nothing of the reference package.) The kinds `crash`, `latency`,
`nan_logits` and `admit_fail` act through the scheduler's fault hook;
`kill` and `FleetFaultDriver` drive the worker fleet: the supervisor
(serve/supervisor.py) delivers the signals to live worker processes.

Fault tolerance that is only exercised by real outages is untested code.
This module makes failures a first-class, REPLAYABLE input: a FaultPlan
is a list of (replica, tick, kind) events, serialized as JSON so the
same plan drives a pytest chaos trace, a `cli.py serve --fault-plan`
run, and a goodput-under-faults bench row identically.

Kinds (each one real failure the fleet must survive):

- ``crash``      — the replica process dies at tick N (raises
  ReplicaCrashed out of Scheduler.step). `down_s` > 0 makes it
  restartable after that much clock time (the router's half-open probe
  finds it alive again); `down_s` 0 = gone for good.
- ``latency``    — one tick stalls `delay_s` (a GC pause, a preempted
  host, a slow collective): virtual clocks advance, real clocks sleep.
- ``nan_logits`` — slot `slot`'s next sampling input is poisoned with
  NaN (the numerical failure a bf16 overflow produces). The engine's
  per-slot finite-logits flag (serve/engine.py) must contain it to that
  one request.
- ``admit_fail`` — the next admission attempt AT OR AFTER this tick
  fails (OOM / transient allocator error): the failure is armed at the
  planned tick and STICKY until an admission actually consumes it, so a
  plan cannot silently miss because the queue happened to be empty that
  tick. The scheduler finishes the victim with status "error" and the
  router retries it elsewhere.
- ``kill`` — a REAL signal (`sig`: SIGKILL / SIGSTOP / SIGTERM) to a
  live worker OS process at `at_s` clock seconds into the run. Unlike
  the simulated kinds above, this one is not injected into a
  scheduler: the fleet-side `FleetFaultDriver` delivers it through the
  supervisor (serve/supervisor.py) to the replica's current pid. The
  sim `crash` path stays for FakeClock determinism; `kill` is the one
  that proves the failover story against actual process death
  (SIGKILL: no goodbye, in-flight decode lost; SIGSTOP: the process is
  alive but silent — the stale-heartbeat detection path).

Wiring: the injector is an optional `fault_hook` on Scheduler — one
`is not None` check per tick when unset, so the production path pays
nothing. Ticks are per-replica scheduler ticks (deterministic under
FakeClock); crash windows are measured in clock seconds so a downed
replica's recovery interacts with the breaker's probe backoff. ``kill``
specs are ignored by `injector()` — they target processes, not
schedulers — and fire from `FleetFaultDriver.poll` instead.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import List, Optional, Sequence


class ReplicaCrashed(RuntimeError):
    """Raised out of Scheduler.step when an injected crash fires."""


_KINDS = ("crash", "latency", "nan_logits", "admit_fail", "kill")
_SIGNALS = ("SIGKILL", "SIGSTOP", "SIGTERM")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    tick: int = 1            # per-replica scheduler tick (1-based);
    #                          unused by "kill" (which fires on at_s)
    replica: int = 0
    slot: int = 0            # nan_logits: which slot to poison
    delay_s: float = 0.0     # latency: stall length
    down_s: float = 0.0      # crash: clock time until probeable again
    #                          (0 = permanent)
    at_s: float = 0.0        # kill: seconds into the run to deliver
    sig: str = "SIGKILL"     # kill: which signal

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if self.tick < 1:
            raise ValueError("tick is 1-based (first Scheduler.step)")
        if self.kind == "kill" and self.sig not in _SIGNALS:
            raise ValueError(f"kill signal must be one of {_SIGNALS}, "
                             f"got {self.sig!r}")


class FaultPlan:
    """An ordered, serializable set of FaultSpecs for a whole fleet."""

    def __init__(self, faults: Sequence[FaultSpec] = ()) -> None:
        self.faults: List[FaultSpec] = list(faults)

    # --------------------------------------------------------------- json
    @classmethod
    def from_json(cls, src: str) -> "FaultPlan":
        """Parse a plan from a JSON string or a path to a JSON file.

        Schema: {"faults": [{"kind": ..., "tick": ..., "replica": ...,
        ...}]} — or a bare list of fault objects.
        """
        text = src
        if not src.lstrip().startswith(("{", "[")):
            # not inline JSON: it must be a file path — a missing file is
            # a missing file, not "malformed JSON" (a mistyped path fed
            # to json.loads would die with a misleading decode error)
            if not os.path.exists(src):
                raise FileNotFoundError(
                    f"fault plan {src!r}: not inline JSON and no such file"
                )
            with open(src) as f:
                text = f.read()
        data = json.loads(text)
        if isinstance(data, dict):
            data = data.get("faults", [])
        return cls([FaultSpec(**item) for item in data])

    def to_json(self) -> str:
        return json.dumps(
            {"faults": [dataclasses.asdict(f) for f in self.faults]}
        )

    # ----------------------------------------------------------- wiring
    def injector(self, replica: int) -> Optional["FaultInjector"]:
        """The per-replica hook, or None (= zero scheduler overhead)
        when no fault in the plan targets this replica. ``kill`` specs
        are excluded — they are delivered to OS processes by the
        fleet-side FleetFaultDriver, not raised inside a scheduler."""
        mine = [f for f in self.faults
                if f.replica == replica and f.kind != "kill"]
        return FaultInjector(mine) if mine else None

    def kills(self) -> List[FaultSpec]:
        """The real-signal specs, in firing order (FleetFaultDriver)."""
        return sorted((f for f in self.faults if f.kind == "kill"),
                      key=lambda f: f.at_s)


class FaultInjector:
    """Per-replica fault_hook driven by the scheduler's own ticks."""

    def __init__(self, faults: Sequence[FaultSpec]) -> None:
        self.faults = sorted(faults, key=lambda f: f.tick)
        self.tick = 0
        self.crashed_until: Optional[float] = None  # None = not crashed;
        #                                             inf = permanent
        self._admit_fails_pending = 0

    def alive(self, now: float) -> bool:
        """Probe answer: has the injected crash window passed?"""
        return self.crashed_until is None or now >= self.crashed_until

    def revive(self) -> None:
        """Called by the router when a probe finds the replica back up
        (the restarted process starts with a clean fault slate for its
        already-fired specs; future-tick specs still apply)."""
        self.crashed_until = None

    def on_tick(self, scheduler) -> None:
        """Top of Scheduler.step. Fires every spec scheduled for this
        tick; a crash raises after the cheaper faults are applied (they
        model pre-crash symptoms)."""
        self.tick += 1
        crash: Optional[FaultSpec] = None
        for f in self.faults:
            if f.tick != self.tick:
                continue
            if f.kind == "latency":
                self._stall(scheduler.clock, f.delay_s)
            elif f.kind == "nan_logits":
                scheduler.engine.poison_slot(f.slot)
            elif f.kind == "admit_fail":
                self._admit_fails_pending += 1
            elif f.kind == "crash":
                crash = f
        if crash is not None:
            now = scheduler.clock.now()
            self.crashed_until = (
                now + crash.down_s if crash.down_s > 0 else math.inf
            )
            raise ReplicaCrashed(
                f"injected crash at tick {self.tick} "
                f"(down_s={crash.down_s})"
            )

    def take_admit_fault(self) -> bool:
        """Consume one pending admission failure (Scheduler._admit).
        Armed faults persist until consumed (see module doc: sticky, so
        an empty queue at the planned tick defers rather than drops)."""
        if self._admit_fails_pending > 0:
            self._admit_fails_pending -= 1
            return True
        return False

    @staticmethod
    def _stall(clock, delay_s: float) -> None:
        advance = getattr(clock, "advance", None)
        if advance is not None:   # FakeClock: virtual stall, no real wait
            advance(delay_s)
        else:
            time.sleep(delay_s)


class FleetFaultDriver:
    """Fires a plan's ``kill`` specs at REAL worker processes.

    `kill_fn(replica, sig_name)` is injected (the supervisor's `kill`,
    which resolves the replica's CURRENT pid — a restarted worker has a
    new one) so the firing logic is host-pure testable. `poll(elapsed)`
    is called from the fleet's drive loop with seconds since the run
    started; each spec fires exactly once, at the first poll at or
    after its `at_s`. Misses are impossible by construction (a late
    poll still fires everything due), which keeps a kill plan as
    replayable as the simulated ones — modulo the OS scheduling the
    run is there to expose.
    """

    def __init__(self, plan: FaultPlan, kill_fn) -> None:
        self.pending: List[FaultSpec] = plan.kills()
        self.kill_fn = kill_fn
        self.fired: List[FaultSpec] = []

    def poll(self, elapsed_s: float) -> List[FaultSpec]:
        """Deliver every not-yet-fired kill with at_s <= elapsed_s;
        returns the specs fired by THIS poll."""
        fired_now: List[FaultSpec] = []
        while self.pending and self.pending[0].at_s <= elapsed_s:
            spec = self.pending.pop(0)
            self.kill_fn(spec.replica, spec.sig)
            fired_now.append(spec)
        self.fired.extend(fired_now)
        return fired_now

    @property
    def done(self) -> bool:
        return not self.pending
