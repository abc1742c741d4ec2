"""Elastic fleet: SLO-driven autoscaling with pre-warmed standbys.

(Host-pure Python: the counterpart of ddp_practice_tpu/serve/autoscaler.py,
wired to the port's router, supervisor, metrics, SLO watchdog and trace
recorder; the port imports nothing of the reference package.)

The sensors are the router's view of the fleet (each replica's load and
decode slots) and serve/slo.py's multi-window burn rates; the actuators
are the supervisor's `grow` (a warm standby, or the cold spawn
pipeline) and `shrink` (the worker's SIGTERM drain). This module closes
the loop:

- **AutoscalerPolicy** — the host-pure control law. Trip FAST on SLO
  burn or queue pressure to scale UP; resolve SLOW (a continuous calm
  window on top of the slow burn window) to scale DOWN; a deadband
  between the two thresholds where nothing moves. After any scale
  event, an event in the OPPOSITE direction is refused for `hold_s`, so
  direction reversals are at least `hold_s` apart by construction (at
  most elapsed/hold_s + 1 of them), and per-direction cooldowns pace
  same-direction steps on top. Every input is an argument and time is a
  parameter, so a FakeClock replays every transition.

- **StandbyPool** — workers spawned AHEAD of demand. A worker is a
  fresh interpreter that imports torch, opens its own CUDA context,
  builds its model and warms its engine before its READY line (PERF.md
  §6 has its boot time on the card), so a cold spawn reacts after a
  short burst is over. The pool keeps `standby_target` workers warm;
  promotion is a probe plus a dispatch join. One background thread
  spawns serially and replenishes after each take; every child is in
  serve/supervisor.py's reaped registry, so a pooled standby can no
  more leak than a fleet worker can.

- **Autoscaler** — the orchestrator the Router ticks (router.step ->
  autoscaler.step, right after the SLO pass). `_grow` promotes a
  standby through `Supervisor.grow(spec, worker=...)` (the cold spawn
  pipeline when the pool is empty) and joins the new RemoteReplicaHandle
  into the router with the breaker arming the router gives every
  replica. `_scale_down` drains the newest RUNNING slot (refuse new
  submits, finish in-flight streams) and retires its handle once the
  process exits; a worker SIGKILLed mid-drain is retired the same way,
  and `Router.remove_handle` salvages what it still held.

Scale events go to the router's trace recorder (instants with their
trigger), its metrics (`fleet_size` / `standby_ready` gauges and
`scale_events_total{direction,trigger}`) and the alert sinks (scope
"autoscale").
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from ddp_practice_tpu_torch.serve.router import ROUTER_PID
from ddp_practice_tpu_torch.serve.scheduler import MonotonicClock
from ddp_practice_tpu_torch.serve.supervisor import (
    RUNNING,
    STOPPED,
    RemoteReplicaHandle,
    Supervisor,
    spawn_worker,
)
from ddp_practice_tpu_torch.serve.worker import WorkerSpec


# ------------------------------------------------------------------ policy
@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    min_size: int = 1
    max_size: int = 4
    # policy evaluation spacing: the "one evaluation window" reaction
    # time is measured against
    eval_interval_s: float = 1.0
    # fleet pressure = demand / decode slots. At or above `up_pressure`
    # the queue outruns the fleet (grow instead of shedding); at or
    # below `down_pressure` a replica is idle weight. Between them is
    # the deadband: nothing moves.
    up_pressure: float = 1.5
    down_pressure: float = 0.5
    # no-reversal window: after ANY scale event, no event in the
    # OPPOSITE direction for this long
    hold_s: float = 10.0
    # pacing of CONSECUTIVE same-direction events: trip fast (short up
    # cooldown), resolve slow (long down cooldown)
    cooldown_up_s: float = 2.0
    cooldown_down_s: float = 15.0
    # scale-down also needs the calm signal (low pressure, slow burn
    # resolved) to have held CONTINUOUSLY this long
    down_stable_s: float = 5.0
    # warm standbys the pool keeps ahead of demand
    standby_target: int = 1

    def __post_init__(self):
        if self.min_size < 1:
            raise ValueError("min_size must be >= 1")
        if self.max_size < self.min_size:
            raise ValueError("max_size must be >= min_size")
        if self.down_pressure >= self.up_pressure:
            raise ValueError(
                "down_pressure must be < up_pressure (the deadband)"
            )


class AutoscalerPolicy:
    """The control law: inputs in, at most one decision out.

    `step()` returns None (throttled / deadband / held / clamped) or a
    decision dict {"t", "direction", "trigger", "size", "pressure"}:

    - throttle: at most one evaluation per `eval_interval_s`;
    - trip fast: SLO burn alerting (`slo_active`) or pressure at or
      above `up_pressure` wants UP, this evaluation;
    - resolve slow: DOWN wants no alert, the slow burn window resolved
      AND pressure at or below `down_pressure`, continuously for
      `down_stable_s`;
    - deadband: neither -> None;
    - no reversal inside `hold_s` of the last event;
    - per-direction cooldown, then the min/max clamp.
    """

    def __init__(self, config: AutoscalerConfig = AutoscalerConfig()
                 ) -> None:
        self.config = config
        self._last_eval = -1e18
        self._last_change_t: Optional[float] = None
        self._last_direction: Optional[str] = None
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        self._calm_since: Optional[float] = None
        self.events: List[dict] = []   # every committed decision

    def _blocked(self, now: float, direction: str) -> bool:
        cfg = self.config
        if (self._last_change_t is not None
                and self._last_direction is not None
                and self._last_direction != direction
                and now - self._last_change_t < cfg.hold_s):
            return True   # a reversal inside the hold window
        last_same = (self._last_up_t if direction == "up"
                     else self._last_down_t)
        cooldown = (cfg.cooldown_up_s if direction == "up"
                    else cfg.cooldown_down_s)
        return last_same is not None and now - last_same < cooldown

    def _commit(self, now: float, direction: str, trigger: str,
                size: int, pressure: float) -> dict:
        self._last_change_t = now
        self._last_direction = direction
        if direction == "up":
            self._last_up_t = now
            # the grow is about to relieve pressure: the calm window
            # re-anchors from scratch instead of inheriting burst samples
            self._calm_since = None
        else:
            self._last_down_t = now
        decision = {
            "t": now, "direction": direction, "trigger": trigger,
            "size": size, "pressure": round(pressure, 4),
        }
        self.events.append(decision)
        return decision

    def step(self, now: float, *, size: int, pressure: float,
             slo_active: bool = False, slo_resolved: bool = True,
             standby_ready: int = 0) -> Optional[dict]:
        cfg = self.config
        if now - self._last_eval < cfg.eval_interval_s:
            return None
        self._last_eval = now
        up_want = slo_active or pressure >= cfg.up_pressure
        calm_now = (not slo_active and slo_resolved
                    and pressure <= cfg.down_pressure)
        if calm_now and not up_want:
            if self._calm_since is None:
                self._calm_since = now
        else:
            self._calm_since = None
        if up_want:
            if size >= cfg.max_size or self._blocked(now, "up"):
                return None
            trigger = "slo_burn" if slo_active else "queue_pressure"
            return self._commit(now, "up", trigger, size, pressure)
        if (self._calm_since is not None
                and now - self._calm_since >= cfg.down_stable_s):
            if size <= cfg.min_size or self._blocked(now, "down"):
                return None
            return self._commit(now, "down", "slo_resolved",
                                size, pressure)
        return None   # deadband, or calm still proving itself


# ------------------------------------------------------------ standby pool
class StandbyPool:
    """Warm workers spawned ahead of demand, by one background thread.

    `provision(rid)` queues one standby build (`spec_fn(rid)` names it);
    the thread spawns serially through serve/supervisor.py's
    `spawn_worker`, so every child is in the reaped registry, and
    finished workers wait warm in FIFO order. `take()` pops the oldest
    (rid, spec, worker) for promotion; `close()` reaps whatever is left.
    `spawn_in_thread=False` makes provision() synchronous (host-pure
    tests)."""

    def __init__(self, spec_fn: Callable[[int], WorkerSpec], *,
                 spawn_fn: Optional[Callable] = None,
                 spawn_in_thread: bool = True) -> None:
        self.spec_fn = spec_fn
        self.spawn_fn = spawn_fn or spawn_worker
        self.spawn_in_thread = spawn_in_thread
        self._lock = threading.Lock()
        self._queue: List[int] = []        # rids awaiting a spawn
        self._ready: List[tuple] = []      # (rid, spec, worker), FIFO
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.spawned_total = 0
        self.spawn_errors: List[tuple] = []   # (rid, repr(exc))

    # ------------------------------------------------------------ intake
    def provision(self, rid: int) -> None:
        """Queue one standby build for a pre-assigned replica id."""
        with self._lock:
            if self._closed:
                return
            self._queue.append(rid)
            if self.spawn_in_thread and (
                    self._thread is None or not self._thread.is_alive()):
                self._thread = threading.Thread(
                    target=self._drain_queue, name="standby-pool",
                    daemon=True)
                self._thread.start()
        if not self.spawn_in_thread:
            self._drain_queue()

    def _drain_queue(self) -> None:
        while True:
            with self._lock:
                if self._closed or not self._queue:
                    return
                rid = self._queue.pop(0)
            spec = self.spec_fn(rid)
            try:
                worker = self.spawn_fn(spec)
            except BaseException as e:   # noqa: BLE001 (a ledger entry)
                with self._lock:
                    self.spawn_errors.append((rid, repr(e)))
                continue
            with self._lock:
                if self._closed:
                    worker.reap()
                    return
                self._ready.append((rid, spec, worker))
                self.spawned_total += 1

    # ----------------------------------------------------------- consume
    @property
    def ready_count(self) -> int:
        with self._lock:
            return len(self._ready)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._queue)

    def take(self) -> Optional[tuple]:
        """Pop the oldest warm standby, (rid, spec, worker); None when
        nothing is ready (the caller falls back to a cold spawn)."""
        with self._lock:
            if not self._ready:
                return None
            return self._ready.pop(0)

    def wait_ready(self, timeout_s: float = 300.0,
                   n: int = 1) -> bool:
        """Block until >= n standbys are warm (a bench's pre-warm
        barrier); False on timeout or a closed pool."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._closed:
                    return False
                if len(self._ready) >= n:
                    return True
                if not self._queue and (
                        self._thread is None
                        or not self._thread.is_alive()):
                    return len(self._ready) >= n
            time.sleep(0.02)
        return False

    def close(self) -> None:
        """Reap every pooled standby and refuse further provisioning.
        A spawn in flight is reaped by the thread when it finishes."""
        with self._lock:
            self._closed = True
            self._queue.clear()
            ready, self._ready = self._ready, []
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        for _rid, _spec, worker in ready:
            worker.reap()


# ------------------------------------------------------------ orchestrator
class Autoscaler:
    """Policy decisions -> supervisor and router actuation.

    Ticked by Router.step (set `router.autoscaler = this`) right after
    the SLO pass. Owns the replica-id counter (ids only increase across
    scale events, pool pre-assignments included) and the drain ledger
    that retires a shrunk handle from the router once its process is
    gone."""

    def __init__(self, router, supervisor: Supervisor,
                 base_spec: WorkerSpec, *,
                 config: AutoscalerConfig = AutoscalerConfig(),
                 clock=None,
                 pool: Optional[StandbyPool] = None,
                 tracer=None, sinks=None,
                 handle_factory: Optional[Callable] = None,
                 heartbeat_timeout_s: float = 2.0,
                 spawn_fn: Optional[Callable] = None,
                 spawn_in_thread: bool = True) -> None:
        self.router = router
        self.supervisor = supervisor
        self.base_spec = base_spec
        self.config = config
        self.clock = clock or getattr(router, "clock", None) \
            or MonotonicClock()
        self.policy = AutoscalerPolicy(config)
        # scale events share the timeline of the dispatches they
        # reshape: the router's recorder by default
        self.tracer = tracer if tracer is not None \
            else getattr(router, "tracer", None)
        self.sinks = sinks
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._handle_factory = handle_factory or self._default_handle
        self._next_replica = len(supervisor.specs)
        self.pool = pool or StandbyPool(
            self._spec_for, spawn_fn=spawn_fn,
            spawn_in_thread=spawn_in_thread,
        )
        self.events: List[dict] = []     # actuated scale events
        self._draining: Dict[int, object] = {}   # slot -> handle
        self.drain_log: List[dict] = []
        # one row per policy evaluation (after the throttle): the signal
        # the control law saw, to place each scale event against it
        self.pressure_log: List[dict] = []
        self.last_join_s: Optional[float] = None
        for _ in range(config.standby_target):
            self.pool.provision(self._alloc_rid())

    # ------------------------------------------------------------ plumbing
    def _alloc_rid(self) -> int:
        rid = self._next_replica
        self._next_replica += 1
        return rid

    def _spec_for(self, rid: int) -> WorkerSpec:
        return dataclasses.replace(self.base_spec, replica=rid)

    def _default_handle(self, slot: int, spec: WorkerSpec):
        return RemoteReplicaHandle(
            slot, self.supervisor, spec, clock=self.clock,
            heartbeat_timeout_s=self.heartbeat_timeout_s,
            trace_collector=getattr(self.router, "trace_collector",
                                    None),
        )

    def _pressure(self) -> float:
        """Demand per decode slot over the dispatchable fleet: the
        signal Router._update_brownout reads, except that `load` (which
        counts submits still in flight to a replica) stands in for the
        heartbeat-lagged queue + active pair, and draining replicas
        count for neither work nor capacity."""
        slots = 0
        work = 0.0
        for h in self.router.handles:
            if not h.health.alive:
                continue
            if getattr(h, "_drain_requested", False):
                continue
            slots += h.max_slots
            work += h.load
        return (work / slots) if slots else float("inf")

    def _emit(self, now: float, event: dict) -> None:
        self.events.append(event)
        metrics = getattr(self.router, "metrics", None)
        if metrics is not None:
            metrics.on_scale_event(event["direction"], event["trigger"])
        if self.tracer is not None and self.tracer.enabled:
            attrs = {k: v for k, v in event.items() if k != "t"}
            self.tracer.instant(
                f"scale_{event['direction']}", pid=ROUTER_PID, **attrs
            )
        if self.sinks is not None:
            self.sinks.send(dict(event, kind="alert", t=now,
                                 scope="autoscale",
                                 event=f"scale_{event['direction']}"))

    # ---------------------------------------------------------------- tick
    def step(self, now: Optional[float] = None) -> Optional[dict]:
        now = self.clock.now() if now is None else now
        self._retire_drained(now)
        size = self.supervisor.active_slots()
        slo = getattr(self.router, "slo", None)
        if slo is not None:
            sig = slo.burn_signal()
            slo_active = bool(sig["active"])
            slo_resolved = bool(sig["resolved"])
        else:
            slo_active, slo_resolved = False, True
        pressure = self._pressure()
        decision = self.policy.step(
            now, size=size, pressure=pressure,
            slo_active=slo_active, slo_resolved=slo_resolved,
            standby_ready=self.pool.ready_count,
        )
        if self.policy._last_eval == now:
            # the policy evaluated (was not throttled) this tick
            self.pressure_log.append(
                {"t": now, "size": size, "pressure": pressure}
            )
            if len(self.pressure_log) > 4096:
                del self.pressure_log[:2048]
        event = None
        if decision is not None:
            if decision["direction"] == "up":
                event = self._grow(now, decision)
            else:
                event = self._scale_down(now, decision)
        metrics = getattr(self.router, "metrics", None)
        if metrics is not None:
            metrics.fleet_size.set(self.supervisor.active_slots())
            metrics.standby_ready.set(self.pool.ready_count)
        return event

    # ------------------------------------------------------------ actuate
    def _grow(self, now: float, decision: dict) -> dict:
        t0 = self.clock.now()
        item = self.pool.take()
        if item is not None:
            rid, spec, worker = item
            slot = self.supervisor.grow(spec, worker=worker)
            warm = True
        else:
            # the burst outran replenishment: the cold spawn pipeline.
            # The slot joins BACKOFF due now and the supervisor spawns
            # it; the handle joins dead and the router's probes admit it
            # once the process answers. spec.replica can differ from the
            # slot index (pool rids are minted ahead); slot ids stay
            # stable either way.
            spec = self._spec_for(self._alloc_rid())
            slot = self.supervisor.grow(spec)
            warm = False
        handle = self._handle_factory(slot, spec)
        collector = getattr(self.router, "trace_collector", None)
        if collector is not None:
            collector.label_worker(slot, spec.engine.get("max_slots", 4))
        self.router.add_handle(handle)
        if warm:
            # promotion is a probe and a dispatch join: the boot already
            # happened in the pool's thread
            handle.probe_ok(now)
            if collector is not None:
                handle.measure_clock()
        join_s = max(0.0, self.clock.now() - t0)
        self.last_join_s = join_s
        # replenish BEHIND the promotion, never in front of it
        self.pool.provision(self._alloc_rid())
        event = dict(decision, slot=slot, warm=warm,
                     join_s=round(join_s, 6),
                     size=self.supervisor.active_slots())
        self._emit(now, event)
        return event

    def _scale_down(self, now: float, decision: dict) -> Optional[dict]:
        candidates = [
            h for h in self.router.handles
            if h.id < len(self.supervisor.specs)
            and self.supervisor.state(h.id) == RUNNING
            and not getattr(h, "_drain_requested", False)
        ]
        if not candidates:
            return None
        victim = max(candidates, key=lambda h: h.id)   # newest leaves
        victim.begin_drain()          # dispatch stops offering it now
        self.supervisor.shrink(victim.id)   # rpc drain + SIGTERM
        self._draining[victim.id] = victim
        event = dict(decision, slot=victim.id,
                     size=self.supervisor.active_slots())
        self._emit(now, event)
        return event

    def _retire_drained(self, now: float) -> None:
        """Once a draining slot's process is gone (clean exit or a
        SIGKILL: the supervisor retires both to STOPPED without a budget
        charge), pull its handle out of the router. remove_handle
        flushes and salvages anything left, so a drain cut short still
        fails over exactly once; dropping the handle's digest view lets
        the router's rendezvous placement over the surviving ids re-home
        the slot's prefix families."""
        for slot, handle in list(self._draining.items()):
            if self.supervisor.state(slot) != STOPPED:
                continue
            self.router.remove_handle(handle)
            del self._draining[slot]
            self.drain_log.append({"t": now, "slot": slot})
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.instant("scale_down_done", pid=ROUTER_PID,
                                    slot=slot)

    # ----------------------------------------------------------- introspect
    def snapshot(self) -> dict:
        """The state block of a fleet's /healthz (tools/check_fleet.py
        judges its size against min and max)."""
        return {
            "size": self.supervisor.active_slots(),
            "min": self.config.min_size,
            "max": self.config.max_size,
            "standby_ready": self.pool.ready_count,
            "standby_target": self.config.standby_target,
            "draining": sorted(self._draining),
            "events_total": len(self.events),
            "last_event": dict(self.events[-1]) if self.events else None,
            "last_join_s": self.last_join_s,
        }

    def close(self) -> None:
        self.pool.close()
