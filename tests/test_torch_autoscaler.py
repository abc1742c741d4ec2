"""The port's elastic fleet (serve/autoscaler.py, and the cache-routing
and autoscale benches of serve/bench.py) held to the reference's.

- AutoscalerPolicy: every scenario of the reference's
  tests/test_serve_autoscaler.py (validation, throttle, trip-fast,
  deadband, the calm window, no reversal inside hold in both directions,
  cooldowns, clamps, the reversal bound over a square wave) and seeded
  random inputs, fed to both packages' policies step by step: equal
  decisions, events and state after every step.
- StandbyPool (`spawn_in_thread=False`, fake workers): FIFO, the
  spawn-error ledger, close reaping every worker, in both packages.
- Autoscaler: each package's Autoscaler over its own Supervisor of fake
  workers and its own real Router, under one fake clock and one script:
  equal events, pressure and drain logs, snapshots, supervisor states,
  handles and every fake worker's signals and RPC calls. No process is
  started; a "SIGKILL" is a fake worker's exit code.
- Both benches' report keys equal the reference's (read from both
  sources), and every key tools/check_bench.py gates for them is
  present; cache_routing_bench runs end to end on the CPU with each
  worker a WorkerServer on a thread of the test's process (no process),
  fleet_autoscale_bench likewise under `slow` (its replay and drain
  windows take seconds).
- tools/check_fleet.py judges a /healthz whose autoscaler block is the
  port's snapshot.
- One real-process scale cycle (burst up, drain down, SIGKILL of the
  draining worker) is `slow`, as the reference marks its own.
"""

import ast
import dataclasses
import itertools
import pathlib
import subprocess
import threading
import time

import numpy as np
import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
import ddp_practice_tpu.serve.autoscaler as jasc
import ddp_practice_tpu.serve.router as jrouter
import ddp_practice_tpu.serve.scheduler as jsched
import ddp_practice_tpu.serve.supervisor as jsup
import ddp_practice_tpu.serve.worker as jworker
import ddp_practice_tpu_torch.serve.autoscaler as pasc
import ddp_practice_tpu_torch.serve.router as prouter
import ddp_practice_tpu_torch.serve.scheduler as psched
import ddp_practice_tpu_torch.serve.supervisor as psup
import ddp_practice_tpu_torch.serve.worker as pworker
from ddp_practice_tpu_torch.serve.scheduler import FakeClock
from ddp_practice_tpu_torch.serve.supervisor import (
    BACKOFF,
    DRAINING,
    RUNNING,
    STOPPED,
    reap_all,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (autoscaler, router, scheduler, supervisor, worker) modules
REF = (jasc, jrouter, jsched, jsup, jworker)
PORT = (pasc, prouter, psched, psup, pworker)


@pytest.fixture(autouse=True)
def _no_orphans():
    """No case leaves a worker process behind, however it ends."""
    yield
    leaked = reap_all()
    assert leaked == [], f"worker processes outlived the case: {leaked}"


# --------------------------------------------------------------- policy
CFG = dict(min_size=1, max_size=4, eval_interval_s=1.0, up_pressure=1.5,
           down_pressure=0.5, hold_s=10.0, cooldown_up_s=2.0,
           cooldown_down_s=15.0, down_stable_s=5.0, standby_target=1)


def _policy_state(pol) -> dict:
    return {k: getattr(pol, k) for k in (
        "_last_eval", "_last_change_t", "_last_direction", "_last_up_t",
        "_last_down_t", "_calm_since", "events")}


class Policies:
    """Both packages' AutoscalerPolicy on one config; `step` feeds both
    the same inputs and holds their decisions and state equal."""

    def __init__(self, **kw):
        cfg = {**CFG, **kw}
        self.ref = jasc.AutoscalerPolicy(jasc.AutoscalerConfig(**cfg))
        self.port = pasc.AutoscalerPolicy(pasc.AutoscalerConfig(**cfg))

    def step(self, t, **kw):
        want = self.ref.step(t, **kw)
        got = self.port.step(t, **kw)
        assert got == want, (t, kw)
        assert _policy_state(self.port) == _policy_state(self.ref)
        return got

    @property
    def events(self):
        return self.port.events


@pytest.mark.parametrize("kw,message", [
    (dict(min_size=0), "min_size"),
    (dict(min_size=3, max_size=2), "max_size"),
    (dict(up_pressure=1.0, down_pressure=1.0), "deadband"),
])
def test_config_validation_matches_the_reference(kw, message):
    for mod in (jasc, pasc):
        with pytest.raises(ValueError, match=message) as err:
            mod.AutoscalerConfig(**kw)
        if mod is jasc:
            want = str(err.value)
    assert str(err.value) == want
    assert _fields(pasc.AutoscalerConfig) == _fields(jasc.AutoscalerConfig)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_eval_throttle_one_evaluation_per_interval():
    p = Policies()
    assert p.step(0.0, size=1, pressure=9.0) is not None
    # a burst 0.5 s later is not evaluated: the throttle is on
    # evaluations, not only on commits
    assert p.step(0.5, size=1, pressure=9.0) is None
    assert p.port._last_eval == 0.0


def test_trip_fast_on_queue_pressure_and_on_slo_burn():
    p = Policies()
    d = p.step(0.0, size=2, pressure=1.5)     # at threshold: inclusive
    assert (d["direction"], d["trigger"], d["size"], d["pressure"]) == \
        ("up", "queue_pressure", 2, 1.5)
    p = Policies()
    d = p.step(0.0, size=2, pressure=0.0, slo_active=True,
               slo_resolved=False)
    assert d is not None and d["trigger"] == "slo_burn"


def test_deadband_moves_nothing():
    p = Policies()
    for k in range(20):
        assert p.step(float(k), size=2, pressure=1.0) is None
    assert p.events == [] and p.port._calm_since is None


def test_resolve_slow_needs_continuous_calm_and_a_resolved_slo():
    p = Policies()
    assert p.step(0.0, size=2, pressure=0.1) is None     # calm anchors
    assert p.port._calm_since == 0.0
    assert p.step(2.0, size=2, pressure=1.0) is None     # noise resets
    assert p.port._calm_since is None
    assert p.step(3.0, size=2, pressure=0.1) is None     # re-anchor
    assert p.step(7.0, size=2, pressure=0.1) is None     # 4 s < 5 s
    d = p.step(8.0, size=2, pressure=0.1)                # 5 s: resolve
    assert (d["direction"], d["trigger"]) == ("down", "slo_resolved")
    # a drained queue while the slow burn window smoulders is not calm
    p = Policies()
    for k in range(8):
        assert p.step(float(k), size=2, pressure=0.0,
                      slo_resolved=False) is None
    assert p.port._calm_since is None


def test_no_reversal_inside_hold_in_both_directions():
    p = Policies()
    assert p.step(0.0, size=1, pressure=3.0)["direction"] == "up"
    for t in (1.0, 2.0, 6.0, 9.0):      # calm, but the hold runs to 10
        assert p.step(t, size=2, pressure=0.0) is None
    assert p.step(10.0, size=2, pressure=0.0)["direction"] == "down"
    p = Policies()
    for t in (0.0, 5.0):
        p.step(t, size=3, pressure=0.0)
    assert p.events[-1]["direction"] == "down"          # at t=5
    for t in (6.0, 10.0, 14.0):         # the burst is back: held to 15
        assert p.step(t, size=2, pressure=9.0) is None
    assert p.step(15.0, size=2, pressure=9.0)["direction"] == "up"


def test_per_direction_cooldowns_and_the_clamps():
    p = Policies()
    assert p.step(0.0, size=1, pressure=3.0) is not None
    assert p.step(1.0, size=2, pressure=3.0) is None    # < 2 s cooldown
    assert p.step(2.0, size=2, pressure=3.0) is not None
    for t in (13.0, 20.0):
        p.step(t, size=3, pressure=0.0)
    assert (p.events[-1]["direction"], p.events[-1]["t"]) == ("down", 20.0)
    for t in (25.0, 30.0, 34.0):        # cooldown_down_s = 15
        assert p.step(t, size=2, pressure=0.0) is None
    assert p.step(35.0, size=2, pressure=0.0) is not None
    p = Policies()
    assert p.step(0.0, size=4, pressure=9.0) is None    # at max
    p = Policies()
    for t in (0.0, 6.0):
        assert p.step(t, size=1, pressure=0.0) is None  # at min
    assert p.events == []


def test_up_commit_reanchors_the_calm_window():
    p = Policies()
    p.step(0.0, size=2, pressure=0.1)
    assert p.port._calm_since == 0.0
    p.step(1.0, size=2, pressure=9.0)
    p.step(3.0, size=2, pressure=9.0)
    assert p.events[-1]["direction"] == "up"
    assert p.port._calm_since is None


def test_reversals_bounded_by_the_hold_window_over_a_square_wave():
    """A burst/calm square wave of 3.5 s phases (shorter than hold_s)
    extracts no two reversals closer than hold_s, and at most
    elapsed / hold_s + 1 of them; both packages decide alike."""
    p = Policies(eval_interval_s=0.5, hold_s=5.0, cooldown_up_s=0.5,
                 cooldown_down_s=0.5, down_stable_s=0.5, standby_target=0)
    size, t = 2, 0.0
    for k in range(400):
        burst = (k // 7) % 2 == 0
        d = p.step(t, size=size, pressure=(9.0 if burst else 0.0))
        if d is not None:
            size += 1 if d["direction"] == "up" else -1
            assert 1 <= size <= 4
        t += 0.5
    evs = p.events
    assert evs
    reversals = [(a, b) for a, b in zip(evs, evs[1:])
                 if a["direction"] != b["direction"]]
    assert all(b["t"] - a["t"] >= 5.0 for a, b in reversals)
    assert len(reversals) <= t / 5.0 + 1


@pytest.mark.parametrize("seed", range(8))
def test_policy_steps_with_the_reference_on_seeded_inputs(seed):
    """Seeded configs and 300 seeded evaluations (clock steps shorter
    and longer than the throttle, pressures across both thresholds, SLO
    alerts and resolves): both policies decide alike at every step."""
    rng = np.random.RandomState(seed)
    lo = int(rng.randint(1, 3))
    p = Policies(
        min_size=lo, max_size=lo + 1 + int(rng.randint(0, 3)),
        eval_interval_s=float(rng.choice([0.2, 0.5, 1.0])),
        up_pressure=1.5, down_pressure=float(rng.choice([0.3, 0.5])),
        hold_s=float(rng.choice([1.0, 4.0, 10.0])),
        cooldown_up_s=float(rng.choice([0.0, 1.0, 2.0])),
        cooldown_down_s=float(rng.choice([0.5, 3.0, 15.0])),
        down_stable_s=float(rng.choice([0.0, 1.5, 5.0])))
    size, t = lo, 0.0
    for _ in range(300):
        t += float(rng.choice([0.1, 0.3, 0.5, 1.0, 2.5]))
        active = bool(rng.rand() < 0.1)
        d = p.step(t, size=size,
                   pressure=float(rng.choice([0.0, 0.3, 0.5, 1.0, 1.5,
                                              4.0])),
                   slo_active=active,
                   slo_resolved=not active and bool(rng.rand() < 0.8),
                   standby_ready=int(rng.randint(2)))
        if d is not None:
            size += 1 if d["direction"] == "up" else -1
    assert p.events


# ----------------------------------------------------------------- pool
class PoolWorker:
    def __init__(self, spec, index):
        self.spec = spec
        self.index = index
        self.reaped = False

    def reap(self, timeout_s=5.0):
        self.reaped = True


class Pool:
    """One package's StandbyPool over a synchronous fake spawn."""

    def __init__(self, mods, fail_rids=()):
        asc, _, _, _, worker = mods
        self.spawned = []

        def spawn(spec):
            if spec.replica in fail_rids:
                raise RuntimeError(f"boom rid {spec.replica}")
            w = PoolWorker(spec, len(self.spawned))
            self.spawned.append(w)
            return w

        self.pool = asc.StandbyPool(
            lambda rid: worker.WorkerSpec(replica=rid), spawn_fn=spawn,
            spawn_in_thread=False)

    def state(self, taken=()):
        p = self.pool
        return {
            "ready": p.ready_count, "in_flight": p.in_flight,
            "spawned_total": p.spawned_total,
            "errors": list(p.spawn_errors),
            "taken": [None if t is None else (t[0], t[1].replica,
                                              t[2].index) for t in taken],
            "reaped": [w.reaped for w in self.spawned],
        }


@pytest.mark.parametrize("case", ["fifo", "spawn_error", "close"])
def test_pool_steps_with_the_reference(case):
    fail = {7} if case == "spawn_error" else ()
    pools = [Pool(REF, fail), Pool(PORT, fail)]
    try:
        _pool_case(case, pools)
    finally:
        for tw in pools:
            tw.pool.close()


def _pool_case(case, pools):
    states = []
    for tw in pools:
        pool = tw.pool
        taken = []
        if case == "fifo":
            pool.provision(5)
            pool.provision(6)
            states.append(tw.state())
            taken = [pool.take(), pool.take(), pool.take()]
            assert pool.wait_ready(timeout_s=0.05) is False
        elif case == "spawn_error":
            pool.provision(7)
            pool.provision(8)
            taken = [pool.take()]
        else:
            pool.provision(1)
            pool.close()
            pool.provision(2)          # refused, not queued
            taken = [pool.take()]
            assert pool.wait_ready(timeout_s=0.05) is False
        states.append(tw.state(taken))
    half = len(states) // 2
    assert states[half:] == states[:half]
    got = states[-1]
    if case == "fifo":
        assert got["taken"] == [(5, 5, 0), (6, 6, 1), None]
    elif case == "spawn_error":
        assert got["errors"] == [(7, "RuntimeError('boom rid 7')")]
        assert got["taken"] == [(8, 8, 0)]
    else:
        assert got["reaped"] == [True] and got["ready"] == 0
        assert got["in_flight"] == 0 and got["taken"] == [None]


# --------------------------------------------------------- orchestrator
class FakeClient:
    def __init__(self, handler):
        self.handler = handler
        self.calls = []

    def call(self, op, **fields):
        self.calls.append((op, fields))
        return {"ok": True, **self.handler(op, fields)}

    def close(self):
        pass


class ElasticWorker:
    """A fake worker that SIGTERM does not fell: a draining worker lives
    until the script ends it (a clean exit, or rc -9 as a SIGKILL).
    `index` is its order of birth in its run."""

    def __init__(self, spec, index, handler):
        self.spec = spec
        self.index = index
        self.pid = 60_000 + index
        self.rc = None
        self.signals = []
        self.reaped = False
        self.client = FakeClient(handler)

    def poll(self):
        return self.rc

    def kill_signal(self, sig):
        self.signals.append(sig)
        if sig == "SIGKILL":
            self.rc = -9

    def die(self, rc):
        self.rc = rc

    def reap(self, timeout_s=5.0):
        self.reaped = True


def _idle_handler(op, fields):
    if op == "shed":
        return {"rids": []}
    if op == "poll":
        return {"completions": [], "inflight": [], "watermark": 0,
                "stats": {"queue": 0, "active": 0, "max_slots": 2}}
    return {"accepted": True}


class FakeSLO:
    """A scripted burn signal (the watchdog's own law is held to the
    reference in tests/test_torch_slo.py): an input of the loop."""

    def __init__(self):
        self.active = False
        self.resolved = True

    def evaluate(self, now):
        pass

    def on_completion(self, c):
        pass

    def observe(self, c):
        pass

    def burn_signal(self):
        return {"burn_fast": 0.0, "burn_slow": 0.0,
                "active": self.active, "resolved": self.resolved}


ELASTIC = dict(min_size=1, max_size=3, eval_interval_s=1.0,
               up_pressure=1.5, down_pressure=0.5, hold_s=10.0,
               cooldown_up_s=2.0, cooldown_down_s=15.0, down_stable_s=5.0,
               standby_target=1)
SUP_KW = dict(restart_base_s=0.2, restart_factor=2.0, restart_max_s=10.0,
              restart_jitter=0.0, restart_budget=3)


class Elastic:
    """One package's Autoscaler over a Supervisor of fake workers and a
    real Router; the clock and the SLO are the caller's (shared by both
    packages: FakeClock(step_s=0) moves only when the script moves it)."""

    def __init__(self, mods, clock, slo, *, n, acfg):
        asc, router, sched, sup, worker = mods
        self.sched = sched
        self.born = []
        kw = {"device": "cpu"} if mods is PORT else {}
        spec = worker.WorkerSpec(
            engine={"max_slots": 2, "prompt_buckets": [8, 16]},
            max_queue=8, **kw)
        self.sup = sup.Supervisor([spec] * n, sup.SupervisorConfig(**SUP_KW),
                                  spawn_fn=self._spawn,
                                  spawn_in_thread=False, clock=clock)
        self.sup.start()
        handles = [sup.RemoteReplicaHandle(i, self.sup, spec, clock=clock)
                   for i in range(n)]
        self.router = router.Router(handles, clock=clock, slo=slo)
        self.asc = asc.Autoscaler(
            self.router, self.sup, spec,
            config=asc.AutoscalerConfig(**acfg), clock=clock,
            spawn_fn=self._spawn, spawn_in_thread=False)
        self.router.autoscaler = self.asc

    def _spawn(self, spec):
        w = ElasticWorker(spec, len(self.born), _idle_handler)
        self.born.append(w)
        return w

    def act(self, kind, arg):
        if kind == "burst":
            n, rid0 = arg
            return [self.router.submit(self.sched.Request(
                rid=rid0 + i, prompt=[1, 2, 3], max_new_tokens=4,
                arrival=self.router.clock.now())) for i in range(n)]
        if kind == "asc_step":
            return self.asc.step(arg)
        if kind == "router_step":
            self.router.step()
            return None
        if kind == "die":
            w = self.sup.workers[arg[0]]
            if w is not None:
                w.die(arg[1])
            return None
        if kind == "poll":
            self.sup.poll()
            return None
        if kind == "close":
            self.asc.close()
            return None
        raise AssertionError(kind)

    def snapshot(self, result):
        a, r, s = self.asc, self.router, self.sup
        m = r.metrics
        return {
            "result": result,
            "events": a.events, "policy_events": a.policy.events,
            "pressure_log": a.pressure_log, "drain_log": a.drain_log,
            "snapshot": a.snapshot(),
            "pool": (a.pool.ready_count, a.pool.in_flight,
                     a.pool.spawned_total, a.pool.spawn_errors),
            "states": list(s.states), "restarts": list(s.restarts),
            "budget_used": list(s._budget_used),
            "seated": [None if w is None else w.index for w in s.workers],
            "handles": [(h.id, h.health.state.value,
                         bool(getattr(h, "_drain_requested", False)))
                        for h in r.handles],
            "gauges": (m.fleet_size.value, m.standby_ready.value),
            "born": [(w.index, w.spec.replica, w.rc, tuple(w.signals),
                      w.reaped, tuple(w.client.calls)) for w in self.born],
        }


class Fleets:
    """Both packages' elastic fleets on one fake clock and one SLO; every
    action goes to both and their snapshots must stay equal."""

    def __init__(self, n=1, **acfg):
        self.clock = FakeClock(step_s=0.0)
        self.slo = FakeSLO()
        acfg = {**ELASTIC, **acfg}
        self.ref = Elastic(REF, self.clock, self.slo, n=n, acfg=acfg)
        self.port = Elastic(PORT, self.clock, self.slo, n=n, acfg=acfg)
        self.check(None, None)

    def check(self, want_result, got_result):
        want = self.ref.snapshot(want_result)
        got = self.port.snapshot(got_result)
        assert got == want
        return got

    def act(self, kind, arg=None):
        if kind == "advance":
            self.clock.advance(arg)
            return self.check(None, None)
        if kind == "slo":
            self.slo.active, self.slo.resolved = arg
            return self.check(None, None)
        return self.check(self.ref.act(kind, arg),
                          self.port.act(kind, arg))

    def close(self):
        for side in (self.ref, self.port):
            side.asc.close()
            side.sup.stop()


@pytest.fixture
def fleets():
    made = []

    def make(**kw):
        f = Fleets(**kw)
        made.append(f)
        return f

    yield make
    for f in made:
        f.close()


def test_grow_promotes_a_warm_standby_with_the_reference(fleets):
    f = fleets()
    p = f.port
    assert p.asc.pool.ready_count == 1 and len(p.born) == 2
    f.act("burst", (4, 100))                  # load 4 / 2 slots = 2.0
    ev = f.act("asc_step", f.clock.now())["result"]
    assert (ev["direction"], ev["trigger"], ev["warm"], ev["slot"],
            ev["size"]) == ("up", "queue_pressure", True, 1, 2)
    assert p.sup.state(1) == RUNNING and p.sup.restarts[1] == 0
    assert [h.id for h in p.router.handles] == [0, 1]
    # the promoted worker was probed before dispatch trusts it
    assert "ping" in [op for op, _ in p.born[1].client.calls]
    # replenished behind the promotion, with a fresh rid
    assert p.asc.pool.ready_count == 1 and p.born[-1].spec.replica == 2
    assert p.router.metrics.fleet_size.value == 2
    assert p.router.metrics.standby_ready.value == 1


def test_grow_falls_back_cold_with_an_empty_pool(fleets):
    f = fleets(standby_target=0)
    f.act("burst", (4, 100))
    snap = f.act("asc_step", f.clock.now())
    assert snap["result"]["warm"] is False
    assert snap["states"][1] == BACKOFF       # due now, budget-free
    snap = f.act("poll")
    assert snap["states"][1] == RUNNING
    assert snap["restarts"] == [0, 0] and snap["budget_used"] == [0, 0]


def test_slo_burn_scales_up_without_pressure(fleets):
    f = fleets()
    f.act("slo", (True, False))
    snap = f.act("asc_step", f.clock.now())
    assert snap["result"]["trigger"] == "slo_burn"
    assert snap["snapshot"]["size"] == 2


@pytest.mark.parametrize("how", ["clean_exit", "sigkill_mid_drain"])
def test_drain_then_retire_with_the_reference(fleets, how):
    f = fleets(n=2)
    t0 = f.clock.now()
    assert f.act("asc_step", t0)["result"] is None      # calm anchors
    snap = f.act("asc_step", t0 + 6.0)                   # 6 s > 5 s
    ev = snap["result"]
    assert (ev["direction"], ev["slot"]) == ("down", 1)  # newest leaves
    p = f.port
    w = p.born[1]
    assert ("drain", {"timeout_s": 1.0, "retries": 0}) in w.client.calls
    assert w.signals == ["SIGTERM"] and p.sup.state(1) == DRAINING
    assert snap["handles"][1] == (1, "healthy", True)
    assert snap["snapshot"]["draining"] == [1]
    f.act("die", (1, 0 if how == "clean_exit" else -9))
    assert f.act("poll")["states"][1] == STOPPED        # not a crash
    snap = f.act("asc_step", t0 + 7.0)                   # the retire pass
    assert [h[0] for h in snap["handles"]] == [0]
    assert snap["drain_log"] == [{"t": t0 + 7.0, "slot": 1}]
    assert snap["snapshot"]["draining"] == []
    assert snap["restarts"] == [0, 0] and snap["budget_used"] == [0, 0]
    assert snap["gauges"][0] == 1
    # no respawn ever comes for a shrunk slot
    f.act("advance", 3600.0)
    snap = f.act("poll")
    assert snap["states"][1] == STOPPED and len(snap["born"]) == 3


def test_pressure_log_and_snapshot_with_the_reference(fleets):
    f = fleets()
    t0 = f.clock.now()
    f.act("asc_step", t0)
    f.act("asc_step", t0 + 0.5)               # throttled: no row
    snap = f.act("asc_step", t0 + 1.0)
    assert snap["pressure_log"] == [
        {"t": t0, "size": 1, "pressure": 0.0},
        {"t": t0 + 1.0, "size": 1, "pressure": 0.0}]
    f = fleets()
    f.act("burst", (4, 100))
    snap = f.act("router_step")               # the router ticks the loop
    assert set(snap["snapshot"]) == {
        "size", "min", "max", "standby_ready", "standby_target",
        "draining", "events_total", "last_event", "last_join_s"}
    s = snap["snapshot"]
    assert (s["size"], s["min"], s["max"]) == (2, 1, 3)
    assert s["last_event"]["direction"] == "up"
    assert s["last_join_s"] is not None
    snap = f.act("close")
    assert snap["pool"][0] == 0
    assert all(b[4] for b in snap["born"][2:])   # pooled standby reaped


@pytest.mark.parametrize("seed", range(6))
def test_autoscaler_steps_with_the_reference_on_seeded_scripts(
        fleets, seed):
    """Seeded scripts of bursts, router ticks, autoscaler steps, clock
    advances, SLO alerts, worker deaths (clean or killed, draining or
    not) and supervisor polls: equal snapshots after every action."""
    rng = np.random.RandomState(seed)
    f = fleets(n=int(rng.randint(1, 3)), standby_target=int(rng.randint(2)),
               hold_s=2.0, cooldown_up_s=0.5, cooldown_down_s=1.0,
               down_stable_s=1.0, eval_interval_s=0.5)
    rid = 0
    kinds = ["burst", "router_step", "router_step", "asc_step",
             "asc_step", "advance", "advance", "slo", "die", "poll"]
    for _ in range(60):
        kind = kinds[int(rng.randint(len(kinds)))]
        if kind == "burst":
            n = int(rng.randint(1, 6))
            f.act("burst", (n, rid))
            rid += n
        elif kind == "asc_step":
            f.act("asc_step", f.clock.now())
        elif kind == "advance":
            f.act("advance", float(rng.choice([0.3, 0.6, 1.2, 3.0])))
        elif kind == "slo":
            active = bool(rng.rand() < 0.3)
            f.act("slo", (active, not active))
        elif kind == "die":
            slot = int(rng.randint(len(f.port.sup.workers)))
            f.act("die", (slot, int(rng.choice([0, -9]))))
        else:
            f.act(kind)
    assert f.port.asc.pressure_log


def test_check_fleet_judges_the_ports_snapshot(fleets):
    """tools/check_fleet.py's verdict on a /healthz whose autoscaler
    block is the port's snapshot: ok inside min..max, not ok and the
    autoscaler named outside it."""
    from tools.check_fleet import fleet_verdict

    def healthz(snap, n):
        return {"status": "HEALTHY", "autoscaler": snap,
                "workers": {str(i): {"status": "healthy",
                                     "state": "running",
                                     "heartbeat_age_s": 0.1}
                            for i in range(n)}}

    inside = fleets(n=2).port.asc.snapshot()
    assert fleet_verdict(healthz(inside, 2)) == (True, [])
    over = fleets(n=2, max_size=1).port.asc.snapshot()
    ok, problems = fleet_verdict(healthz(over, 2))
    assert not ok and problems == ["autoscaler: fleet size 2 above max 1"]
    under = fleets(n=2, min_size=3, max_size=3).port.asc.snapshot()
    ok, problems = fleet_verdict(healthz(under, 2))
    assert not ok and problems == ["autoscaler: fleet size 2 below min 3"]


# ------------------------------------------------------------ the benches
def _return_keys(path, fn) -> dict:
    """The keys of `fn`'s returned dict literal and of the dicts it
    builds under the names the report nests (arm rows), read from the
    source at `path`."""
    tree = ast.parse((ROOT / path).read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    out = {"return": set()}

    def consts(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    for sub in ast.walk(node):
        if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Dict) \
                and sub in node.body:
            out["return"] |= consts(sub.value)
        if isinstance(sub, ast.FunctionDef) and sub.name in ("arm_row",):
            for r in ast.walk(sub):
                if isinstance(r, ast.Return) and isinstance(r.value,
                                                            ast.Dict):
                    out.setdefault("arm", set()).update(consts(r.value))
        if isinstance(sub, ast.Assign) and isinstance(sub.targets[0],
                                                      ast.Name) \
                and sub.targets[0].id == "arm" \
                and isinstance(sub.value, ast.Dict):
            out.setdefault("arm", set()).update(consts(sub.value))
        if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                    ast.Attribute) \
                and sub.func.attr == "update" \
                and isinstance(sub.func.value, ast.Name) \
                and sub.func.value.id == "arm" and sub.args \
                and isinstance(sub.args[0], ast.Dict):
            out.setdefault("auto_arm", set()).update(consts(sub.args[0]))
        if isinstance(sub, ast.Try):
            for b in sub.body:
                if isinstance(b, ast.Return) and isinstance(b.value,
                                                            ast.Dict):
                    out["return"] |= consts(b.value)
    return out


def _gated(prefix) -> set:
    """The report keys tools/check_bench.py gates under `prefix`."""
    tree = ast.parse((ROOT / "tools" / "check_bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith(prefix + "."):
            keys.add(node.value[len(prefix) + 1:])
    return keys


class ThreadWorker:
    """A WorkerServer on a thread of this process, behind the interface
    the supervisor drives a SpawnedWorker through: no process is
    started and no signal is sent (SIGTERM drains, SIGKILL stops the
    serve loop). The "process" has exited once its serve loop returned;
    the thread then closes the server's sockets (the `thread_workers`
    fixture joins every such thread at the end of the case)."""

    _pids = itertools.count(70_000)
    made = []

    def __init__(self, spec, **_kw):
        from ddp_practice_tpu_torch.serve.rpc import RpcClient

        self.server = pworker.WorkerServer(spec)
        self.pid = next(self._pids)
        self.rpc_port = self.server.rpc.port
        self.telemetry_port = self.server.telemetry.port
        self.rc = None
        self._exited = threading.Event()
        self.proc = self
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        self.made.append(self)
        self.client = RpcClient("127.0.0.1", self.rpc_port, timeout_s=5.0,
                                seed=spec.replica)

    def _run(self):
        try:
            self.server.serve_forever()
        finally:
            if self.rc is None:
                self.rc = 0
            self._exited.set()
            self.server.close()

    def _stop(self):
        if self.rc is None:
            self.rc = -9
        self.server._stop.set()
        self.server._wake.set()

    def poll(self):
        return self.rc if self._exited.is_set() else None

    def wait(self, timeout=None):
        if not self._exited.wait(timeout):
            raise subprocess.TimeoutExpired("thread worker", timeout)
        return self.rc

    def kill_signal(self, sig):
        if sig == "SIGTERM":
            self.server.begin_drain()
        else:
            self._stop()

    def reap(self, timeout_s=5.0):
        self.client.close()
        self._stop()
        self._exited.wait(timeout_s)


@pytest.fixture
def thread_workers(monkeypatch):
    monkeypatch.setattr(psup, "spawn_worker", ThreadWorker)
    monkeypatch.setattr(pasc, "spawn_worker", ThreadWorker)
    yield
    made, ThreadWorker.made = ThreadWorker.made, []
    for w in made:
        w.reap()
    for w in made:
        w.thread.join(10.0)
    assert not [w.pid for w in made if w.thread.is_alive()]


def test_cache_routing_bench_keys_and_gates(thread_workers):
    """cache_routing_bench through two thread-worker fleets on the CPU:
    the reference's keys, the gated keys, zero lost and token identity
    (routing moves requests, never their tokens)."""
    from ddp_practice_tpu_torch.serve.bench import cache_routing_bench

    report = cache_routing_bench(device="cpu", n_requests=4, reps=1,
                                 rate_hz=400.0)
    ref = _return_keys("ddp_practice_tpu/serve/bench.py",
                       "cache_routing_bench")
    port = _return_keys("ddp_practice_tpu_torch/serve/bench.py",
                        "cache_routing_bench")
    assert set(report) == ref["return"] == port["return"]
    assert _gated("cache_routing_100rps") <= set(report)
    assert {"hit_rate_ratio", "goodput_ratio", "lost",
            "token_identity"} <= _gated("cache_routing_100rps")
    for side in ("affinity", "least_loaded"):
        assert ref["arm"] | {"workers"} == set(report[side]) - {
            "route_decisions"}
        assert len(report[side]["workers"]) == 2
    assert report["lost"] == 0 and report["token_identity"] == 1.0
    assert report["affinity"]["route_decisions"]


def test_fleet_autoscale_bench_keys_match_the_reference_source():
    """fleet_autoscale_bench's report, its arms' rows and the autoscaled
    arm's additions carry the reference's keys (both read from source),
    and every key tools/check_bench.py gates for it. (Its run on thread
    workers, one chunk a phase, takes seconds of replay and drain
    windows: `slow`, below.)"""
    ref = _return_keys("ddp_practice_tpu/serve/bench.py",
                       "fleet_autoscale_bench")
    port = _return_keys("ddp_practice_tpu_torch/serve/bench.py",
                        "fleet_autoscale_bench")
    assert port["return"] == ref["return"]
    assert port["arm"] == ref["arm"] | {"workers"}
    assert port["auto_arm"] == ref["auto_arm"]
    assert _gated("autoscale_burst_100rps") <= port["return"]
    assert {"goodput_per_worker_ratio", "lost", "reaction_within_window",
            "oscillation_ok", "promote_join_s"} <= _gated(
                "autoscale_burst_100rps")


@pytest.mark.slow
def test_fleet_autoscale_bench_runs_on_thread_workers(thread_workers):
    """fleet_autoscale_bench end to end through thread-worker fleets on
    the CPU, one chunk a phase: the keys above in the report itself,
    zero lost and the oscillation bound held."""
    from ddp_practice_tpu_torch.serve.bench import fleet_autoscale_bench

    report = fleet_autoscale_bench(
        device="cpu", procs=2, autoscale_max=2, rate_hz=400.0,
        chunk_s=0.02, chunks_base=1, chunks_step=1, chunks_post=0,
        max_new_range=(2, 6))
    ref = _return_keys("ddp_practice_tpu/serve/bench.py",
                       "fleet_autoscale_bench")
    assert set(report) == ref["return"]
    assert ref["arm"] | {"workers"} == set(report["fixed"])
    assert ref["arm"] | ref["auto_arm"] | {"workers"} == set(
        report["autoscaled"])
    assert report["lost"] == 0 and report["oscillation_ok"] == 1.0
    assert report["autoscaled"]["cold_spawn_s"] > 0
    assert len(report["fixed"]["workers"]) == 2


def test_new_benches_refuse_a_missing_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    from ddp_practice_tpu_torch.serve import bench

    for entry in (bench.cache_routing_bench, bench.fleet_autoscale_bench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    for flags in (["--cache-aware"], ["--autoscale"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--procs", "2", *flags])


# ----------------------------------------------------- real processes
MODEL_KW = {"vocab_size": 64, "max_len": 128, "hidden_dim": 64, "depth": 2,
            "num_heads": 4, "mlp_dim": 128, "pos_emb": "rope"}
ENGINE_KW = {"max_slots": 2, "max_len": 128, "prompt_buckets": [8, 16],
             "temperature": 0.0, "decode_burst": 4, "eos_id": None}


@pytest.mark.slow
def test_real_workers_scale_up_drain_down_and_survive_a_sigkill():
    """REAL worker processes through a scale cycle, as the reference's
    tests/test_worker_autoscale.py: a burst on one worker promotes the
    warm standby, the calm drains the newest worker, a SIGKILL of the
    draining worker retires it without a restart, every completion is
    greedy token-identical to one in-process scheduler, none lost."""
    from ddp_practice_tpu_torch.serve.autoscaler import (
        Autoscaler,
        AutoscalerConfig,
    )
    from ddp_practice_tpu_torch.serve.engine import EngineConfig, SlotEngine
    from ddp_practice_tpu_torch.serve.scheduler import Request, Scheduler
    from ddp_practice_tpu_torch.serve.supervisor import (
        SupervisorConfig,
        make_fleet_router,
    )
    from ddp_practice_tpu_torch.serve.worker import WorkerSpec, build_model

    rng = np.random.default_rng(5)
    trace = [{"rid": i,
              "prompt": rng.integers(1, 64, int(rng.integers(3, 9))).tolist(),
              "max_new_tokens": int(rng.integers(60, 81))}
             for i in range(8)]
    eng_kw = dict(ENGINE_KW, prompt_buckets=tuple(ENGINE_KW["prompt_buckets"]))
    sched = Scheduler(SlotEngine(build_model(MODEL_KW, "cpu"),
                                 EngineConfig(**eng_kw)), max_queue=64)
    for t in trace:
        sched.submit(Request(**t))
    expected = {c.rid: list(c.tokens) for c in sched.run_until_idle()}

    spec = WorkerSpec(model=MODEL_KW, engine=ENGINE_KW, max_queue=64,
                      device="cpu")
    router, sup, _ = make_fleet_router(
        spec, 1, sup_config=SupervisorConfig(restart_base_s=0.25,
                                             shrink_kill_after_s=60.0))
    asc = Autoscaler(router, sup, spec, config=AutoscalerConfig(
        min_size=1, max_size=2, eval_interval_s=0.2, up_pressure=1.5,
        down_pressure=0.5, hold_s=1.0, cooldown_up_s=0.5,
        cooldown_down_s=0.5, down_stable_s=0.5, standby_target=1),
        clock=router.clock)
    router.autoscaler = asc
    try:
        assert asc.pool.wait_ready(timeout_s=300.0, n=1), \
            f"standby never warmed: {asc.pool.spawn_errors}"
        for t in trace:                       # 8 requests on 2 slots
            assert router.submit(Request(**t))
        deadline = time.monotonic() + 60
        while not asc.events:
            assert time.monotonic() < deadline, "never scaled up"
            router.step()
        up = asc.events[0]
        assert (up["direction"], up["trigger"], up["warm"]) == (
            "up", "queue_pressure", True)
        assert up["join_s"] < 2.0 and len(router.handles) == 2
        comps = {c.rid: c for c in router.run_until_idle()}
        assert set(comps) == set(expected)
        assert all(comps[r].tokens == want for r, want in expected.items())

        deadline = time.monotonic() + 60
        while len(asc.events) < 2:
            assert time.monotonic() < deadline, "never scaled down"
            router.step()
            time.sleep(0.02)
        down = asc.events[1]
        assert (down["direction"], down["slot"]) == ("down", up["slot"])
        assert sup.state(down["slot"]) == DRAINING
        sup.kill(down["slot"], "SIGKILL")     # a worker this test spawned
        deadline = time.monotonic() + 60
        while len(router.handles) != 1:
            assert time.monotonic() < deadline, "never retired"
            router.step()
            time.sleep(0.02)
        assert sup.state(down["slot"]) == STOPPED
        assert sup.restarts[down["slot"]] == 0
        assert asc.snapshot()["size"] == 1
        router.submit(Request(rid=999, prompt=[1, 2, 3], max_new_tokens=4))
        assert {c.rid: c.status for c in router.run_until_idle()}[999] \
            == "length"
    finally:
        asc.close()
        sup.stop()
