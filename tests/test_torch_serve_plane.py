"""The port's serving-plane substrate against the JAX package's, on the
CPU: serve/health.py, serve/faults.py, serve/metrics.py and
utils/logging.py.

Each case runs one scenario through both packages' modules and holds
the port's observables to the reference's (and to the values
tests/test_serve_health.py and tests/test_serve_metrics.py pin):

- the circuit breaker trips after consecutive failures, schedules its
  half-open probes by backoff and closes on a good probe;
- the replica health summary walks HEALTHY -> DEGRADED -> HEALTHY ->
  DEAD -> HEALTHY;
- a FaultPlan (kill specs included) round-trips through JSON, and each
  package parses the other's JSON to the same specs;
- the injector fires each spec at its planned tick, a crash with a down
  window is probeable after it, a permanent one never; the fleet driver
  fires kill specs once each, in time order;
- ServeMetrics, RouterMetrics and FrontdoorMetrics give the reference's
  snapshot and text exposition byte for byte after one event sequence;
- emit_metrics writes the reference's line on rank 0 and nothing on
  another rank.
"""

import logging
import math
import types

import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.serve import faults as jax_faults
from ddp_practice_tpu.serve import health as jax_health
from ddp_practice_tpu.serve import metrics as jax_serve_metrics
from ddp_practice_tpu.serve import scheduler as jax_scheduler
from ddp_practice_tpu.utils import logging as jax_logging
from ddp_practice_tpu.utils import metrics as jax_metrics
from ddp_practice_tpu_torch.serve import faults, health, scheduler
from ddp_practice_tpu_torch.serve import metrics as serve_metrics
from ddp_practice_tpu_torch.utils import logging as port_logging
from ddp_practice_tpu_torch.utils import metrics

REF = types.SimpleNamespace(health=jax_health, faults=jax_faults,
                            sm=jax_serve_metrics, sched=jax_scheduler,
                            metrics=jax_metrics)
PORT = types.SimpleNamespace(health=health, faults=faults, sm=serve_metrics,
                             sched=scheduler, metrics=metrics)


def both(scenario):
    """(reference's result, port's result) of one scenario."""
    return scenario(REF), scenario(PORT)


# ---------------------------------------------------------------- breaker
def _breaker_run(pkg):
    h = pkg.health
    br = h.CircuitBreaker(h.BreakerConfig(trip_after=3, probe_base_s=0.1,
                                          probe_factor=2.0, probe_jitter=0.0))
    out = [br.record_failure(0.0)]
    br.record_success()          # failures must be CONSECUTIVE
    out += [br.record_failure(1.0), br.record_failure(2.0),
            br.record_failure(3.0)]
    out += [br.open, br.trips, br.probe_due(3.05), br.probe_due(3.1)]
    br.on_probe(False, 3.1)      # failed probe: the wait doubles
    out += [br.next_probe_at, br.probe_due(3.25), br.probe_due(3.31)]
    br.on_probe(True, 3.31)      # half-open success closes
    out += [br.open, br.consecutive_failures, br.next_probe_at]
    # a jittered schedule: the same seeded delays in both packages
    jit = h.CircuitBreaker(h.BreakerConfig(trip_after=1, probe_base_s=0.05,
                                           probe_jitter=0.5, seed=7))
    jit.record_failure(0.0)
    for k in range(5):
        out.append(jit.next_probe_at)
        jit.on_probe(False, jit.next_probe_at)
    return out


def test_breaker_trips_and_probe_backoff():
    ref, port = both(_breaker_run)
    assert port == ref
    assert port[:8] == [False, False, False, True, True, 1, False, True]
    assert port[8] == pytest.approx(3.3)


def _health_run(pkg):
    h = pkg.health
    rh = h.ReplicaHealth(h.BreakerConfig(trip_after=2, probe_base_s=0.1,
                                         probe_jitter=0.0))
    states = [(rh.state.value, rh.alive)]
    rh.mark_failure(0.0)
    states.append((rh.state.value, rh.alive))
    rh.mark_success()
    states.append((rh.state.value, rh.alive))
    rh.mark_dead(1.0)            # crash: instant DEAD
    states.append((rh.state.value, rh.alive, rh.probe_due(1.05),
                   rh.probe_due(1.1)))
    rh.on_probe(True, 2.0)
    states.append((rh.state.value, rh.alive))
    # two consecutive failures trip through mark_failure
    states.append((rh.mark_failure(3.0), rh.mark_failure(3.1),
                   rh.state.value))
    return states


def test_health_state_transitions():
    ref, port = both(_health_run)
    assert port == ref
    assert [s[0] for s in port[:5]] == ["healthy", "degraded", "healthy",
                                        "dead", "healthy"]
    assert port[5] == (False, True, "dead")


# ------------------------------------------------------------ fault plans
_PLAN_SPECS = [
    dict(kind="crash", tick=5, replica=0, down_s=0.5),
    dict(kind="nan_logits", tick=3, replica=1, slot=2),
    dict(kind="latency", tick=2, replica=1, delay_s=0.25),
    dict(kind="admit_fail", tick=4, replica=0),
    dict(kind="kill", replica=1, at_s=2.5, sig="SIGSTOP"),
    dict(kind="kill", replica=0, at_s=1.0),
]


def test_fault_plan_json_round_trip_with_kill():
    ref = jax_faults.FaultPlan([jax_faults.FaultSpec(**s)
                                for s in _PLAN_SPECS])
    port = faults.FaultPlan([faults.FaultSpec(**s) for s in _PLAN_SPECS])
    assert port.to_json() == ref.to_json()
    # each package reads the other's plan to the same specs
    back = faults.FaultPlan.from_json(ref.to_json())
    assert back.to_json() == ref.to_json()
    assert jax_faults.FaultPlan.from_json(port.to_json()).to_json() \
        == port.to_json()
    # the bare-list schema too
    bare = '[{"kind": "crash", "tick": 1}]'
    assert faults.FaultPlan.from_json(bare).faults == [
        faults.FaultSpec(kind="crash", tick=1)]
    # kills fire in time order and never reach a scheduler's injector
    assert [(k.replica, k.at_s) for k in port.kills()] == [(0, 1.0),
                                                           (1, 2.5)]
    assert [f.kind for f in port.injector(1).faults] == ["latency",
                                                          "nan_logits"]
    assert port.injector(2) is None
    for bad in (dict(kind="meteor"), dict(kind="crash", tick=0),
                dict(kind="kill", sig="SIGHUP")):
        with pytest.raises(ValueError):
            faults.FaultSpec(**bad)
    with pytest.raises(FileNotFoundError):
        faults.FaultPlan.from_json("no/such/plan.json")


class _StubEngine:
    def __init__(self):
        self.poisoned = []

    def poison_slot(self, slot):
        self.poisoned.append(slot)


def _injector_run(pkg):
    clock = pkg.sched.FakeClock(step_s=0.01)
    sched = types.SimpleNamespace(clock=clock, engine=_StubEngine())
    inj = pkg.faults.FaultPlan([
        pkg.faults.FaultSpec(kind="latency", tick=2, delay_s=1.0),
        pkg.faults.FaultSpec(kind="nan_logits", tick=3, slot=1),
        pkg.faults.FaultSpec(kind="admit_fail", tick=4),
        pkg.faults.FaultSpec(kind="admit_fail", tick=4),
        pkg.faults.FaultSpec(kind="crash", tick=5, down_s=2.0),
    ]).injector(0)
    log = []
    for _ in range(5):
        try:
            inj.on_tick(sched)
            crashed = None
        except pkg.faults.ReplicaCrashed as e:
            crashed = str(e)
        log.append((inj.tick, clock.now(), list(sched.engine.poisoned),
                    inj.take_admit_fault(), crashed))
    log.append((inj.take_admit_fault(), inj.take_admit_fault(),
                inj.alive(clock.now()), inj.alive(clock.now() + 2.0)))
    inj.revive()
    log.append(inj.alive(clock.now()))
    # a permanent crash
    perm = pkg.faults.FaultPlan([pkg.faults.FaultSpec(
        kind="crash", tick=1)]).injector(0)
    with pytest.raises(pkg.faults.ReplicaCrashed):
        perm.on_tick(types.SimpleNamespace(clock=pkg.sched.FakeClock()))
    log.append((perm.crashed_until, perm.alive(1e12)))
    return log


def test_injector_fires_at_planned_ticks_and_crashes():
    ref, port = both(_injector_run)
    assert port == ref
    assert [e[1] for e in port[:5]] == [0.0, 1.0, 1.0, 1.0, 1.0]
    assert port[2][2] == [1]
    # two armed at tick 4: sticky until each is consumed
    assert [e[3] for e in port[:5]] == [False, False, False, True, True]
    assert port[4][4] == "injected crash at tick 5 (down_s=2.0)"
    assert port[5] == (False, False, False, True)
    assert port[6] is True
    assert port[7] == (math.inf, False)


def _driver_run(pkg):
    plan = pkg.faults.FaultPlan([pkg.faults.FaultSpec(**s)
                                 for s in _PLAN_SPECS])
    sent = []
    drv = pkg.faults.FleetFaultDriver(plan, lambda r, s: sent.append((r, s)))
    polls = [[(f.replica, f.sig) for f in drv.poll(t)]
             for t in (0.5, 1.0, 2.0, 9.0, 10.0)]
    return polls, sent, drv.done, len(drv.fired)


def test_fleet_fault_driver_fires_each_kill_once():
    ref, port = both(_driver_run)
    assert port == ref
    assert port[1] == [(0, "SIGKILL"), (1, "SIGSTOP")]
    assert port[2] is True


# ---------------------------------------------------------------- metrics
class _Alloc:
    max_slots = 4


class _SlotEng:
    allocator = _Alloc()
    num_active = 3


class _Blocks:
    num_blocks, num_used, num_shared = 9, 5, 2


class _Radix:
    def __init__(self):
        self.hit_tokens, self.miss_tokens = 24, 8


class _PagedEng:
    allocator = _Alloc()
    num_active = 2
    blocks_available = 4
    preemptions = 3
    spec_drafted_tokens = 10
    spec_accepted_tokens = 7

    def __init__(self):
        self.blocks = _Blocks()
        self.radix = _Radix()


def _metrics_run(pkg):
    Completion = pkg.sched.Completion
    reg = pkg.metrics.MetricsRegistry()
    sm = pkg.sm.ServeMetrics(reg)
    slot = types.SimpleNamespace(engine=_SlotEng(), queue=[1, 2])
    paged = types.SimpleNamespace(engine=_PagedEng(), queue=[1])
    sm.on_submit(slot)
    sm.on_tick(slot)
    sm.on_tick(paged)
    paged.engine.radix.hit_tokens = 40       # deltas, not totals
    paged.engine.preemptions = 5
    sm.on_tick(paged)
    comps = [
        Completion(rid=0, tokens=[1, 2, 3], status="eos", arrival=0.0,
                   finish=1.0, ttft=0.25, tpot=0.125, trace_id="r0",
                   tenant="acme"),
        Completion(rid=1, tokens=[4], status="length", arrival=0.5,
                   finish=2.0, ttft=0.5, tpot=None, trace_id="r1"),
        Completion(rid=2, tokens=[], status="error", arrival=1.0,
                   finish=1.5, trace_id="r2", tenant="free"),
    ]
    comps[1].trace_sampled = False           # no exemplar for it
    for c in comps:
        sm.on_complete(c, slot)
    rreg = pkg.metrics.MetricsRegistry()
    rm = pkg.sm.RouterMetrics(rreg)
    rm.retries.inc(2)
    rm.failovers.inc()
    rm.breaker_trips.inc()
    rm.brownout_active.set(1)
    rm.fleet_pressure.set(1.75)
    for reason in ("brownout", "no_replica", "brownout"):
        rm.on_shed(reason)
    for decision in ("load", "affinity", "fallback", "load"):
        rm.on_route(decision)
    for replica, state in ((0, "healthy"), (1, "dead"), (2, "removed"),
                           (1, "degraded")):
        rm.on_replica_state(replica, state)
    rm.on_scale_event("up", "slo_burn")
    rm.fleet_size.set(2)
    for c in comps:
        rm.on_finalize(c)
    freg = pkg.metrics.MetricsRegistry()
    fm = pkg.sm.FrontdoorMetrics(freg)
    fm.count("http", code=429)
    fm.count("admission_refused", reason="rate")
    fm.sse_frames.inc(12)
    return (sm.report(elapsed_s=2.0), reg.render_text(), rm.report(),
            rreg.render_text(), fm.report(), freg.render_text(),
            pkg.sm.STATE_CODES)


def test_serve_router_frontdoor_metrics_render_as_the_references():
    ref, port = both(_metrics_run)
    for got, want in zip(port, ref):
        assert got == want
    snap, text, rsnap = port[0], port[1], port[2]
    assert snap["serve_tokens_per_sec"] == pytest.approx(2.0)
    assert snap["prefix_cache_hit_tokens_total"] == 40
    assert snap["preemptions_total"] == 5
    assert snap["serve_tenant_tokens_total{tenant=acme}"] == 3
    assert "# {trace_id=\"r1\"}" not in text
    assert rsnap["serve_sheds_total{reason=brownout}"] == 2
    assert rsnap["serve_replica_state{replica=1}"] == 1.0


def test_emit_metrics_rank0_gate(monkeypatch, caplog):
    logger = port_logging.get_logger("serve_plane_gate")
    logger.propagate = True  # let caplog's root handler see it
    snap = {"serve_tokens_total": 5, "serve_ttft_s_p99": 0.25}
    want = jax_logging.emit_metrics(snap, logger)
    with caplog.at_level(logging.INFO, logger="serve_plane_gate"):
        caplog.clear()
        line = port_logging.emit_metrics(snap, logger)
        assert line == want and line.startswith("metrics ")
        assert [r.message for r in caplog.records] == [line]
        caplog.clear()
        monkeypatch.setattr(port_logging, "process_index", lambda: 1)
        assert port_logging.emit_metrics(snap, logger) is None
        assert not caplog.records
    monkeypatch.undo()
    assert port_logging.process_index() == 0   # no process group here
