"""The port's SLO watchdog and alert sinks (serve/slo.py) against the JAX
package's, on the CPU.

Each case runs one scenario through both packages and holds the port's
observables to the reference's (and to the values tests/test_slo.py and
tests/test_zalerts.py pin):

- `SLOConfig` from a JSON string, a file and a dict, its refusals, and
  `classify`;
- one completion sequence fed to an `SLOWatchdog` on a hand-advanced
  clock gives the reference's `alert_log`, `alerts`, burn reports,
  registry and trace instants: a fast-window trip, the min-events gate,
  a slow-window resolve, no flapping in the hysteresis band, and the p99
  latency objective;
- `TenantSLORegistry` gives each tenant its own budget, folds tenants
  past the cap into "other", and reports the reference's burning set;
- `AlertSinks`: spec parsing, retries on the shared backoff schedule,
  the dead-sink breaker (half-open, one kept edge), the bounded queue,
  real jsonl and command deliveries; `FleetAlerts` raises the
  reference's edges on worker status changes.
"""

import json
import types

import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from ddp_practice_tpu.serve import scheduler as jax_scheduler
from ddp_practice_tpu.serve import slo as jax_slo
from ddp_practice_tpu.utils import metrics as jax_metrics
from ddp_practice_tpu.utils import trace as jax_trace
from ddp_practice_tpu_torch.serve import scheduler, slo
from ddp_practice_tpu_torch.utils import metrics, trace

REF = types.SimpleNamespace(slo=jax_slo, sched=jax_scheduler,
                            metrics=jax_metrics, trace=jax_trace)
PORT = types.SimpleNamespace(slo=slo, sched=scheduler, metrics=metrics,
                             trace=trace)


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


class Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def _cfg(pkg, **kw):
    base = dict(error_rate=0.1, fast_window_s=1.0, slow_window_s=5.0,
                trip_burn=2.0, resolve_burn=1.0, min_events=3)
    return pkg.slo.SLOConfig(**{**base, **kw})


def _feed(wd, t0, n, status, spacing=0.01, **kw):
    for i in range(n):
        wd.observe_event(t=t0 + i * spacing, status=status, **kw)


# --------------------------------------------------------------- config
def test_config_round_trips_and_classify(tmp_path):
    want = slo.SLOConfig(ttft_p99_s=0.5, error_rate=0.01)
    text = '{"ttft_p99_s": 0.5, "error_rate": 0.01}'
    assert slo.SLOConfig.from_json(text) == want
    assert want.to_json() == jax_slo.SLOConfig.from_json(text).to_json()
    p = tmp_path / "slo.json"
    p.write_text(want.to_json())
    assert slo.SLOConfig.from_json(str(p)) == want
    assert slo.SLOConfig.from_json(json.loads(want.to_json())) == want
    for bad in ('{"nonsense_key": 1}', "no-such-file.json"):
        with pytest.raises(ValueError):
            slo.SLOConfig.from_json(bad)
    with pytest.raises(ValueError):
        slo.SLOConfig(error_rate=0.1, trip_burn=1.0, resolve_burn=2.0)
    with pytest.raises(ValueError):
        slo.SLOConfig(availability=1.0).objectives()
    with pytest.raises(ValueError):
        slo.SLOConfig().objectives()
    cfgs = [dict(ttft_p99_s=0.5, availability=0.9),
            dict(tpot_p99_s=0.02, error_rate=0.05),
            dict(ttft_p99_s=0.1, tpot_p99_s=0.01, error_rate=0.1,
                 availability=0.99)]
    events = [dict(status=s, ttft=ttft, tpot=tpot)
              for s in ("length", "eos", "shed", "error", "timeout")
              for ttft in (None, 0.05, 0.6) for tpot in (None, 0.015)]
    for c in cfgs:
        mine, ref = slo.SLOConfig(**c), jax_slo.SLOConfig(**c)
        assert mine.objectives() == ref.objectives()
        assert [slo.classify(mine, **e) for e in events] \
            == [jax_slo.classify(ref, **e) for e in events]
    assert slo.classify(slo.SLOConfig(ttft_p99_s=0.5, availability=0.9),
                        status="shed", ttft=None) == {"availability": True}


# ----------------------------------------------------------- windowing
def _windows_run(pkg):
    """Trip, hold, resolve, band-burn, re-clear on one error-rate
    watchdog; a p99 TTFT watchdog fed Completions; everything each
    exposes."""
    clock = Clock()
    reg = pkg.metrics.MetricsRegistry()
    rec = pkg.trace.TraceRecorder(clock=clock)
    pkg.trace.label_router(rec)
    wd = pkg.slo.SLOWatchdog(_cfg(pkg), clock=clock, registry=reg,
                             tracer=rec)
    log = []
    _feed(wd, 0.0, 2, "error")        # under min_events: no trip
    log.append(wd.evaluate(0.05, force=True))
    _feed(wd, 0.02, 3, "error")
    log.append(wd.evaluate(0.1))      # 100% bad vs 10%: burn 10, trips
    log.append(wd.evaluate(2.0))      # holds until the slow window clears
    _feed(wd, 2.0, 45, "eos")
    log.append(wd.evaluate(2.6))      # 5/50 bad = budget: resolves
    t = 3.0
    _feed(wd, t, 10, "error")
    log.append(wd.evaluate(t + 0.2))  # trips again
    t += 0.3
    for _ in range(8):                # burn 1.5, inside the band: hold
        _feed(wd, t, 3, "error", spacing=0.001)
        _feed(wd, t + 0.01, 17, "eos", spacing=0.001)
        t += 0.5
        log.append(wd.evaluate(t))
    log.append(wd.evaluate(t + 6.0))  # everything aged out: resolve
    t += 6.0
    for _ in range(4):                # band again: no re-trip
        _feed(wd, t, 3, "error", spacing=0.001)
        _feed(wd, t + 0.01, 17, "eos", spacing=0.001)
        t += 0.5
        log.append(wd.evaluate(t))
    lat = pkg.slo.SLOWatchdog(_cfg(pkg, error_rate=None, ttft_p99_s=0.5),
                              clock=clock)
    for i in range(10):
        lat.observe(pkg.sched.Completion(
            rid=i, tokens=[1, 2], status="length", arrival=0.0,
            finish=0.01 * i, ttft=0.8, tpot=0.01))
    lat_log = [lat.evaluate(0.2), lat.active, lat.evaluate(6.0),
               lat.active, lat.burn_signal()]
    return (log, wd.alert_log, dict(wd.alerts), wd.active,
            wd.burn_signal(), reg.snapshot(), rec.to_chrome_trace(),
            lat_log, lat.alert_log)


def test_watchdog_alert_log_equals_the_references():
    ref, port = both(_windows_run)
    for got, want in zip(port, ref):
        assert got == want
    log, alert_log, alerts, active = port[:4]
    assert [e for _, e, _ in alert_log] == ["trip", "resolve", "trip",
                                            "resolve"]
    assert not log[0]["error_rate"]["active"]            # min-events gate
    assert log[1]["error_rate"]["burn_fast"] == 10.0
    assert log[2]["error_rate"]["active"]                # slow to resolve
    assert all(r["error_rate"]["active"] for r in log[5:13])  # no flap
    assert not any(r["error_rate"]["active"] for r in log[13:])
    assert alerts == {"error_rate": False} and not active
    assert port[5]["slo_alerts_total"] == 2
    names = [e["name"] for e in port[6]["traceEvents"] if e["ph"] == "i"]
    assert names == ["slo_alert", "slo_resolve", "slo_alert", "slo_resolve"]
    lat_log = port[7]
    assert lat_log[1] is True and lat_log[3] is False


def _tenants_run(pkg):
    clock = Clock()
    reg = pkg.metrics.MetricsRegistry()
    tr = pkg.slo.TenantSLORegistry(
        _cfg(pkg), clock=clock, registry=reg, max_tenants=3,
        overrides={"batch": _cfg(pkg, error_rate=0.5)})
    out = []
    for i in range(12):
        for tenant, status in (("hostile", "error"), ("ok", "length"),
                               ("batch", "error" if i % 3 else "eos"),
                               (None, "length"), ("late", "error")):
            tr.observe(pkg.sched.Completion(
                rid=i, tokens=[1], status=status, arrival=0.0,
                finish=0.01 * i, tenant=tenant))
    out.append(tr.evaluate(0.2, force=True))
    out += [tr.active, tr.burning_tenants(), tr.is_burning("hostile"),
            tr.is_burning("ok"), tr.is_burning("late"),
            tr.is_burning("never-seen"), tr.alert_log, tr.burn_signal()]
    out.append(tr.evaluate(7.0, force=True))
    out += [tr.active, tr.alert_log, reg.snapshot()]
    return out


def test_tenant_registry_scopes_budgets_as_the_reference():
    ref, port = both(_tenants_run)
    assert port == ref
    # past the cap of 3, the default tenant and "late" share "other",
    # which burns; "batch" runs under its relaxed override (burn 1.33)
    assert port[2] == ["hostile", "other"]
    # hostile, ok, late, never-seen: an unseen tenant past the cap
    # answers for the shared "other" budget
    assert port[3:7] == [True, False, True, True]
    assert port[10] is False
    assert [(e, tenant) for _, e, _, tenant in port[11]] == [
        ("trip", "hostile"), ("trip", "other"), ("resolve", "hostile"),
        ("resolve", "other")]


# ----------------------------------------------------------- alert sinks
def test_sink_spec_parse_forms():
    for text in ("jsonl:/tmp/a.jsonl", "command:notify -u ops",
                 "http://pager.example:8080/hook", "webhook:https://h/x"):
        mine = slo.AlertSinkSpec.parse(text)
        ref = jax_slo.AlertSinkSpec.parse(text)
        assert (mine.kind, mine.target) == (ref.kind, ref.target)
    assert slo.AlertSinkSpec.parse("http://p:1/h").kind == "webhook"
    for bad in ("bogus", "smoke:signals"):
        with pytest.raises(ValueError):
            slo.AlertSinkSpec.parse(bad)


def _sinks_run(pkg):
    """Backoff retries, the dead-sink breaker going half-open with one
    kept edge, recovery by probe, the bounded queue."""
    clock = Clock()
    calls = []
    reg = pkg.metrics.MetricsRegistry()
    back = {"up": False}
    sinks = pkg.slo.AlertSinks(
        ["command:x", "jsonl:y"], clock=clock, registry=reg,
        max_failures=3, base_s=0.5, max_s=30.0, seed=3,
        deliver=lambda s, e: (calls.append((clock.t, s.kind,
                                            e.get("objective"))),
                              s.kind == "jsonl" or back["up"])[1])
    sinks.send({"event": "trip", "objective": "a"})
    states = [sinks.state()]
    for t in (0.4, 0.6, 1.2, 2.0, 3.0, 10.0):
        clock.t = t
        sinks.flush()
        states.append(sinks.state())
    sinks.send({"event": "trip", "objective": "b"})     # replaces the kept
    sinks.send({"event": "resolve", "objective": "b"})
    states.append(sinks.state())
    clock.t = 10.0 + sinks.probe_cooldown_s - 1e-6
    sinks.flush()
    back["up"] = True
    clock.t = 200.0
    sinks.flush()                                       # probe delivers
    states.append((sinks.state(), sinks.any_alive))
    sinks.send({"event": "trip", "objective": "c"})
    states.append(sinks.state())
    bounded = pkg.slo.AlertSinks(["command:x"], clock=lambda: 0.0,
                                 max_failures=10**9, base_s=10.0,
                                 deliver=lambda s, e: False)
    for i in range(pkg.slo.AlertSinks.PENDING_CAP + 7):
        bounded.send({"event": "trip", "i": i})
    return calls, states, reg.snapshot(), bounded.state()


def test_alert_sinks_backoff_breaker_and_queue_as_the_reference():
    ref, port = both(_sinks_run)
    assert port == ref
    calls, states, snap, bounded = port
    cmd = [c for c in calls if c[1] == "command"]
    assert cmd[0][0] == 0.0 and len(cmd) >= 4
    dead = {s["sink"]: s for s in states[-4]}["command:x"]
    assert dead["dead"] and dead["pending"] == 1
    # two sends to the dead sink: the newest replaces the kept edge
    dead = {s["sink"]: s for s in states[-3]}["command:x"]
    assert dead["pending"] == 1 and dead["dropped"] == 2
    alive, any_alive = states[-2]
    assert any_alive and not {s["sink"]: s for s in alive}["command:x"][
        "dead"]
    assert bounded[0]["pending"] == slo.AlertSinks.PENDING_CAP
    assert bounded[0]["dropped"] >= 7


def test_jsonl_and_command_delivery(tmp_path):
    path = tmp_path / "alerts.jsonl"
    sinks = slo.AlertSinks([f"jsonl:{path}", "command:true"],
                           clock=lambda: 0.0)
    sinks.send({"kind": "alert", "event": "trip", "objective": "x"})
    sinks.send({"kind": "alert", "event": "resolve", "objective": "x"})
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["event"] for x in lines] == ["trip", "resolve"]
    st = {s["sink"]: s for s in sinks.state()}
    assert st["command:true"]["delivered"] == 2
    bad = slo.AlertSinks(["command:false"], clock=lambda: 0.0,
                         max_failures=1)
    bad.send({"event": "trip"})
    assert not bad.any_alive


def _pushed_run(pkg):
    clock = Clock()
    got = []
    sinks = pkg.slo.AlertSinks(
        ["jsonl:unused"], clock=clock,
        deliver=lambda s, e: got.append(dict(e)) or True)
    wd = pkg.slo.SLOWatchdog(
        _cfg(pkg, slow_window_s=2.0), clock=clock, sinks=sinks)
    for _ in range(6):
        wd.observe_event(t=clock.t, status="error")
        clock.t += 0.05
    wd.evaluate(clock.t, force=True)
    clock.t += 3.0
    wd.evaluate(clock.t, force=True)
    fa_got = []
    fa = pkg.slo.FleetAlerts(
        pkg.slo.AlertSinks(["jsonl:x"], clock=clock,
                           deliver=lambda s, e: fa_got.append(dict(e))
                           or True),
        registry=pkg.metrics.MetricsRegistry(), clock=clock)
    hz = {"workers": {"0": {"status": "healthy"},
                      "1": {"status": "healthy"}}}
    edges = [fa.observe(hz)]
    for status in ("stale", "dead", "healthy"):
        hz["workers"]["1"]["status"] = status
        clock.t += 1.0
        edges.append(fa.observe(hz))
    return got, edges, fa_got, fa.alert_log


def test_watchdog_and_fleet_edges_reach_sinks_as_the_reference():
    ref, port = both(_pushed_run)
    assert port == ref
    got, edges = port[0], port[1]
    assert [(e["event"], e["objective"], e["scope"]) for e in got] == [
        ("trip", "error_rate", "slo"), ("resolve", "error_rate", "slo")]
    assert [sorted((e["event"], e["objective"]) for e in es)
            for es in edges] == [
        [], [("trip", "worker_stale")],
        [("resolve", "worker_stale"), ("trip", "worker_dead")],
        [("resolve", "worker_dead")]]
