"""The port's fault-tolerant router (serve/router.py) on the CPU, at the
SMALL widths of tests/_torch_port.py with weights converted from the JAX
package's model, on FakeClock replicas.

The reference's chaos cases (tests/test_serve_router.py), held against
the port:

- a replica crashed mid-decode: none lost, every migrated request's
  greedy tokens equal a fault-free one-engine run's, no new shapes after
  warmup, and the plan replays bit for bit;
- a NaN in one slot and a failed admission each cost a retry, not an
  answer: the retried requests' tokens equal the fault-free run's;
- brown-out under overload sheds low priority (queued and at the door)
  and caps new budgets, and clears when pressure drains;
- an SLO burn trips brown-out below the pressure threshold, its own
  sheds do not feed the alert, and the trace records the story;
- a permanently dead fleet sheds instead of hanging;
- a crashed replica's half-open probe brings it back after its down
  window and it serves again;
- token streams: every event exactly once, in order, one typed end,
  resume markers at failover and retry splices, the consumer's tokens
  equal to the completion's.

One cross-package case sends one trace and one plan (crash, NaN and a
failed admission) through the reference's `make_router` and the port's:
per request the status and tokens are equal, and so are the retry,
failover and breaker counters and the final replica states. Last,
`serve_bench(replicas=2, fault_plan=..., slo=..., trace_out=...)` runs
on the CPU at lm_tiny and its report carries the reference bench's keys.
"""

import ast
import json
import pathlib

import pytest

import _torch_port  # noqa: F401  (one intra-op thread for the suite)
from _torch_port import SMALL, build_pair
from ddp_practice_tpu_torch.serve import (
    EngineConfig,
    FakeClock,
    FaultPlan,
    FaultSpec,
    Request,
    RouterConfig,
    Scheduler,
    SlotEngine,
    make_router,
)
from ddp_practice_tpu_torch.serve.bench import build_trace, serve_bench
from ddp_practice_tpu_torch.utils.trace import TraceRecorder
from tools.check_traces import validate

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOCAB = SMALL["vocab_size"]
ENGINE_CFG = dict(max_slots=2, max_len=96, prompt_buckets=(32,),
                  temperature=0.0)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0, pos_emb="rope", max_len=96)


def _trace(n, rate_hz=50.0, seed=11, max_new=(3, 7), plen=(2, 6)):
    return build_trace(n_requests=n, rate_hz=rate_hz, vocab=VOCAB,
                       prompt_len_range=plen, max_new_range=max_new,
                       seed=seed)


def _reference_tokens(model, trace, cfg):
    """A fault-free one-engine run of the same trace."""
    sched = Scheduler(SlotEngine(model, cfg), clock=FakeClock(step_s=0.01),
                      max_queue=len(trace))
    for t in trace:
        sched.submit(Request(rid=t["rid"], prompt=t["prompt"],
                             max_new_tokens=t["max_new_tokens"]))
    sched.run_until_idle()
    return {c.rid: c.tokens for c in sched.completions}


def _drive(router, trace, request_cls=Request):
    """Replay arrivals on the router's fake clock until the fleet
    drains."""
    i = 0
    while not (i >= len(trace) and router.idle):
        while i < len(trace) \
                and trace[i]["arrival"] <= router.clock.now():
            t = trace[i]
            router.submit(request_cls(
                rid=t["rid"], prompt=t["prompt"],
                max_new_tokens=t["max_new_tokens"], arrival=t["arrival"]))
            i += 1
        router.step()
    return router.completions


def test_failover_token_identity_none_lost(pair):
    _, _, model = pair
    cfg = EngineConfig(**ENGINE_CFG)
    trace = _trace(12)
    want = _reference_tokens(model, trace, cfg)
    plan = FaultPlan([FaultSpec(kind="crash", tick=6, replica=0)])

    def fleet(plan):
        router = make_router(
            model, 2, cfg, clock=FakeClock(step_s=0.01), max_queue=64,
            config=RouterConfig(max_retries=2, retry_jitter=0.0),
            fault_plan=plan)
        router.warmup()
        return router

    router = fleet(plan)
    warm = router.compile_stats()
    assert warm[1] == {"prefill_compiles": 1, "decode_compiles": 1}
    comps = _drive(router, trace)
    by_rid = {c.rid: c for c in comps}
    assert sorted(by_rid) == [t["rid"] for t in trace]
    assert router.metrics.failovers.value >= 1
    assert router.states() == {0: "dead", 1: "healthy"}
    assert all(c.status == "length" for c in comps)
    for c in comps:
        assert c.tokens == want[c.rid], f"rid {c.rid} diverged"
    assert router.compile_stats()[1] == warm[1]
    # the same plan replays bit for bit
    again = {c.rid: c for c in _drive(
        fleet(FaultPlan.from_json(plan.to_json())), trace)}
    for rid, c in by_rid.items():
        assert (again[rid].tokens, again[rid].status, again[rid].finish) \
            == (c.tokens, c.status, c.finish)


def test_nan_and_admit_faults_are_retried_to_identical_tokens(pair):
    _, _, model = pair
    cfg = EngineConfig(max_slots=2, max_len=96, prompt_buckets=(16,),
                       temperature=0.0)
    trace = _trace(4, rate_hz=1000.0, seed=3)
    want = _reference_tokens(model, trace, cfg)
    plan = FaultPlan([
        FaultSpec(kind="admit_fail", tick=1, replica=0),
        FaultSpec(kind="nan_logits", tick=4, replica=0, slot=0),
    ])
    router = make_router(
        model, 1, cfg, clock=FakeClock(step_s=0.01), max_queue=64,
        config=RouterConfig(max_retries=3, retry_base_s=0.01,
                            retry_jitter=0.0, trip_after=10),
        fault_plan=plan)
    router.warmup()
    comps = _drive(router, trace)
    assert sorted(c.rid for c in comps) == [0, 1, 2, 3]
    assert router.metrics.retries.value >= 2
    assert router.metrics.breaker_trips.value == 0
    assert router.states()[0] == "healthy"
    for c in comps:
        assert c.status == "length"
        assert c.tokens == want[c.rid], f"rid {c.rid} diverged"


def test_brownout_sheds_low_priority_and_caps_budget(pair):
    _, _, model = pair
    cfg = EngineConfig(max_slots=1, max_len=96, prompt_buckets=(8,),
                       temperature=0.0)
    router = make_router(
        model, 1, cfg, clock=FakeClock(step_s=0.01), max_queue=64,
        config=RouterConfig(brownout_on=2.0, brownout_off=0.5,
                            brownout_max_new=2, shed_priority=1,
                            retry_jitter=0.0))
    router.warmup()
    for rid, p in enumerate([0, 0, 0, 1, 1, 0]):
        assert router.submit(Request(rid=rid, prompt=[1 + rid, 2],
                                     max_new_tokens=6, priority=p))
    router.step()
    assert router.brownout and router.metrics.brownout_active.value == 1
    snap = router.metrics.registry.snapshot()
    assert snap["serve_sheds_total{reason=brownout}"] == 2
    assert not router.submit(Request(rid=6, prompt=[7, 2],
                                     max_new_tokens=6, priority=1))
    assert router.submit(Request(rid=7, prompt=[8, 2], max_new_tokens=6,
                                 priority=0))
    router.run_until_idle()
    by_rid = {c.rid: c for c in router.completions}
    assert {r: by_rid[r].status for r in (3, 4, 6)} == {
        3: "shed", 4: "shed", 6: "shed"}
    for rid in (0, 1, 2, 5):
        assert by_rid[rid].status == "length"
        assert len(by_rid[rid].tokens) == 6
    assert by_rid[7].status == "length" and len(by_rid[7].tokens) == 2
    assert not router.brownout
    assert router.metrics.brownout_active.value == 0
    assert router.metrics.registry.snapshot()[
        "serve_sheds_total{reason=brownout}"] == 3


def test_slo_burn_trips_brownout_below_pressure_threshold(pair):
    from ddp_practice_tpu_torch.serve.slo import SLOConfig, SLOWatchdog

    _, _, model = pair
    cfg = EngineConfig(max_slots=4, max_len=96, prompt_buckets=(8,),
                       temperature=0.0)
    clock = FakeClock(step_s=0.01)
    tracer = TraceRecorder(clock=clock)
    watchdog = SLOWatchdog(
        SLOConfig(availability=0.9, fast_window_s=0.5, slow_window_s=2.0,
                  trip_burn=2.0, resolve_burn=1.0, min_events=3),
        clock=clock, tracer=tracer)
    router = make_router(
        model, 1, cfg, clock=clock, max_queue=64,
        config=RouterConfig(brownout_on=50.0, brownout_off=0.4,
                            brownout_max_new=2, shed_priority=1,
                            retry_jitter=0.0),
        tracer=tracer, slo=watchdog)
    router.warmup()
    tracer.clear()
    for rid in range(5):        # five expired deadlines: five timeouts
        router.submit(Request(rid=rid, prompt=[1 + rid, 2],
                              max_new_tokens=4, deadline=-1.0))
    router.step()
    assert watchdog.active and router.brownout
    assert router.metrics.fleet_pressure.value < 50.0
    assert not router.submit(Request(rid=10, prompt=[3, 2],
                                     max_new_tokens=6, priority=1))
    assert router.submit(Request(rid=11, prompt=[4, 2], max_new_tokens=6,
                                 priority=0))
    router.run_until_idle()
    by_rid = {c.rid: c for c in router.completions}
    assert by_rid[10].status == "shed"
    assert by_rid[11].status == "length" and len(by_rid[11].tokens) == 2
    # anti-windup: the brown-out's own shed is no availability failure
    assert sum(flags.get("availability", False)
               for _, flags in watchdog._events) == 5
    assert router.metrics.fleet_pressure.value <= 0.4 and router.brownout
    for _ in range(400):
        router.step()
        if not router.brownout:
            break
    assert not watchdog.active and not router.brownout
    assert [e for _, e, _ in watchdog.alert_log] == ["trip", "resolve"]
    trace = tracer.to_chrome_trace()
    assert validate(trace) == []
    by_name = {}
    for ev in trace["traceEvents"]:
        by_name.setdefault(ev["name"], []).append(ev)
    assert "slo_alert" in by_name and "slo_resolve" in by_name
    assert by_name["brownout_on"][0]["args"]["trigger"] == "slo"
    assert "brownout_off" in by_name


def test_permanently_dead_fleet_sheds_not_hangs(pair):
    _, _, model = pair
    cfg = EngineConfig(max_slots=2, max_len=96, prompt_buckets=(8,),
                       temperature=0.0)
    router = make_router(
        model, 1, cfg, clock=FakeClock(step_s=0.01), max_queue=64,
        config=RouterConfig(retry_jitter=0.0),
        fault_plan=FaultPlan([FaultSpec(kind="crash", tick=3,
                                        replica=0)]))
    router.warmup()
    for rid in range(4):
        router.submit(Request(rid=rid, prompt=[1 + rid, 2],
                              max_new_tokens=8))
    router.run_until_idle(max_ticks=500)
    assert router.idle
    assert sorted(c.rid for c in router.completions) == [0, 1, 2, 3]
    assert all(c.status in ("length", "shed") for c in router.completions)
    assert any(c.status == "shed" for c in router.completions)
    assert router.metrics.registry.snapshot()[
        "serve_sheds_total{reason=no_replica}"] >= 1
    assert not router.submit(Request(rid=9, prompt=[3], max_new_tokens=2))
    assert router.completions[-1].status == "shed"


def test_replica_recovery_after_down_window(pair):
    _, _, model = pair
    cfg = EngineConfig(max_slots=2, max_len=96, prompt_buckets=(8,),
                       temperature=0.0)
    router = make_router(
        model, 2, cfg, clock=FakeClock(step_s=0.01), max_queue=64,
        config=RouterConfig(probe_base_s=0.05, probe_jitter=0.0,
                            retry_jitter=0.0),
        fault_plan=FaultPlan([FaultSpec(kind="crash", tick=2, replica=0,
                                        down_s=0.2)]))
    router.warmup()
    for rid in range(4):
        router.submit(Request(rid=rid, prompt=[1 + rid, 2, 3],
                              max_new_tokens=4))
    router.run_until_idle()
    assert all(c.status == "length" for c in router.completions)
    assert router.metrics.breaker_trips.value == 1
    for _ in range(60):
        if router.states()[0] == "healthy":
            break
        router.step()
    assert router.states()[0] == "healthy"
    router.submit(Request(rid=99, prompt=[5, 6], max_new_tokens=3))
    router.run_until_idle()
    assert {c.rid: c.status for c in router.completions}[99] == "length"


def test_token_streams_exactly_once_in_order(pair):
    """A crash mid-decode and an error retry on a 2-replica fleet: each
    stream's events come once each, seq contiguous from 0, one typed end
    last, resume markers at the splices, no gap, and the consumer's
    tokens equal the completion's and the fault-free run's."""
    _, _, model = pair
    cfg = EngineConfig(max_slots=2, max_len=96, prompt_buckets=(32,),
                       temperature=0.0, decode_burst=2)
    trace = _trace(8, max_new=(6, 12))
    want = _reference_tokens(model, trace, cfg)
    router = make_router(
        model, 2, cfg, clock=FakeClock(step_s=0.01), max_queue=64,
        config=RouterConfig(max_retries=3, retry_jitter=0.0),
        fault_plan=FaultPlan([
            FaultSpec(kind="crash", tick=4, replica=0),
            FaultSpec(kind="nan_logits", tick=5, replica=1, slot=0)]))
    router.warmup()
    comps = {c.rid: c for c in _drive(router, trace)}
    assert sorted(comps) == [t["rid"] for t in trace]
    reasons = []
    for rid, c in comps.items():
        st = router.stream(rid)
        assert c.status == "length" and c.tokens == want[rid]
        assert st.closed and st.status == "length"
        assert st.tokens() == c.tokens
        assert [ev.seq for ev in st.events] == list(range(len(st.events)))
        kinds = [ev.kind for ev in st.events]
        assert kinds.count("end") == 1 and kinds[-1] == "end"
        assert kinds.count("tokens") >= 2 and st.gaps == 0
        starts = [ev.start for ev in st.events if ev.kind == "tokens"]
        assert starts == sorted(starts)
        reasons += [ev.attrs["reason"] for ev in st.events
                    if ev.kind == "resumed"]
    assert "failover" in reasons and "retry" in reasons
    assert router.metrics.failovers.value >= 1
    assert router.metrics.retries.value >= 1


# ---------------------------------------------------- the two packages
CHAOS_PLAN = [
    dict(kind="admit_fail", tick=2, replica=1),
    dict(kind="nan_logits", tick=6, replica=1, slot=0),
    dict(kind="crash", tick=5, replica=0, down_s=0.05),
]


def router_config(pkg_config=RouterConfig):
    return pkg_config(max_retries=3, retry_base_s=0.01, retry_jitter=0.0,
                      probe_base_s=0.02, probe_jitter=0.0)


@pytest.fixture(scope="module")
def jax_chaos(pair):
    """The reference's fleet under CHAOS_PLAN, built once."""
    from ddp_practice_tpu.serve import (
        EngineConfig as JaxEngineConfig,
        FakeClock as JaxFakeClock,
        FaultPlan as JaxFaultPlan,
        FaultSpec as JaxFaultSpec,
        Request as JaxRequest,
        RouterConfig as JaxRouterConfig,
        make_router as jax_make_router,
    )

    jm, params, _ = pair
    router = jax_make_router(
        jm, params, 2, JaxEngineConfig(**ENGINE_CFG),
        clock=JaxFakeClock(step_s=0.01), max_queue=64,
        config=router_config(JaxRouterConfig),
        fault_plan=JaxFaultPlan([JaxFaultSpec(**s) for s in CHAOS_PLAN]))
    router.warmup()
    comps = _drive(router, _trace(10), JaxRequest)
    m = router.metrics
    return ({c.rid: (c.status, list(c.tokens)) for c in comps},
            (m.retries.value, m.failovers.value, m.breaker_trips.value),
            router.states())


def test_chaos_plan_matches_the_reference_router(pair, jax_chaos):
    _, _, model = pair
    router = make_router(
        model, 2, EngineConfig(**ENGINE_CFG),
        clock=FakeClock(step_s=0.01), max_queue=64,
        config=router_config(),
        fault_plan=FaultPlan([FaultSpec(**s) for s in CHAOS_PLAN]))
    router.warmup()
    comps = _drive(router, _trace(10))
    m = router.metrics
    got = ({c.rid: (c.status, list(c.tokens)) for c in comps},
           (m.retries.value, m.failovers.value, m.breaker_trips.value),
           router.states())
    assert got[0] == jax_chaos[0]
    assert got[1] == jax_chaos[1]
    assert got[2] == jax_chaos[2]
    retries, failovers, trips = got[1]
    assert retries >= 2 and failovers >= 1 and trips >= 1
    assert all(s == "length" for s, _ in got[0].values())


# ------------------------------------------------------------ the bench
def _reference_report_keys():
    """The keys the reference bench's serve_bench report and router row
    carry, read from its source (ddp_practice_tpu/serve/bench.py)."""
    tree = ast.parse((ROOT / "ddp_practice_tpu" / "serve"
                      / "bench.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def keys(fn, var):
        out = set()
        for node in ast.walk(fns[fn]):
            if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Name) \
                    and node.targets[0].id == var \
                    and isinstance(node.value, ast.Dict):
                out |= {k.value for k in node.value.keys
                        if isinstance(k, ast.Constant)}
            if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Subscript) \
                    and isinstance(node.targets[0].value, ast.Name) \
                    and node.targets[0].value.id == var \
                    and isinstance(node.targets[0].slice, ast.Constant):
                out.add(node.targets[0].slice.value)
        return out

    return keys("serve_bench", "report"), keys("_run_router", "out")


def test_serve_bench_router_row_carries_the_reference_keys(tmp_path):
    path = tmp_path / "t.json"
    plan = FaultPlan([FaultSpec(kind="crash", tick=3, replica=1,
                                down_s=0.05),
                      FaultSpec(kind="admit_fail", tick=2, replica=0)])
    report = serve_bench(
        n_requests=6, rate_hz=100.0, device="cpu", replicas=2,
        fault_plan=plan, max_new_range=(2, 24), eos_id=None,
        slo='{"ttft_p99_s": 5.0, "error_rate": 0.5}',
        trace_out=str(path))
    top, row = _reference_report_keys()
    # the reference keys of what this run produced (no telemetry plane,
    # no paged row), and the port's additions
    top -= {"paged", "paged_vs_static", "paged_vs_continuous", "telemetry"}
    assert top <= set(report), top - set(report)
    assert row <= set(report["router"]), row - set(report["router"])
    assert {"decode_steps", "kernel_launches", "warm_compile_stats"} \
        <= set(report["router"])
    r = report["router"]
    assert r["statuses"] == {"length": 6} and r["completions"] == 6
    assert r["failovers"] >= 1 and r["retries"] >= 1
    assert r["compile_stats"] == r["warm_compile_stats"]
    assert json.loads(report["fault_plan"]) == json.loads(plan.to_json())
    assert validate(json.loads(path.read_text())) == []
    assert report["trace_events"] > 0
    json.dumps(report)


# ------------------------------------------------------------- the CLI
def test_cli_serve_replicas_with_plan_slo_and_trace(tmp_path, capsys):
    from ddp_practice_tpu_torch import cli

    path = tmp_path / "t.json"
    plan = json.dumps({"faults": [
        {"kind": "crash", "tick": 3, "replica": 1, "down_s": 0.05},
        {"kind": "admit_fail", "tick": 2, "replica": 0}]})
    assert cli.main(["serve", "--replicas", "2", "--fault-plan", plan,
                     "--slo", '{"ttft_p99_s": 5.0, "error_rate": 0.5}',
                     "--trace_out", str(path), "--device", "cpu",
                     "--requests", "4", "--rate", "100",
                     "--max-new-range", "2,12"]) == 0
    out = capsys.readouterr().out
    assert "router x2" in out and "under injected faults" in out
    assert validate(json.loads(path.read_text())) == []


@pytest.mark.parametrize("argv,message", [
    (["--fault-plan", '{"faults": []}'], "--fault-plan needs --replicas"),
    (["--slo", '{"error_rate": 0.1}'], "--slo needs --replicas"),
    (["--replicas", "1", "--alert-sink", "jsonl:a.jsonl"],
     "--alert-sink needs --slo"),
])
def test_fleet_flags_without_their_partner_are_refused(argv, message):
    from ddp_practice_tpu_torch.serve import bench

    with pytest.raises(SystemExit, match=message):
        bench.main(argv + ["--device", "cpu"])


LATER = [("--metrics-port", "0", "A6d"),
         ("--telemetry-out", "t.jsonl", "A6d"), ("--scrape-hz", "5", "A6d"),
         ("--otlp-out", "o.json", "A6d"),
         ("--otlp-endpoint", "http://localhost:1/v1/traces", "A6d"),
         ("--otlp-push-overhead", None, "A6d"),
         ("--trace-overhead", None, "A6d"), ("--trace-sampling", None, "A6d"),
         ("--adaptive-sampling", None, "A6d"),
         ("--trace-budget-sps", "100", "A6d")]


KILL = '{"faults": [{"kind": "kill", "replica": 0, "at_s": 0.5}]}'
WORKLOAD = '{"duration_s": 1.0, "tenants": [{"name": "a"}]}'
# (argv, the bench it must reach, keyword arguments it must receive)
PORTED = [
    (["--frontdoor"], "frontdoor_bench",
     dict(procs=2, n_requests=32, sse_out=None, device="cpu",
          model_name="lm_tiny", precision="fp32")),
    (["--frontdoor", "--sse-out", "s.jsonl", "--procs", "3", "--rate",
      "40"], "frontdoor_bench",
     dict(procs=3, sse_out="s.jsonl", rate_hz=40.0)),
    (["--frontdoor", "--model", "lm_base", "--precision", "bf16"],
     "frontdoor_bench",
     dict(model_name="lm_base", precision="bf16", vocab=256, hidden=None,
          depth=None, heads=None, mlp=None)),
    (["--qos"], "qos_bench",
     dict(rate_hz=100.0, duration_s=2.0, procs=2, workload=None, slo=None,
          device="cpu")),
    (["--qos", "--qos-duration", "1.5", "--procs", "4", "--rate", "60"],
     "qos_bench", dict(duration_s=1.5, procs=4, rate_hz=60.0)),
    (["--qos", "--workload", WORKLOAD, "--slo", '{"ttft_p99_s": 0.2}'],
     "qos_bench", dict(workload=WORKLOAD, slo='{"ttft_p99_s": 0.2}')),
    (["--procs", "2"], "fleet_bench",
     dict(procs=2, n_requests=32, max_len=128, prompt_buckets=(8, 16),
          device="cpu", hidden=128, eos_id=46)),
    (["--procs", "3", "--fault-plan", KILL, "--max_slots", "2"],
     "fleet_bench", dict(procs=3, max_slots=2, fault_plan=KILL)),
    (["--procs", "2", "--streaming"], "streaming_bench",
     dict(procs=2, n_requests=32, device="cpu")),
    (["--procs", "2", "--streaming", "--fault-plan", KILL, "--requests",
      "9"], "streaming_bench", dict(n_requests=9, fault_plan=KILL)),
    # the elastic fleet (ROADMAP A6c-2)
    (["--procs", "2", "--cache-aware"], "cache_routing_bench",
     dict(procs=2, n_requests=32, block_size=16, device="cpu", hidden=128,
          model_name="lm_tiny", precision="fp32")),
    (["--procs", "3", "--autoscale"], "fleet_autoscale_bench",
     dict(procs=3, autoscale_max=3, standby=1, device="cpu", hidden=128,
          model_name="lm_tiny", precision="fp32")),
    (["--autoscale-max", "4", "--procs", "3", "--autoscale"],
     "fleet_autoscale_bench", dict(autoscale_max=4, procs=3, standby=1)),
    (["--standby", "2", "--procs", "2", "--autoscale", "--rate", "50",
      "--model", "lm_base"], "fleet_autoscale_bench",
     dict(standby=2, procs=2, rate_hz=50.0, model_name="lm_base",
          vocab=256, hidden=None)),
]


@pytest.mark.parametrize("argv,bench_name,want", PORTED,
                         ids=[" ".join(a[:3]) for a, _, _ in PORTED])
def test_ported_fleet_flags_reach_their_bench(argv, bench_name, want,
                                              monkeypatch, capsys):
    """Each flag of the front door, QoS, fleet, cache-routing and
    autoscale benches reaches its bench with the parsed arguments (the
    bench itself is recorded, not run: nothing is spawned)."""
    from ddp_practice_tpu_torch.serve import bench

    calls = []

    def record(**kw):
        calls.append(kw)
        return {"recorded": True}

    for name in ("frontdoor_bench", "qos_bench", "fleet_bench",
                 "streaming_bench", "cache_routing_bench",
                 "fleet_autoscale_bench"):
        monkeypatch.setattr(bench, name, record if name == bench_name
                            else None)
    assert bench.main(argv + ["--device", "cpu", "--json"]) == 0
    assert len(calls) == 1
    got = dict(calls[0])
    if "fault_plan" in got:
        got["fault_plan"] = got["fault_plan"].to_json()
        want = dict(want, fault_plan=bench_fault_json(want["fault_plan"]))
    assert {k: got.get(k, "<absent>") for k in want} == want
    assert json.loads(capsys.readouterr().out) == {"recorded": True}


def bench_fault_json(text):
    from ddp_practice_tpu_torch.serve.faults import FaultPlan

    return FaultPlan.from_json(text).to_json()


def test_streaming_without_procs_is_refused():
    from ddp_practice_tpu_torch.serve import bench

    with pytest.raises(SystemExit, match="--streaming needs --procs"):
        bench.main(["--streaming", "--device", "cpu"])


@pytest.mark.parametrize("flag,value,item", LATER,
                         ids=[f for f, _, _ in LATER])
def test_later_slice_flags_name_their_roadmap_item(flag, value, item):
    from ddp_practice_tpu_torch.serve import bench

    argv = [flag] + ([value] if value is not None else [])
    with pytest.raises(NotImplementedError,
                       match=f"{flag} is not ported yet \\(ROADMAP {item}\\)"):
        bench.main(argv + ["--replicas", "2", "--device", "cpu"])
