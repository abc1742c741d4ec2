"""The port's serve/workload.py against the reference's: one plan's JSON
and seed expand to the same trace rows (arrival, tenant, priority,
prompt, budget) in both packages, the port's plan round-trips through
to_json/from_json, and both refuse the same malformed specs."""

import json

import pytest

import ddp_practice_tpu.serve.workload as jwl
from ddp_practice_tpu_torch.serve.workload import TenantSpec, WorkloadPlan

PLANS = {
    "poisson": {"duration_s": 3.0, "tenants": [
        {"name": "solo", "rate_rps": 12.0}]},
    "hostile_vs_chat": {"duration_s": 2.0, "tenants": [
        {"name": "bulk", "rate_rps": 80.0, "arrivals": "bursty",
         "burst_every_s": 1.0, "burst_len_s": 0.4, "burst_mult": 2.0,
         "prompt_len_mean": 32.0, "prompt_len_cap": 64,
         "max_new_mean": 16.0, "max_new_cap": 16, "hostile": True},
        {"name": "acme", "rate_rps": 20.0, "sessions": 2,
         "turns_per_session": 3, "session_prefix_len": 8,
         "prompt_len_mean": 4.0, "prompt_len_cap": 8,
         "max_new_mean": 8.0, "max_new_cap": 12}]},
    "diurnal_mix": {"duration_s": 5.0, "tenants": [
        {"name": "day", "rate_rps": 6.0, "arrivals": "diurnal",
         "diurnal_period_s": 2.0, "diurnal_depth": 0.6, "priority": 1},
        {"name": "batch", "rate_rps": 3.0, "arrivals": "bursty",
         "burst_every_s": 2.5, "burst_len_s": 0.5, "burst_mult": 6.0,
         "prompt_len_sigma": 1.2, "max_new_sigma": 0.9},
        {"name": "chat", "rate_rps": 4.0, "sessions": 3,
         "turns_per_session": 4, "session_prefix_len": 16}]},
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_build_rows_equal_the_reference(name, seed):
    text = json.dumps(PLANS[name])
    got = WorkloadPlan.from_json(text).build(vocab=256, seed=seed)
    want = jwl.WorkloadPlan.from_json(text).build(vocab=256, seed=seed)
    assert got == want
    assert got and all(set(r) >= {"rid", "arrival", "tenant", "prompt",
                                  "max_new_tokens", "priority"}
                       for r in got)
    assert [r["arrival"] for r in got] == sorted(r["arrival"] for r in got)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_round_trips_through_json(name):
    plan = WorkloadPlan.from_json(json.dumps(PLANS[name]))
    again = WorkloadPlan.from_json(plan.to_json())
    assert again.to_json() == plan.to_json()
    assert json.loads(plan.to_json()) == json.loads(
        jwl.WorkloadPlan.from_json(json.dumps(PLANS[name])).to_json())
    assert again.build(vocab=64, seed=3) == plan.build(vocab=64, seed=3)
    assert again.hostile_tenants() == plan.hostile_tenants()


@pytest.mark.parametrize("bad", [
    {"name": ""},
    {"name": "t", "rate_rps": 0.0},
    {"name": "t", "arrivals": "weekly"},
    {"name": "t", "arrivals": "bursty", "burst_len_s": 20.0},
    {"name": "t", "arrivals": "diurnal", "diurnal_depth": 1.0},
    {"name": "t", "max_new_cap": 0},
    {"name": "t", "sessions": 2, "session_prefix_len": 0},
])
def test_malformed_specs_refused_like_the_reference(bad):
    with pytest.raises(ValueError):
        jwl.TenantSpec(**bad)
    with pytest.raises(ValueError):
        TenantSpec(**bad)
