"""Serving benches on the card (counterpart of
ddp_practice_tpu/serve/bench.py: serve_bench with its continuous, static,
paged and router rows, shared_prefix_bench, spec_decode_bench, and the
front door, QoS and worker-fleet benches).

- serve_bench: one synthetic Poisson trace (seeded NumPy) through
  - continuous: SlotEngine + Scheduler on the monotonic clock; requests
    join the running decode batch at slot granularity and release at
    their own length;
  - static: the one-shot generator (inference.make_generate_fn) at batch
    = max_slots, every prompt padded to the largest bucket and every
    request run to the trace's largest token budget; arrivals wait for
    the whole batch;
  - paged (`paged=True`): PagedEngine + Scheduler, per-slot capacity
    sized to the trace's worst context;
  - router (`replicas=N`): the same trace through N SlotEngine replicas
    behind the fault-tolerant router (serve/router.py) on one card, under
    an optional FaultPlan (the row is then goodput under faults) and an
    optional SLO watchdog (its alert log rides the row); `replicas=1`
    measures the router's own cost against the continuous row;
  every server scored on the tokens each request asked for.
- shared_prefix_bench: K system prompts x short tails through the plain
  paged engine and the prefix-sharing engine at the same undersized
  pool; goodput ratio, hit/miss tokens, preemptions (`kv_int8`: an int8
  pool, halved KV bytes per token).
- spec_decode_bench: repeated-motif prompts through the plain paged
  engine and the speculative-decoding engine; TPOT ratio, accept rate,
  token identity.

Timed windows close with a host readback of tokens, which waits for the
device. Warmup runs before the trace clock starts. Each row reports
`decode_steps`, the single-token model applications it ran (warmup
included), and `kernel_launches`, the decode-attention kernel launches it
caused, so a caller can hold each kernel's launches against depth x
steps row by row.

`trace_out` (`--trace_out`) writes the request-lifecycle timeline
(utils/trace.py) as Chrome trace JSON: the router run's when
`replicas >= 1`, else the continuous run's, warmup spans dropped;
tools/check_traces.py validates it.

Checkpoint serving (`--ckpt_dir`, the reference's `_serve_checkpoint`):
instead of a bench, `--prompt` strings (repeatable) are served from a
trained RoPE LM checkpoint (the port's own or one the JAX package wrote,
loaded by generate.load_lm) through a SlotEngine with one prompt bucket
and the Scheduler, and each completion is printed with its status and
TTFT; `--trace_out` writes that run's timeline.

The front door and the fleet (`--frontdoor`, `--qos`, `--procs N
[--streaming]`):
- frontdoor_bench: HTTP/SSE through real client sockets against
  serve/frontdoor.py — wire against in-process (token identity, goodput,
  the --sse audit), chunked-prefill TTFT through two paged front doors, a
  mid-stream SIGKILL of a worker behind the door (zero lost), and mixed
  greedy and sampled traffic with no new engine shapes;
- qos_bench: one seeded adversarial WorkloadPlan (serve/workload.py)
  through FIFO and weighted-fair routers and a fair worker fleet under a
  real SIGKILL: isolation, Jain's index, per-tenant alert attribution,
  token identity, zero lost;
- fleet_bench: one trace through N worker processes (serve/worker.py,
  serve/supervisor.py) and N in-process replicas, order-balanced reps
  (kill specs of --fault-plan signal live workers);
- streaming_bench: streaming against end-of-request delivery through the
  fleet, or under kill specs the consumer's exactly-once ledger.
- cache_routing_bench (`--procs N --cache-aware`): one shared-prefix
  trace through two paged, prefix-caching fleets, prefix affinity against
  least-loaded: the workers' own hit rates, goodput, token identity;
- fleet_autoscale_bench (`--procs N --autoscale [--autoscale-max M]
  [--standby S]`): a fixed fleet sized for the peak against an elastic
  one (serve/autoscaler.py) under a 4x arrival step: goodput per
  worker-second, reaction, oscillation, warm promotion against a cold
  spawn.
Each in-process row reports `decode_steps` and `kernel_launches`; each
fleet row reports every live worker's own (`workers`). The workers serve
the in-process model's widths and precision, weights from seed 0, on its
device.

Not ported in this slice, and refused by name: the telemetry plane
(ROADMAP A6d: the JSONL exporter, scrape federation, the fleet trace
plane, OTLP).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch


def build_trace(
    *,
    n_requests: int,
    rate_hz: float,
    vocab: int,
    prompt_len_range=(2, 16),
    max_new_range=(4, 32),
    seed: int = 0,
) -> list:
    """Poisson arrivals with mixed prompt lengths and token budgets."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, n_requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_len_range[0], prompt_len_range[1] + 1))
        trace.append({
            "rid": i,
            "arrival": float(arrivals[i]),
            "prompt": rng.integers(0, vocab, plen).tolist(),
            "max_new_tokens": int(
                rng.integers(max_new_range[0], max_new_range[1] + 1)
            ),
        })
    return trace


def build_shared_prefix_trace(
    *,
    n_requests: int,
    rate_hz: float,
    vocab: int,
    k_prefixes: int = 2,
    prefix_len: int = 48,
    tail_range=(1, 8),
    max_new_range=(8, 24),
    seed: int = 0,
) -> list:
    """K seeded system prompts x many continuations: every request is one
    of `k_prefixes` fixed prefixes plus a short unique tail, arriving
    Poisson. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    prefixes = [
        rng.integers(0, vocab, prefix_len).tolist()
        for _ in range(k_prefixes)
    ]
    gaps = rng.exponential(1.0 / rate_hz, n_requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for i in range(n_requests):
        pre = prefixes[int(rng.integers(0, k_prefixes))]
        tail = rng.integers(
            0, vocab, int(rng.integers(tail_range[0], tail_range[1] + 1))
        ).tolist()
        trace.append({
            "rid": i,
            "arrival": float(arrivals[i]),
            "prompt": list(pre) + tail,
            "max_new_tokens": int(
                rng.integers(max_new_range[0], max_new_range[1] + 1)
            ),
        })
    return trace


def build_lookup_trace(
    *,
    n_requests: int,
    rate_hz: float,
    vocab: int,
    motif_range=(2, 4),
    prompt_len_range=(6, 16),
    max_new_range=(8, 24),
    seed: int = 0,
) -> list:
    """Lookup-friendly prompts: each is a short random motif repeated to
    length, the self-quoting traffic prompt-lookup drafts target.
    Deterministic per seed."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, n_requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for i in range(n_requests):
        motif = rng.integers(
            0, vocab, int(rng.integers(motif_range[0], motif_range[1] + 1))
        ).tolist()
        plen = int(rng.integers(prompt_len_range[0],
                                prompt_len_range[1] + 1))
        reps = -(-plen // len(motif))
        trace.append({
            "rid": i,
            "arrival": float(arrivals[i]),
            "prompt": (motif * reps)[:plen],
            "max_new_tokens": int(
                rng.integers(max_new_range[0], max_new_range[1] + 1)
            ),
        })
    return trace


def _build_model(*, vocab, max_len, hidden=None, depth=None, heads=None,
                 mlp=None, kv_cache_dtype=None, model_name="lm_tiny",
                 precision="fp32", device="cuda", seed=0):
    """A RoPE decoder from the registry, initialised from `seed`. Width
    arguments left None keep the registry's defaults (lm_base: d=768,
    depth 12, 12 heads, mlp 3072)."""
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model

    dims = {"hidden_dim": hidden, "depth": depth, "num_heads": heads,
            "mlp_dim": mlp}
    return create_model(
        model_name, policy=PrecisionPolicy.from_name(precision),
        device=device, seed=seed, vocab_size=vocab, max_len=max_len,
        pos_emb="rope", kv_cache_dtype=kv_cache_dtype,
        **{k: v for k, v in dims.items() if v is not None},
    )


def _kv_bytes_per_token(cache, num_blocks, block_size) -> float:
    """Device bytes one context position costs in a paged pool: every
    tensor leaf's bytes (K/V and any int8 scale pages) over the pool's
    positions."""
    from ddp_practice_tpu_torch.serve.kv_pages import _pool_leaves

    total = sum(t.numel() * t.element_size()
                for _, t in _pool_leaves(cache))
    return total / (num_blocks * block_size)


def _launches() -> dict:
    """A snapshot of the decode-attention kernels' launch counts."""
    from ddp_practice_tpu_torch.ops.decode_attention import LAUNCHES

    return dict(LAUNCHES)


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _percentiles(xs) -> dict:
    from ddp_practice_tpu_torch.utils.metrics import percentile_summary

    return percentile_summary(xs, (50, 90, 99))


def _phase_breakdown(completions) -> dict:
    """Per-phase latency percentiles from the completions' flight
    records: queue wait vs prefill vs decode vs stall."""
    out = {}
    flights = [c.flight for c in completions if c.flight is not None]
    for key in ("queue_s", "prefill_s", "decode_s", "stall_s"):
        out[key] = _percentiles([f[key] for f in flights])
    return out


def _paged_capacity(trace, *, prompt_buckets, decode_burst, block_size,
                    spec_decode: bool = False, spec_k: int = 4,
                    prefix_cache: bool = False) -> int:
    """Per-slot capacity in blocks, sized to the WORKLOAD's worst context
    (bucket + burst-rounded max_new), not to max_len: the attention span
    follows the request, while the pool holds max_len-equivalent memory
    per slot."""
    worst_new = max(t["max_new_tokens"] for t in trace)
    worst_new = -(-worst_new // decode_burst) * decode_burst
    if spec_decode:
        # verify grows every slot spec_k + 1 positions before it knows
        # the acceptance
        worst_new += spec_k + 1
    span = max(prompt_buckets)
    if prefix_cache:
        # a prefix-cache admission prefills its suffix's bucket at the
        # matched offset: a partly evicted prefix can put matched + bucket
        # past the largest bucket. (The reference sizes for the bucket
        # alone, and its gate then rejects such requests as "never".)
        longest = max(len(t["prompt"]) for t in trace)
        span += (longest - 1) // block_size * block_size
    return -(-(span + worst_new) // block_size)


def _replay(server, trace, *, rid_offset: int = 0, driver=None,
            fleet: bool = False) -> float:
    """Submit each request of `trace` at its arrival on the monotonic
    clock and step `server` (a Scheduler, a Router or a fleet's Router)
    until it drains; returns the elapsed seconds. `rid_offset` keeps
    rids unique across reps on one router; `driver` (a FleetFaultDriver)
    is polled with the elapsed seconds; `fleet=True` parks between steps
    on the workers' push streams: their decode runs in other processes,
    which a spinning parent would preempt. A Scheduler or an in-process
    router decodes inside step(), so its loop never sleeps while busy."""
    from ddp_practice_tpu_torch.serve.scheduler import Request

    t0 = time.monotonic()
    i = 0
    while not (i >= len(trace) and server.idle):
        now = time.monotonic() - t0
        if driver is not None:
            driver.poll(now)
        while i < len(trace) and trace[i]["arrival"] <= now:
            t = trace[i]
            # stamp the TRUE trace arrival: a request polled one dispatch
            # late still counts that wait in its TTFT
            server.submit(Request(
                rid=t["rid"] + rid_offset, prompt=t["prompt"],
                max_new_tokens=t["max_new_tokens"],
                arrival=t0 + t["arrival"],
                # multi-tenant traces (serve/workload.py) carry these;
                # the single-tenant builders don't, and the defaults
                # keep their replays byte-identical
                tenant=t.get("tenant"),
                priority=t.get("priority", 0),
            ))
            i += 1
        if server.idle:
            # idle with arrivals left: sleep to the next one (a router
            # whose door sheds finalize at once can be idle with none
            # left, and the loop condition exits then)
            if i < len(trace):
                time.sleep(max(0.0, trace[i]["arrival"] - now))
            continue
        server.step()
        if fleet:
            until_arrival = (trace[i]["arrival"] - (time.monotonic() - t0)
                             if i < len(trace) else 0.005)
            _fleet_wait(server, min(0.005, max(0.0, until_arrival)))
    return time.monotonic() - t0


def _fleet_wait(router, max_s: float) -> None:
    """Park up to `max_s` on the fleet's push streams (a frame wakes
    the caller at once); a 1 ms nap at most while every stream is
    down."""
    from ddp_practice_tpu_torch.serve.frontdoor import wait_for_streams

    if not wait_for_streams(router, max_s):
        time.sleep(min(max_s, 0.001))


def _score(comps, n_trace: int, elapsed: float) -> dict:
    """A replay's row from its completions: the useful tokens of the
    requests that finished ok (a GOODPUT number under faults), their
    latency percentiles and phases, and `lost`, the trace's requests
    that never completed."""
    ok = [c for c in comps if c.status in ("eos", "length")]
    ok_tokens = sum(len(c.tokens) for c in ok)
    return {
        "elapsed_s": elapsed,
        "useful_tokens": ok_tokens,
        "tokens_per_sec": ok_tokens / elapsed,
        "goodput_tokens_per_sec": ok_tokens / elapsed,
        "ttft_s": _percentiles([c.ttft for c in ok if c.ttft is not None]),
        "tpot_s": _percentiles([c.tpot for c in ok if c.tpot is not None]),
        "latency_s": _percentiles([c.finish - c.arrival for c in ok]),
        # over the same ok population; stall_s here includes retry
        # parking and dead-replica gaps
        "phases": _phase_breakdown(ok),
        "completions": len(comps),
        # the zero-lost invariant, checked, not assumed
        "lost": n_trace - len(comps),
        "statuses": dict(Counter(c.status for c in comps)),
    }


def _replay_row(router, trace, **kw) -> dict:
    """Replay `trace` through an existing router (in-process or a fleet:
    the same Router API) with `_replay`'s keywords, and score what this
    replay completed."""
    before = len(router.completions)
    elapsed = _replay(router, trace, **kw)
    return _score(router.completions[before:], len(trace), elapsed)


def _run_continuous(model, trace, *, max_slots, prompt_buckets, max_len,
                    decode_burst, eos_id, paged: bool = False,
                    block_size: int = 16, prefix_cache: bool = False,
                    num_blocks: Optional[int] = None,
                    max_blocks_per_slot: Optional[int] = None,
                    spec_decode: bool = False, spec_k: int = 4,
                    collect_tokens: bool = False, tracer=None) -> dict:
    from ddp_practice_tpu_torch.serve.engine import (
        EngineConfig,
        PagedEngine,
        SlotEngine,
        warm_engine,
    )
    from ddp_practice_tpu_torch.serve.scheduler import Scheduler

    launches = _launches()
    if paged:
        # `num_blocks` and `max_blocks_per_slot` override the pool size
        # and the per-slot capacity (the shared-prefix bench undersizes
        # the pool so block pressure is real, and gives both of its arms
        # one capacity)
        cap_blocks = max_blocks_per_slot or _paged_capacity(
            trace, prompt_buckets=prompt_buckets, decode_burst=decode_burst,
            block_size=block_size, spec_decode=spec_decode, spec_k=spec_k,
            prefix_cache=prefix_cache)
        engine = PagedEngine(
            model,
            EngineConfig(
                max_slots=max_slots, max_len=max_len,
                prompt_buckets=prompt_buckets, temperature=0.0,
                decode_burst=decode_burst, eos_id=eos_id,
                block_size=block_size, max_blocks_per_slot=cap_blocks,
                num_blocks=(
                    num_blocks if num_blocks is not None
                    else 1 + max_slots * (-(-max_len // block_size))
                ),
                prefix_cache=prefix_cache,
                spec_decode=spec_decode, spec_k=spec_k,
            ),
        )
    else:
        engine = SlotEngine(
            model,
            EngineConfig(
                max_slots=max_slots, max_len=max_len,
                prompt_buckets=prompt_buckets, temperature=0.0,
                decode_burst=decode_burst, eos_id=eos_id,
            ),
        )
    sched = Scheduler(engine, max_queue=len(trace), tracer=tracer)
    # warmup outside the timed window: one admit per bucket in play, one
    # decode dispatch (and one verify with speculation on), then rewind
    warm_engine(engine,
                sorted({engine.bucket_for(len(t["prompt"])) for t in trace}))
    if paged and prefix_cache:
        # the timed window starts with a cold tree and zeroed counters
        engine.radix.clear()
        engine.radix.hit_tokens = engine.radix.miss_tokens = 0
        engine.preemptions = 0
    if tracer is not None:
        # the engine's lanes join only after warmup, and anything recorded
        # so far is dropped: the timeline is the workload's
        from ddp_practice_tpu_torch.utils.trace import label_replica

        engine.set_tracer(tracer, 0)
        label_replica(tracer, 0, max_slots)
        tracer.clear()

    elapsed = _replay(sched, trace)

    tokens = sum(len(c.tokens) for c in sched.completions)
    lat = [c.finish - c.arrival for c in sched.completions]
    extra = {}
    if paged:
        extra["preemptions"] = engine.preemptions
        extra["kv_bytes_per_token"] = _kv_bytes_per_token(
            engine._cache, engine.blocks.num_blocks, block_size
        )
        extra["num_blocks"] = engine.blocks.num_blocks
        if engine.drafter is not None:
            extra["spec"] = {
                "spec_k": spec_k,
                "drafted_tokens": engine.spec_drafted_tokens,
                "accepted_tokens": engine.spec_accepted_tokens,
                "accept_rate": (
                    engine.spec_accepted_tokens
                    / max(1, engine.spec_drafted_tokens)
                ),
                "verify_dispatches": engine.spec_dispatches,
            }
        if prefix_cache:
            extra["prefix_cache"] = {
                "hit_tokens": engine.radix.hit_tokens,
                "miss_tokens": engine.radix.miss_tokens,
                "hit_rate": (
                    engine.radix.hit_tokens
                    / max(1, engine.radix.hit_tokens
                          + engine.radix.miss_tokens)
                ),
                "nodes": len(engine.radix),
            }
    if collect_tokens:
        extra["tokens_by_rid"] = {
            c.rid: list(c.tokens) for c in sched.completions
        }
    return {
        "mode": ("paged+spec" if paged and spec_decode
                 else "paged+prefix" if paged and prefix_cache
                 else "paged" if paged else "continuous"),
        **extra,
        # largest context one request can reach: the slot pool's shared
        # clock caps it at max_len, the paged engine's page-table width
        # is free to exceed it
        "max_servable_context": engine.max_context if paged else max_len,
        "elapsed_s": elapsed,
        "useful_tokens": tokens,
        "tokens_per_sec": tokens / elapsed,
        "ttft_s": _percentiles(
            [c.ttft for c in sched.completions if c.ttft is not None]
        ),
        "tpot_s": _percentiles(
            [c.tpot for c in sched.completions if c.tpot is not None]
        ),
        "latency_s": _percentiles(lat),
        "phases": _phase_breakdown(sched.completions),
        "completions": len(sched.completions),
        "statuses": dict(Counter(c.status for c in sched.completions)),
        "decode_steps": engine.decode_steps,
        "kernel_launches": _launches_since(launches),
        "compile_stats": engine.compile_stats(),
    }


def _run_static(model, trace, *, max_slots, width, max_new,
                eos_id) -> dict:
    """Static-batch baseline: fixed (max_slots, width) prompts, everyone
    decodes `max_new` tokens, arrivals wait for the whole batch."""
    from ddp_practice_tpu_torch.inference import make_generate_fn

    gen = make_generate_fn(
        model, max_new_tokens=max_new, temperature=0.0, eos_id=eos_id,
        pad_id=-1,  # distinguishable from real tokens when counting
    )
    steps = 0
    launches = _launches()

    def run_batch(batch):
        nonlocal steps
        toks = np.full((max_slots, width), 0, np.int64)
        lens = np.ones((max_slots,), np.int32)
        for j, t in enumerate(batch):
            p = t["prompt"]
            toks[j, width - len(p):] = p
            lens[j] = len(p)
        out = gen(torch.from_numpy(toks), None,
                  torch.from_numpy(lens)).cpu().numpy()
        steps += max_new
        return out[:, width:]

    run_batch(trace[:1])  # warmup outside the window

    t0 = time.monotonic()
    i = 0
    done = []
    while i < len(trace):
        now = time.monotonic() - t0
        if trace[i]["arrival"] > now:
            time.sleep(trace[i]["arrival"] - now)
            continue
        batch = []
        while i < len(trace) and len(batch) < max_slots \
                and trace[i]["arrival"] <= time.monotonic() - t0:
            batch.append(trace[i])
            i += 1
        new = run_batch(batch)
        finish = time.monotonic() - t0
        for j, t in enumerate(batch):
            # useful tokens: up to this request's own budget, cut at EOS
            row = new[j, : t["max_new_tokens"]]
            done.append({
                "rid": t["rid"],
                "tokens": int((row != -1).sum()),
                "latency": finish - t["arrival"],
            })
    elapsed = time.monotonic() - t0
    tokens = sum(d["tokens"] for d in done)
    lat = [d["latency"] for d in done]
    return {
        "mode": "static",
        "elapsed_s": elapsed,
        "useful_tokens": tokens,
        "tokens_per_sec": tokens / elapsed,
        # every token arrives when the batch returns: TTFT == latency
        "ttft_s": _percentiles(lat),
        "latency_s": _percentiles(lat),
        "completions": len(done),
        "decode_steps": steps,
        "kernel_launches": _launches_since(launches),
    }


def _make_tracer(*, sample: float = 1.0, keep_slow_s=None,
                 tenant_rates=None, registry=None):
    """A request-lifecycle recorder on the monotonic clock (the clock the
    bench's schedulers and router read), with the head-sampling and
    tail-keep policy attached when any of its knobs leaves the default
    (record everything)."""
    from ddp_practice_tpu_torch.utils.trace import TraceRecorder, TraceSampler

    tracer = TraceRecorder()
    if sample < 1.0 or keep_slow_s is not None or tenant_rates:
        tracer.set_sampler(TraceSampler(sample, keep_slow_s=keep_slow_s,
                                        tenant_rates=tenant_rates),
                           registry=registry)
    return tracer


def _run_router(model, trace, *, replicas, max_slots, prompt_buckets,
                max_len, decode_burst, eos_id, fault_plan=None,
                tracer=None, slo_config=None, registry=None,
                alert_sinks=None, collect_tokens: bool = False) -> dict:
    """The fleet path: N SlotEngine replicas of `model` behind the
    fault-tolerant router (serve/router.py), stepped one after another on
    one card. Scored like the continuous server on the useful tokens of
    requests that finished ok, which under an injected FaultPlan is a
    GOODPUT number: tokens the fleet still delivered while replicas
    crashed, stalled or emitted NaNs. Besides the reference's keys the
    row carries `decode_steps` and `kernel_launches` summed over the
    replicas (warmup included) and `warm_compile_stats`, each replica's
    shape counts right after warmup (failover re-prefills must land in
    warmed buckets: the end-of-run `compile_stats` equal them)."""
    from ddp_practice_tpu_torch.serve.engine import EngineConfig
    from ddp_practice_tpu_torch.serve.router import RouterConfig, make_router
    from ddp_practice_tpu_torch.serve.scheduler import MonotonicClock

    launches = _launches()
    clock = MonotonicClock()
    watchdog = None
    if slo_config is not None:
        from ddp_practice_tpu_torch.serve.slo import AlertSinks, SLOWatchdog

        # live burn-rate alerting over the run's completions: alert
        # instants land in the trace, the router's brown-out listens, and
        # --alert-sink edges are pushed to operators
        sinks = (AlertSinks(alert_sinks, clock=clock, registry=registry)
                 if alert_sinks else None)
        watchdog = SLOWatchdog(slo_config, clock=clock, registry=registry,
                               tracer=tracer, sinks=sinks)
    router = make_router(
        model, replicas,
        EngineConfig(
            max_slots=max_slots, max_len=max_len,
            prompt_buckets=prompt_buckets, temperature=0.0,
            decode_burst=decode_burst, eos_id=eos_id,
        ),
        clock=clock, max_queue=len(trace), config=RouterConfig(),
        fault_plan=fault_plan, registry=registry, tracer=tracer,
        slo=watchdog,
    )
    # warm EVERY configured bucket, not just the trace prompts' widths:
    # failover re-prefills carry prompt + salvaged tokens and can land in
    # a larger bucket
    router.warmup()
    warm = router.compile_stats()
    if tracer is not None:
        tracer.clear()  # drop warmup spans; keep the workload timeline
    elapsed = _replay(router, trace)

    m = router.metrics
    out = {
        "mode": f"router x{replicas}",
        **_score(router.completions, len(trace), elapsed),
        "retries": m.retries.value,
        "failovers": m.failovers.value,
        "breaker_trips": m.breaker_trips.value,
        "replica_states": router.states(),
        "compile_stats": router.compile_stats(),
        "warm_compile_stats": warm,
        "decode_steps": sum(h.engine.decode_steps for h in router.handles),
        "kernel_launches": _launches_since(launches),
    }
    if watchdog is not None:
        out["slo"] = {
            "alerts": [
                {"t": t, "event": edge, "objective": obj}
                for t, edge, obj in watchdog.alert_log
            ],
            "active": dict(watchdog.alerts),
        }
    if collect_tokens:
        out["tokens_by_rid"] = {
            c.rid: list(c.tokens) for c in router.completions
        }
    return out


def serve_bench(
    *,
    n_requests: int = 32,
    rate_hz: float = 8.0,
    max_slots: int = 8,
    vocab: int = 64,
    hidden: Optional[int] = 128,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 256,
    max_len: int = 128,
    prompt_buckets=(8, 16),
    prompt_len_range=(2, 16),
    max_new_range=(2, 96),
    decode_burst: int = 8,
    eos_id: Optional[int] = 46,
    seed: int = 0,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    kv_cache_dtype=None,
    device="cuda",
    model=None,
    collect_tokens: bool = False,
    # also run the trace through the paged engine: its decode attention
    # reads each request's own pages, where the slot engine's scans the
    # shared [start, cursor) span
    paged: bool = False,
    block_size: int = 16,
    # fleet path: 0 = skip the router row; N >= 1 runs the SAME trace
    # through N replicas behind serve/router.py (replicas=1 measures the
    # router's own cost against the continuous row)
    replicas: int = 0,
    fault_plan=None,
    # Chrome trace-event JSON of the request lifecycle (utils/trace.py):
    # the recorder rides the router run when replicas >= 1, else the
    # continuous run, warmup spans dropped either way; None = no tracing
    trace_out: Optional[str] = None,
    # SLOConfig, or its JSON or a path to it: arms the burn-rate watchdog
    # on the router run (needs replicas >= 1); alert_sinks ("kind:target"
    # strings) push its edges
    slo=None,
    alert_sinks=None,
    # head sampling and tail keep of the recorder (utils/trace.py
    # TraceSampler); the defaults record everything
    trace_sample: float = 1.0,
    trace_keep_slow_s: Optional[float] = None,
    trace_tenant_rates: Optional[dict] = None,
) -> dict:
    """Replay one Poisson trace through the servers; return the report.
    `model` reuses an already built decoder (its vocab and max_len must
    cover the trace); otherwise one is built from the arguments."""
    slo_config = None
    if slo is not None:
        from ddp_practice_tpu_torch.serve.slo import SLOConfig

        if replicas < 1:
            raise ValueError("--slo needs --replicas N (the watchdog "
                             "feeds the router's brown-out hook)")
        slo_config = SLOConfig.from_json(slo)
    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max_len, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, kv_cache_dtype=kv_cache_dtype,
            model_name=model_name, precision=precision, device=device,
        )
    trace = build_trace(
        n_requests=n_requests, rate_hz=rate_hz, vocab=model.vocab_size,
        prompt_len_range=prompt_len_range, max_new_range=max_new_range,
        seed=seed,
    )
    registry = None
    if slo_config is not None:
        from ddp_practice_tpu_torch.utils.metrics import MetricsRegistry

        registry = MetricsRegistry()
    tracer = (_make_tracer(sample=trace_sample,
                           keep_slow_s=trace_keep_slow_s,
                           tenant_rates=trace_tenant_rates,
                           registry=registry)
              if trace_out else None)
    cont = _run_continuous(
        model, trace, max_slots=max_slots,
        prompt_buckets=tuple(prompt_buckets), max_len=max_len,
        decode_burst=decode_burst, eos_id=eos_id,
        collect_tokens=collect_tokens,
        tracer=None if replicas >= 1 else tracer,
    )
    static = _run_static(
        model, trace, max_slots=max_slots, width=max(prompt_buckets),
        max_new=max(max_new_range), eos_id=eos_id,
    )
    report = {
        "device": _device_name(model),
        "trace": {
            "n_requests": n_requests, "rate_hz": rate_hz, "seed": seed,
            "prompt_len_range": list(prompt_len_range),
            "max_new_range": list(max_new_range),
        },
        "max_len": max_len,
        "continuous": cont,
        "static": static,
        "throughput_ratio": _ratio(cont, static),
    }
    if paged:
        report["paged"] = _run_continuous(
            model, trace, max_slots=max_slots,
            prompt_buckets=tuple(prompt_buckets), max_len=max_len,
            decode_burst=decode_burst, eos_id=eos_id, paged=True,
            block_size=block_size, collect_tokens=collect_tokens,
        )
        report["paged_vs_static"] = _ratio(report["paged"], static)
        report["paged_vs_continuous"] = _ratio(report["paged"], cont)
    if replicas >= 1:
        report["router"] = _run_router(
            model, trace, replicas=replicas, max_slots=max_slots,
            prompt_buckets=tuple(prompt_buckets), max_len=max_len,
            decode_burst=decode_burst, eos_id=eos_id,
            fault_plan=fault_plan, tracer=tracer, slo_config=slo_config,
            registry=registry, alert_sinks=alert_sinks,
            collect_tokens=collect_tokens,
        )
        if fault_plan is not None:
            report["fault_plan"] = fault_plan.to_json()
        report["router_vs_continuous"] = _ratio(report["router"], cont)
    if tracer is not None:
        tracer.save(trace_out)
        report["trace_out"] = trace_out
        report["trace_events"] = len(tracer)
    return report


def _device_name(model) -> str:
    dev = model.tok_embed.weight.device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _ratio(a: dict, b: dict) -> float:
    """a's throughput over b's."""
    return (a["tokens_per_sec"] / b["tokens_per_sec"]
            if b["tokens_per_sec"] else float("inf"))


def shared_prefix_bench(
    *,
    n_requests: int = 32,
    # effectively instant arrivals: the ratio is then the engines'
    # goodput at full block pressure, not the Poisson clock
    rate_hz: float = 1000.0,
    max_slots: int = 8,
    vocab: int = 64,
    hidden: Optional[int] = 128,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 256,
    max_len: int = 128,
    prompt_buckets=(16, 128),
    # K fixed block-aligned system prompts x short unique tails: the
    # prefixes dominate each prompt (96 of ~100 tokens)
    k_prefixes: int = 2,
    prefix_len: int = 96,
    tail_range=(1, 8),
    max_new_range=(4, 8),
    decode_burst: int = 4,
    block_size: int = 16,
    # UNDERSIZED pool (19 real blocks, ~2 plain worst-case contexts for 8
    # slots): block pressure is what sharing and preemption relieve
    num_blocks: int = 20,
    seed: int = 0,
    kv_int8: bool = False,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
) -> dict:
    """Replay ONE shared-prefix trace through the plain paged engine and
    the prefix-sharing engine at the SAME pool size and per-slot
    capacity. `prefix_vs_paged` is
    the goodput ratio; the hit/miss token counters prove the reuse.
    `kv_int8` stores the pool int8 with per-block scale pages (a given
    `model` must then have kv_cache_dtype "int8"), reported against the
    same model's fp32 pool."""
    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max_len, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, kv_cache_dtype="int8" if kv_int8 else None,
            model_name=model_name, precision=precision, device=device,
        )
    elif kv_int8 != (model.blocks[0].attn.kv_cache_dtype == "int8"):
        raise ValueError("kv_int8 must match the model's kv_cache_dtype")
    trace = build_shared_prefix_trace(
        n_requests=n_requests, rate_hz=rate_hz, vocab=model.vocab_size,
        k_prefixes=k_prefixes, prefix_len=prefix_len,
        tail_range=tail_range, max_new_range=max_new_range, seed=seed,
    )
    # both arms get the capacity the prefix arm needs, so the goodput
    # ratio isolates the cache
    cap_blocks = _paged_capacity(
        trace, prompt_buckets=prompt_buckets, decode_burst=decode_burst,
        block_size=block_size, prefix_cache=True)
    common = dict(
        max_slots=max_slots, prompt_buckets=tuple(prompt_buckets),
        max_len=max_len, decode_burst=decode_burst, eos_id=None,
        paged=True, block_size=block_size, num_blocks=num_blocks,
        max_blocks_per_slot=cap_blocks,
    )
    plain = _run_continuous(model, trace, **common)
    prefix = _run_continuous(model, trace, prefix_cache=True, **common)
    report = {
        "device": _device_name(model),
        "trace": {
            "n_requests": n_requests, "rate_hz": rate_hz, "seed": seed,
            "k_prefixes": k_prefixes, "prefix_len": prefix_len,
            "tail_range": list(tail_range),
            "max_new_range": list(max_new_range),
        },
        "pool": {
            "num_blocks": num_blocks, "block_size": block_size,
            "max_slots": max_slots, "max_blocks_per_slot": cap_blocks,
            "kv_cache_dtype": "int8" if kv_int8 else str(
                model.blocks[0].attn.cache_dtype()).replace("torch.", ""),
        },
        "paged": plain,
        "paged_prefix": prefix,
        "prefix_vs_paged": _ratio(prefix, plain),
    }
    if kv_int8:
        # an fp32 pool holds K and V, h*hd floats each, per layer
        f32_bytes = 2 * model.depth * model.hidden_dim * 4
        report["kv_bytes_per_token_f32"] = f32_bytes
        report["kv_bytes_ratio"] = prefix["kv_bytes_per_token"] / f32_bytes
    return report


def spec_decode_bench(
    *,
    n_requests: int = 32,
    rate_hz: float = 8.0,
    max_slots: int = 4,
    vocab: int = 64,
    hidden: Optional[int] = 128,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 256,
    max_len: int = 128,
    prompt_buckets=(16,),
    # repeated-motif prompts, where prompt-lookup drafts hit
    motif_range=(2, 4),
    prompt_len_range=(6, 16),
    max_new_range=(8, 24),
    # burst 1 for BOTH arms pins tokens per dispatch at 1 on the plain
    # side, so the ratio isolates what speculation changes: sequential
    # dispatches per emitted token
    decode_burst: int = 1,
    block_size: int = 16,
    spec_k: int = 4,
    seed: int = 0,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
) -> dict:
    """Replay ONE lookup-friendly trace through the plain paged engine and
    the speculative-decoding paged engine at the same pool. `tpot_ratio`
    is spec p50 / plain p50; `token_identity` the fraction of requests
    with identical streams (greedy speculation must give 1.0);
    `accept_rate` explains the ratio."""
    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max_len, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, model_name=model_name,
            precision=precision, device=device,
        )
    trace = build_lookup_trace(
        n_requests=n_requests, rate_hz=rate_hz, vocab=model.vocab_size,
        motif_range=motif_range, prompt_len_range=prompt_len_range,
        max_new_range=max_new_range, seed=seed,
    )
    common = dict(
        max_slots=max_slots, prompt_buckets=tuple(prompt_buckets),
        max_len=max_len, decode_burst=decode_burst, eos_id=None,
        paged=True, block_size=block_size, collect_tokens=True,
    )
    plain = _run_continuous(model, trace, **common)
    spec = _run_continuous(model, trace, spec_decode=True, spec_k=spec_k,
                           **common)
    plain_toks = plain.pop("tokens_by_rid")
    spec_toks = spec.pop("tokens_by_rid")
    identical = sum(
        1 for rid in plain_toks if spec_toks.get(rid) == plain_toks[rid]
    )
    return {
        "device": _device_name(model),
        "trace": {
            "n_requests": n_requests, "rate_hz": rate_hz, "seed": seed,
            "motif_range": list(motif_range),
            "prompt_len_range": list(prompt_len_range),
            "max_new_range": list(max_new_range),
        },
        "spec_k": spec_k,
        "paged": plain,
        "paged_spec": spec,
        "token_identity": identical / max(1, len(plain_toks)),
        "tpot_ratio": (
            spec["tpot_s"]["p50"] / plain["tpot_s"]["p50"]
            if plain["tpot_s"]["p50"] else float("inf")
        ),
        "latency_ratio_p50": (
            spec["latency_s"]["p50"] / plain["latency_s"]["p50"]
            if plain["latency_s"]["p50"] else float("inf")
        ),
        "accept_rate": spec["spec"]["accept_rate"],
    }


# --------------------------------------------------------------------- CLI
# ----------------------------------------------- the fleet and the door
def _worker_model(model) -> dict:
    """The WorkerSpec model dict that rebuilds `model` (a dense RoPE
    TransformerLM from `_build_model`, seed 0) in a worker process: the
    same widths and precision, so every worker draws the same weights
    as the in-process arms (models.init_weights draws on the CPU in
    parameter order)."""
    return {
        "name": "lm_tiny",
        "precision": ("bf16" if model.dtype == torch.bfloat16
                      else "fp32"),
        "vocab_size": model.vocab_size, "max_len": model.max_len,
        "hidden_dim": model.hidden_dim, "depth": model.depth,
        "num_heads": model.num_heads, "mlp_dim": model.mlp_dim,
        "pos_emb": model.pos_emb,
    }


def _worker_spec(model, engine: dict, **kw):
    """A WorkerSpec serving `model`'s weights on `model`'s device. It
    carries `model`'s weights digest, so a worker raises at boot when
    its seed-0 rebuild is not `model` (another seed, trained weights)."""
    from ddp_practice_tpu_torch.serve.worker import WorkerSpec, weights_digest

    return WorkerSpec(model=_worker_model(model), engine=engine,
                      device=model.tok_embed.weight.device.type,
                      weights_digest=weights_digest(model), **kw)


def _router_counts(router, launches: dict) -> dict:
    """An in-process run's decode steps (every replica's single-token
    model applications, warmup included) and the decode-attention
    launches since `launches`."""
    return {
        "decode_steps": sum(h.engine.decode_steps for h in router.handles),
        "kernel_launches": _launches_since(launches),
    }


def _worker_counts(sup, handles) -> list:
    """Each live worker's own decode steps and kernel launches (its
    process's counters, warmup included), read by a ping: one snapshot
    per worker, taken together under that worker's lock."""
    from ddp_practice_tpu_torch.serve.rpc import RpcError, RpcRemoteError

    out = []
    for h in handles:
        w = sup.worker(h.id)
        if w is None:
            continue
        try:
            stats = w.client.call("ping", timeout_s=5.0)["stats"]
        except (RpcError, RpcRemoteError):
            continue
        out.append({"replica": h.id, "pid": w.pid,
                    "decode_steps": stats.get("decode_steps"),
                    "kernel_launches": stats.get("kernel_launches")})
    return out


def _med(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _refuse_sim_faults(fault_plan, procs: int) -> None:
    """The worker fleet interprets only `kill` specs (real signals):
    refusing beats lying, since workers carry no injector and a
    simulated spec would run fault-free under a report that stamps it."""
    sim = [f.kind for f in fault_plan.faults if f.kind != "kill"]
    if sim:
        raise ValueError(
            f"the --procs fleet bench interprets only 'kill' specs (real "
            f"signals); simulated faults {sim} ride the in-process "
            f"--replicas path")
    bad = [f.replica for f in fault_plan.kills()
           if not 0 <= f.replica < procs]
    if bad:
        raise ValueError(f"kill spec replica(s) {bad} out of range for "
                         f"--procs {procs}")


def _a6d(what: str):
    return NotImplementedError(
        f"{what}: the telemetry plane is not ported yet (ROADMAP A6d)")


def fleet_bench(
    *,
    n_requests: int = 32,
    rate_hz: float = 8.0,
    procs: int = 2,
    max_slots: int = 8,
    vocab: int = 64,
    hidden: Optional[int] = 128,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 256,
    max_len: int = 128,
    prompt_buckets=(8, 16),
    prompt_len_range=(2, 16),
    max_new_range=(2, 32),
    decode_burst: int = 8,
    eos_id: Optional[int] = 46,
    seed: int = 0,
    reps: int = 6,
    fault_plan=None,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
    metrics_port: Optional[int] = None,
    trace_out: Optional[str] = None,
    otlp_out: Optional[str] = None,
    otlp_endpoint: Optional[str] = None,
) -> dict:
    """One Poisson trace through `procs` worker OS PROCESSES behind the
    RPC seam (serve/worker.py + serve/supervisor.py) AND through `procs`
    in-process router replicas, which step one after another in this
    thread — the ratio rows are the seam's bill, and on the card the
    workers' own threads are what the fleet buys.

    Methodology (as the reference's): both routers are built ONCE (warm
    engines throughout), then the trace replays `reps` times ALTERNATING
    which side goes first; the headline ratios are medians of per-rep
    ratios, so run-order drift cancels instead of being billed to the
    seam. A kill-bearing `fault_plan` switches to a single chaos rep —
    real SIGKILL/SIGSTOP to live worker pids, goodput and zero-lost
    measured against actual process death. `model` reuses a built
    decoder for the in-process side; the workers rebuild its weights
    from its widths and seed 0. The fleet trace plane (`trace_out`),
    the federated scrape server (`metrics_port`) and OTLP egress are
    ROADMAP A6d and raise naming it."""
    from ddp_practice_tpu_torch.serve.engine import EngineConfig
    from ddp_practice_tpu_torch.serve.faults import FleetFaultDriver
    from ddp_practice_tpu_torch.serve.router import RouterConfig, make_router
    from ddp_practice_tpu_torch.serve.scheduler import MonotonicClock
    from ddp_practice_tpu_torch.serve.supervisor import (
        SupervisorConfig,
        make_fleet_router,
    )

    if metrics_port is not None:
        raise _a6d("fleet_bench(metrics_port=)")
    if trace_out is not None:
        raise _a6d("fleet_bench(trace_out=)")
    if otlp_out is not None or otlp_endpoint is not None:
        raise _a6d("fleet_bench(otlp_out=, otlp_endpoint=)")
    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max_len, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, model_name=model_name,
            precision=precision, device=device)
    trace = build_trace(
        n_requests=n_requests, rate_hz=rate_hz, vocab=model.vocab_size,
        prompt_len_range=prompt_len_range, max_new_range=max_new_range,
        seed=seed,
    )
    chaos = fault_plan is not None and bool(fault_plan.kills())
    if fault_plan is not None:
        _refuse_sim_faults(fault_plan, procs)
    if chaos:
        reps = 1
    engine_kw = {
        "max_slots": max_slots, "max_len": max_len,
        "prompt_buckets": list(prompt_buckets), "temperature": 0.0,
        "decode_burst": decode_burst, "eos_id": eos_id,
    }
    # enough queue for every rep's worst backlog
    max_queue = len(trace) * max(1, reps)
    launches = _launches()
    inproc = make_router(
        model, procs, EngineConfig(**{**engine_kw, "prompt_buckets":
                                      tuple(prompt_buckets)}),
        clock=MonotonicClock(), max_queue=max_queue, config=RouterConfig(),
    )
    inproc.warmup()
    fleet_router, sup, handles = make_fleet_router(
        _worker_spec(model, engine_kw, max_queue=max_queue), procs,
        sup_config=SupervisorConfig(restart_base_s=0.25),
    )
    rep_rows = {"in_process": [], "fleet": []}
    ratios_p50 = []
    try:
        driver = (FleetFaultDriver(fault_plan, sup.kill)
                  if chaos else None)
        for rep in range(reps):
            order = ["in_process", "fleet"]
            if rep % 2:
                order.reverse()
            for side in order:
                if side == "in_process":
                    row = _replay_row(
                        inproc, trace, rid_offset=rep * 1_000_000)
                else:
                    row = _replay_row(
                        fleet_router, trace, rid_offset=rep * 1_000_000,
                        driver=driver, fleet=True)
                rep_rows[side].append(row)
            ratios_p50.append(
                rep_rows["fleet"][-1]["latency_s"]["p50"]
                / rep_rows["in_process"][-1]["latency_s"]["p50"])

        def agg(side, key):
            return {p: _med([r[key][p] for r in rep_rows[side]])
                    for p in ("p50", "p90", "p99")}

        def ratio(key, pct):
            return _med([f[key][pct] / i[key][pct]
                         for f, i in zip(rep_rows["fleet"],
                                         rep_rows["in_process"])
                         if i[key][pct]])

        m = fleet_router.metrics
        fleet_row = dict(rep_rows["fleet"][-1])
        fleet_row.update({
            "mode": f"fleet x{procs}", "procs": procs,
            "latency_s": agg("fleet", "latency_s"),
            "ttft_s": agg("fleet", "ttft_s"),
            "goodput_tokens_per_sec": _med(
                [r["goodput_tokens_per_sec"] for r in rep_rows["fleet"]]),
            "lost": sum(r["lost"] for r in rep_rows["fleet"]),
            "retries": m.retries.value,
            "failovers": m.failovers.value,
            "breaker_trips": m.breaker_trips.value,
            "replica_states": fleet_router.states(),
            "worker_restarts": list(sup.restarts),
            "workers": _worker_counts(sup, handles),
        })
        if driver is not None:
            fleet_row["kills_fired"] = [
                {"replica": f.replica, "sig": f.sig, "at_s": f.at_s}
                for f in driver.fired
            ]
        inproc_row = dict(rep_rows["in_process"][-1])
        inproc_row.update({
            "mode": f"router x{procs}",
            "latency_s": agg("in_process", "latency_s"),
            "ttft_s": agg("in_process", "ttft_s"),
            "goodput_tokens_per_sec": _med(
                [r["goodput_tokens_per_sec"]
                 for r in rep_rows["in_process"]]),
            "lost": sum(r["lost"] for r in rep_rows["in_process"]),
            **_router_counts(inproc, launches),
        })
        report = {
            "device": _device_name(model),
            "trace": {
                "n_requests": n_requests, "rate_hz": rate_hz, "seed": seed,
                "prompt_len_range": list(prompt_len_range),
                "max_new_range": list(max_new_range),
            },
            "procs": procs,
            "reps": reps,
            "in_process": inproc_row,
            "fleet": fleet_row,
            # medians of per-rep ratios: order-balanced, drift-robust
            "latency_ratio_p50": _med(ratios_p50),
            "latency_ratio_p50_per_rep": ratios_p50,
            "latency_ratio_p99": ratio("latency_s", "p99"),
            "goodput_ratio": _med(
                [f["goodput_tokens_per_sec"] / i["goodput_tokens_per_sec"]
                 for f, i in zip(rep_rows["fleet"],
                                 rep_rows["in_process"])]),
            # steady-state decode (TPOT: the RPC seam is off this path)
            # against admission (TTFT: the submit hop and the worker's
            # wake are on it) — where the ratio comes from
            "tpot_ratio_p50": ratio("tpot_s", "p50"),
            "ttft_ratio_p50": ratio("ttft_s", "p50"),
        }
        if fault_plan is not None:
            report["fault_plan"] = fault_plan.to_json()
        return report
    finally:
        sup.stop()


# ----------------------------------------------------- the elastic fleet
def _fleet_kv_counters(router) -> tuple:
    """Summed (hit_tokens, miss_tokens) over every worker's
    heartbeat-carried kv summary: the fleet's prefix-cache ledger."""
    hit = miss = 0
    for h in router.handles:
        kv = getattr(h, "kv_summary", None)
        if isinstance(kv, dict):
            hit += kv.get("hit_tokens", 0)
            miss += kv.get("miss_tokens", 0)
    return hit, miss


def cache_routing_bench(
    *,
    n_requests: int = 48,
    rate_hz: float = 100.0,
    procs: int = 2,
    max_slots: int = 4,
    block_size: int = 16,
    # undersized on purpose: 24 usable blocks hold TWO families' prefix
    # blocks (12) and the working set, not all FOUR (24), so spraying
    # every family over the fleet (least-loaded) keeps evicting and
    # re-paying cold prefill, while affinity's partition stays warm
    num_blocks: int = 25,
    k_prefixes: int = 4,
    prefix_len: int = 96,
    vocab: int = 64,
    hidden: Optional[int] = 128,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 256,
    max_len: int = 128,
    decode_burst: int = 8,
    seed: int = 0,
    reps: int = 6,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
) -> dict:
    """The cache-aware routing A/B: ONE shared-prefix trace (K system
    prompts x unique tails) replayed through TWO identical paged,
    prefix-caching worker fleets at the same pool, one routing by prefix
    affinity (RouterConfig.cache_aware, serve/affinity.py), one by
    least-loaded. Affinity partitions the K families over the fleet so
    each warms once; least-loaded sprays them, so every family pays its
    cold prefill on every worker, and again whenever churn evicts it.
    Headlines: the fleet's prefix-hit-token rate (the workers' own radix
    counters, not the router's estimate) and the goodput ratio, with the
    zero-lost and greedy token-identity invariants (routing changes
    where a request runs, never what it produces). Unlike the
    reference's, both routers run with brown-out off: under the trace's
    burst it would cap some requests at `brownout_max_new` tokens in one
    arm and not the other, and identity would then measure that cap, not
    the routing. Order-balanced
    alternating reps, medians of per-rep ratios, as fleet_bench. `model`
    reuses a built decoder's widths, precision and device; the workers
    rebuild its weights from seed 0 (`_worker_spec`). Each arm's row
    adds its live workers' own decode steps and kernel launches
    (`workers`)."""
    from ddp_practice_tpu_torch.serve.router import RouterConfig
    from ddp_practice_tpu_torch.serve.supervisor import (
        SupervisorConfig,
        make_fleet_router,
    )

    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max_len, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, model_name=model_name,
            precision=precision, device=device)
    trace = build_shared_prefix_trace(
        n_requests=n_requests, rate_hz=rate_hz, vocab=model.vocab_size,
        k_prefixes=k_prefixes, prefix_len=prefix_len,
        tail_range=(1, 8), max_new_range=(8, 24), seed=seed,
    )
    max_prompt = max(len(t["prompt"]) for t in trace)
    bucket = block_size
    while bucket < max_prompt:
        bucket += block_size
    # small buckets matter: a warm admission prefills only the uncached
    # remainder, over matched + bucket_for(remainder) positions; with
    # the full-prompt bucket alone every warm request would overrun its
    # slot's capacity and be rejected instead of hitting the cache
    buckets = sorted({16, 32, 64, bucket})
    spec = _worker_spec(model, {
        "paged": True, "prefix_cache": True,
        "num_blocks": num_blocks, "block_size": block_size,
        "max_slots": max_slots, "max_len": max_len,
        "prompt_buckets": buckets,
        # greedy: token identity needs bit-equal streams across arms
        "temperature": 0.0, "decode_burst": decode_burst,
        "eos_id": None,
    }, max_queue=len(trace) * max(1, reps))
    arms = {}
    sups = {}
    try:
        for name, aware in (("affinity", True), ("least_loaded", False)):
            # brown-out off in both arms: it caps a request's budget by
            # its arm's momentary pressure, and a capped stream differs
            # from the other arm's by routing alone
            router, sup, _handles = make_fleet_router(
                spec, procs,
                config=RouterConfig(cache_aware=aware,
                                    brownout_on=float("inf")),
                sup_config=SupervisorConfig(restart_base_s=0.25),
            )
            arms[name] = router
            sups[name] = sup
        rep_rows = {"affinity": [], "least_loaded": []}
        tokens_by_rid = {"affinity": {}, "least_loaded": {}}
        for rep in range(reps):
            order = ["affinity", "least_loaded"]
            if rep % 2:
                order.reverse()
            for side in order:
                router = arms[side]
                hit0, miss0 = _fleet_kv_counters(router)
                n_before = len(router.completions)
                row = _replay_row(router, trace,
                                  rid_offset=rep * 1_000_000, fleet=True)
                # one settle tick: the last heartbeat's kv counters
                # (carried by the final poll) are current for the delta
                router.step()
                hit1, miss1 = _fleet_kv_counters(router)
                dh, dm = hit1 - hit0, miss1 - miss0
                row["hit_tokens"] = dh
                row["miss_tokens"] = dm
                row["hit_rate"] = dh / (dh + dm) if dh + dm else 0.0
                rep_rows[side].append(row)
                for c in router.completions[n_before:]:
                    if c.status in ("eos", "length"):
                        tokens_by_rid[side][c.rid] = list(c.tokens)

        # greedy token identity: the same rid (rep offset included)
        # yields the same tokens on both arms
        shared = set(tokens_by_rid["affinity"]) & set(
            tokens_by_rid["least_loaded"])
        same = sum(
            1 for r in shared
            if tokens_by_rid["affinity"][r]
            == tokens_by_rid["least_loaded"][r]
        )
        identity = same / len(shared) if shared else 0.0
        routes: dict = {}
        for c in arms["affinity"].completions:
            r = (c.flight or {}).get("route")
            if r is not None:
                routes[r] = routes.get(r, 0) + 1

        def arm_row(side):
            rows = rep_rows[side]
            return {
                "mode": f"{side} x{procs}",
                "goodput_tokens_per_sec": _med(
                    [r["goodput_tokens_per_sec"] for r in rows]),
                "hit_rate": _med([r["hit_rate"] for r in rows]),
                "hit_tokens": sum(r["hit_tokens"] for r in rows),
                "miss_tokens": sum(r["miss_tokens"] for r in rows),
                "latency_s": {p: _med([r["latency_s"][p] for r in rows])
                              for p in ("p50", "p90", "p99")},
                "lost": sum(r["lost"] for r in rows),
                "workers": _worker_counts(sups[side],
                                          arms[side].handles),
            }

        aff, ll = arm_row("affinity"), arm_row("least_loaded")
        aff["route_decisions"] = routes
        return {
            "trace": {
                "n_requests": n_requests, "rate_hz": rate_hz,
                "seed": seed, "k_prefixes": k_prefixes,
                "prefix_len": prefix_len,
            },
            "pool": {"num_blocks": num_blocks,
                     "block_size": block_size},
            "procs": procs,
            "reps": reps,
            "affinity": aff,
            "least_loaded": ll,
            # medians of per-rep ratios (order-balanced)
            "hit_rate_ratio": _med([
                (a["hit_rate"] / b["hit_rate"]) if b["hit_rate"]
                else float(a["hit_rate"] > 0)
                for a, b in zip(rep_rows["affinity"],
                                rep_rows["least_loaded"])
            ]),
            "goodput_ratio": _med([
                a["goodput_tokens_per_sec"]
                / b["goodput_tokens_per_sec"]
                for a, b in zip(rep_rows["affinity"],
                                rep_rows["least_loaded"])
            ]),
            "token_identity": identity,
            "lost": aff["lost"] + ll["lost"],
        }
    finally:
        for sup in sups.values():
            sup.stop()


def fleet_autoscale_bench(
    *,
    rate_hz: float = 25.0,
    step_factor: float = 4.0,
    chunk_s: float = 1.0,
    chunks_base: int = 2,
    chunks_step: int = 3,
    chunks_post: int = 7,
    procs: int = 3,
    autoscale_min: int = 1,
    autoscale_max: int = 3,
    standby: int = 1,
    max_slots: int = 8,
    vocab: int = 64,
    hidden: Optional[int] = 128,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 256,
    max_len: int = 128,
    prompt_buckets=(8, 16),
    prompt_len_range=(2, 16),
    max_new_range=(32, 96),
    decode_burst: int = 8,
    eos_id: Optional[int] = 46,
    seed: int = 0,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
) -> dict:
    """Elastic fleet against a fixed fleet under a `step_factor`x
    arrival step, at equal SLO: the same chunked trace (base rate ->
    burst -> base again) through TWO separately built fleets, a fixed
    one provisioned for the peak (`procs` workers: what an operator
    without an autoscaler deploys to survive the burst), then an
    autoscaled one that starts at `autoscale_min` with `standby` warm
    standbys (serve/autoscaler.py). Both arms carry the same
    SLOWatchdog. The elastic arm's claim is goodput per worker-second,
    not raw goodput.

    The keys tools/check_bench.py gates:

    - ``goodput_per_worker_ratio``: elastic useful tokens per
      worker-second over fixed (worker-seconds integrate the active
      fleet size over the scale-event timeline; the fixed arm pays
      `procs` the whole run);
    - ``lost``: submitted but never completed, both arms (a shed is a
      status; lost is a bug);
    - ``reaction_within_window``: 1.0 iff the first scale-up after the
      step landed within ``reaction_window_s`` (one evaluation interval
      and slack) of the first evaluation that SAW trigger pressure (the
      loop's own latency; the queue build before it is
      ``signal_build_s``);
    - ``oscillation_ok``: 1.0 iff direction changes <= the hold-window
      bound floor(elapsed / hold_s) + 1;
    - ``promote_join_s``: warm promotion latency (pool take -> dispatch
      join), to sit far under ``cold_spawn_s``, a cold worker's boot
      measured in the same run.

    `model` reuses a built decoder's widths, precision and device (the
    workers rebuild its weights from seed 0). Each arm reports its live
    workers' own decode steps and kernel launches (`workers`)."""
    from ddp_practice_tpu_torch.serve.autoscaler import (
        Autoscaler,
        AutoscalerConfig,
    )
    from ddp_practice_tpu_torch.serve.scheduler import MonotonicClock
    from ddp_practice_tpu_torch.serve.slo import SLOConfig, SLOWatchdog
    from ddp_practice_tpu_torch.serve.supervisor import (
        SupervisorConfig,
        make_fleet_router,
    )

    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max_len, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, model_name=model_name,
            precision=precision, device=device)

    def chunk(rate: float, k: int):
        return build_trace(
            n_requests=max(8, int(rate * chunk_s)), rate_hz=rate,
            vocab=model.vocab_size, prompt_len_range=prompt_len_range,
            max_new_range=max_new_range, seed=seed + 7 * k + 1,
        )

    step_rate = rate_hz * step_factor
    total_chunks = chunks_base + chunks_step + chunks_post
    spec = _worker_spec(model, {
        "max_slots": max_slots, "max_len": max_len,
        "prompt_buckets": list(prompt_buckets),
        "temperature": 0.0, "decode_burst": decode_burst,
        "eos_id": eos_id,
    }, max_queue=int(step_rate * chunk_s) * (total_chunks + 2))
    # the elastic policy: trip fast (a sub-second evaluation interval,
    # up_pressure under the router's brown-out threshold so growth fires
    # before shedding clamps the signal), resolve slow (calm must hold
    # down_stable_s, reversals blocked inside hold_s)
    acfg = AutoscalerConfig(
        min_size=autoscale_min, max_size=autoscale_max,
        eval_interval_s=0.4, up_pressure=1.3, down_pressure=0.45,
        hold_s=4.0, cooldown_up_s=1.0, cooldown_down_s=3.0,
        down_stable_s=1.5, standby_target=standby,
    )
    # "within one evaluation window" of the signal: the commit may land
    # an evaluation after the crossing one, plus scheduling slack
    reaction_window_s = acfg.eval_interval_s + 0.25

    def slo_watchdog(clock):
        # equal SLO: both arms get this config
        return SLOWatchdog(SLOConfig(
            ttft_p99_s=1.5, fast_window_s=1.5, slow_window_s=5.0,
            trip_burn=2.0, resolve_burn=1.0, min_events=8,
        ), clock=clock)

    def drain_frames(router) -> None:
        deadline = time.monotonic() + 0.3
        while time.monotonic() < deadline:
            router.step()
            _fleet_wait(router, 0.01)

    def integrate_size(events, t0, t1, size0) -> float:
        """Worker-seconds from the scale-event ledger: the active size,
        piecewise constant over [t0, t1] (event "t" is on the bench's
        monotonic clock)."""
        pts = [(t0, size0)]
        for e in events:
            if t0 <= e["t"] <= t1:
                pts.append((e["t"], e["size"]))
        ws = 0.0
        last_t, last_s = pts[0]
        for t, s in pts[1:]:
            ws += (t - last_t) * last_s
            last_t, last_s = t, s
        ws += (t1 - last_t) * last_s
        return ws

    def run_arm(auto: bool) -> dict:
        clock = MonotonicClock()
        n0 = autoscale_min if auto else procs
        router, sup, _handles = make_fleet_router(
            spec, n0, clock=clock,
            sup_config=SupervisorConfig(restart_base_s=0.25,
                                        shrink_kill_after_s=10.0),
            slo=slo_watchdog(clock),
        )
        asc = None
        cold_spawn_s = None
        try:
            if auto:
                asc = Autoscaler(router, sup, spec, config=acfg,
                                 clock=clock)
                router.autoscaler = asc
                t0 = time.monotonic()
                if not asc.pool.wait_ready(timeout_s=300.0, n=standby):
                    raise RuntimeError(
                        f"standby pool never warmed: "
                        f"{asc.pool.spawn_errors}")
                # the pool's fill IS a cold spawn: the latency a warm
                # promotion buys its way out of
                cold_spawn_s = time.monotonic() - t0
            # untimed shakeout through the seam
            _replay(router, chunk(rate_hz, 0), rid_offset=90_000_000,
                    fleet=True)
            drain_frames(router)

            rows = []

            def run_chunk(rate: float, k: int) -> None:
                rows.append(_replay_row(
                    router, chunk(rate, k),
                    rid_offset=(k + 1) * 1_000_000, fleet=True))
                drain_frames(router)

            t_start = time.monotonic()
            size0 = sup.active_slots()
            k = 1
            for _ in range(chunks_base):
                run_chunk(rate_hz, k)
                k += 1
            t_burst = time.monotonic()
            for _ in range(chunks_step):
                run_chunk(step_rate, k)
                k += 1
            for _ in range(chunks_post):
                run_chunk(rate_hz, k)
                k += 1
            if auto:
                # let drains in flight retire, so the worker-seconds
                # ledger charges the elastic arm for its drain tail
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline and asc._draining:
                    router.step()
                    _fleet_wait(router, 0.02)
            t_end = time.monotonic()

            events = list(asc.events) if auto else []
            ws = (integrate_size(events, t_start, t_end, size0)
                  if auto else procs * (t_end - t_start))
            useful = sum(r["useful_tokens"] for r in rows)
            statuses: dict = {}
            for r in rows:
                for s, n in r["statuses"].items():
                    statuses[s] = statuses.get(s, 0) + n
            arm = {
                "mode": "autoscaled" if auto else "fixed",
                "workers_start": n0,
                "elapsed_s": t_end - t_start,
                "worker_seconds": ws,
                "useful_tokens": useful,
                "goodput_per_worker": useful / ws if ws > 0 else 0.0,
                "lost": sum(r["lost"] for r in rows),
                "statuses": statuses,
                "slo": router.slo.burn_signal(),
                "workers": _worker_counts(sup, router.handles),
            }
            if auto:
                ups = [e for e in events if e["direction"] == "up"]
                post = [e for e in ups if e["t"] >= t_burst]
                warm = [e for e in ups if e.get("warm")]
                dirs = [e["direction"] for e in events]
                changes = sum(1 for a, b in zip(dirs, dirs[1:])
                              if a != b)
                bound = int((t_end - t_start) / acfg.hold_s) + 1
                reaction_s = signal_build_s = None
                if post:
                    # the first evaluation after the step that SAW
                    # trigger pressure: reaction is the loop's latency
                    # from it; the queue build before it is physics
                    t_up = post[0]["t"]
                    xs = [r["t"] for r in asc.pressure_log
                          if t_burst <= r["t"] <= t_up
                          and r["pressure"] >= acfg.up_pressure]
                    signal_t = xs[0] if xs else t_up
                    reaction_s = t_up - signal_t
                    signal_build_s = signal_t - t_burst
                arm.update({
                    "final_size": sup.active_slots(),
                    "cold_spawn_s": cold_spawn_s,
                    "reaction_s": reaction_s,
                    "signal_build_s": signal_build_s,
                    "promote_join_s": (warm[0]["join_s"]
                                       if warm else None),
                    "direction_changes": changes,
                    "oscillation_bound": bound,
                    "scale_events": events,
                    "autoscaler": asc.snapshot(),
                })
            return arm
        finally:
            if asc is not None:
                asc.close()
            sup.stop()

    fixed = run_arm(auto=False)
    auto = run_arm(auto=True)
    reaction_s = auto.get("reaction_s")
    gpw_ratio = (auto["goodput_per_worker"]
                 / max(fixed["goodput_per_worker"], 1e-9))
    return {
        "rate_hz": rate_hz,
        "step_rate_hz": step_rate,
        "step_factor": step_factor,
        "chunk_s": chunk_s,
        "chunks": {"base": chunks_base, "step": chunks_step,
                   "post": chunks_post},
        "procs_fixed": procs,
        "autoscale": {"min": autoscale_min, "max": autoscale_max,
                      "standby": standby,
                      "eval_interval_s": acfg.eval_interval_s,
                      "hold_s": acfg.hold_s,
                      "up_pressure": acfg.up_pressure,
                      "down_pressure": acfg.down_pressure},
        "gate": ("goodput/worker >= fixed at equal SLO, react within "
                 "one eval window, no thrash, zero lost, warm "
                 "promotion << cold spawn"),
        "fixed": fixed,
        "autoscaled": auto,
        "goodput_per_worker_ratio": gpw_ratio,
        "lost": fixed["lost"] + auto["lost"],
        "reaction_s": reaction_s,
        "signal_build_s": auto.get("signal_build_s"),
        "reaction_window_s": reaction_window_s,
        "reaction_within_window": (
            1.0 if reaction_s is not None
            and reaction_s <= reaction_window_s else 0.0),
        "oscillation_ok": (
            1.0 if auto["direction_changes"]
            <= auto["oscillation_bound"] else 0.0),
        "promote_join_s": auto.get("promote_join_s"),
        "cold_spawn_s": auto.get("cold_spawn_s"),
    }


def _score_streams(router, comps) -> dict:
    """Score and CLEAR the router's TokenStreams from the consumer's
    seat (the bench IS the consumer). Everything here is re-derived
    from the delivered events, independently of the router's own
    cursors: `chunk_dupes`/`chunk_gaps` recount token-offset overlaps
    and holes (the exactly-once gate pins both at 0 — `suppressed` is
    the router absorbing re-decoded salvage and is EXPECTED under
    chaos), `inter_token_s` is the per-token delivery cadence between
    consecutive chunk arrivals, `consumer_ttft_s` is first DELIVERED
    token minus arrival, and `resume_gap_s` is the consumer-visible
    stall a failover splice cost each resumed stream."""
    arrival = {c.rid: c.arrival for c in comps}
    final_tokens = {c.rid: c.tokens for c in comps}
    inter, ttft, gaps_s = [], [], []
    dupes = holes = suppressed = resumed = 0
    unterminated = mismatched = 0
    for rid, st in router.streams.items():
        delivered = 0
        last_t = None
        for ev in st.events:
            if ev.kind == "resumed":
                resumed += 1
                continue
            if ev.kind != "tokens" or not ev.tokens:
                continue
            if ev.start < delivered:
                dupes += delivered - ev.start
            elif ev.start > delivered:
                holes += ev.start - delivered
            delivered = ev.start + len(ev.tokens)
            if last_t is None:
                if rid in arrival:
                    ttft.append(ev.t - arrival[rid])
            else:
                # one chunk = one consumer-visible delivery; its tokens
                # share the arrival instant, so the per-token cadence is
                # the chunk gap amortized over the chunk
                inter.extend([(ev.t - last_t) / len(ev.tokens)]
                             * len(ev.tokens))
            last_t = ev.t
        if not st.closed:
            unterminated += 1
        if st.tokens() != final_tokens.get(rid, st.tokens()):
            mismatched += 1  # stream view disagrees with completion
        if st.resume_gap_s:
            gaps_s.append(st.resume_gap_s)
        suppressed += st.suppressed
        holes += st.gaps
    n = len(router.streams)
    router.streams.clear()
    return {
        "streams": n,
        "chunk_dupes": dupes,
        "chunk_gaps": holes,
        "suppressed_tokens": suppressed,
        "resumed_markers": resumed,
        "unterminated": unterminated,
        "stream_completion_mismatches": mismatched,
        "inter_token_s": _percentiles(inter),
        "consumer_ttft_s": _percentiles(ttft),
        "resume_gap_s": _percentiles(gaps_s),
        "resume_gap_p99_s": (_percentiles(gaps_s).get("p99", 0.0)
                             if gaps_s else 0.0),
        "inter_token_p99_s": (_percentiles(inter).get("p99", 0.0)
                              if inter else 0.0),
    }


class _ChunkLog:
    """The router's telemetry seam held in memory: every stream event's
    `chunk` line (Router._stream_emit), the records the reference's
    JSONL exporter writes and tools/check_stream.py audits. The JSONL
    exporter itself is ROADMAP A6d."""

    def __init__(self) -> None:
        self.records: list = []

    def emit(self, kind: str, **fields) -> None:
        self.records.append({"kind": kind, **fields})

    def on_completion(self, completion, **_kw) -> None:
        pass


def _chunk_audit(records) -> dict:
    """tools/check_stream.py's verdict over chunk lines."""
    try:
        from tools.check_stream import stream_verdict
    except ImportError:  # tools/ not importable (installed package)
        return {"ok": None}
    ok, audit = stream_verdict([r for r in records
                                if r.get("kind") == "chunk"])
    return {"ok": ok, "streams": audit["streams"],
            "violations": sum(len(v)
                              for v in audit["violations"].values())}


def streaming_bench(
    *,
    n_requests: int = 32,
    rate_hz: float = 8.0,
    procs: int = 2,
    max_slots: int = 8,
    vocab: int = 64,
    hidden: Optional[int] = 128,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 256,
    max_len: int = 128,
    prompt_buckets=(8, 16),
    prompt_len_range=(2, 16),
    max_new_range=(2, 32),
    decode_burst: int = 8,
    eos_id: Optional[int] = 46,
    seed: int = 0,
    reps: int = 6,
    fault_plan=None,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
    telemetry_out: Optional[str] = None,
) -> dict:
    """Token STREAMING through the worker fleet, two operating points:

    - overhead (no kill plan): the same trace replays through TWO warm
      worker fleets — streaming delivery (chunks in every pub frame,
      router TokenStreams armed) vs end-of-request delivery (chunk
      plane off, worker-side and router-side) — in alternating order
      per rep; the headline is the median per-rep MEAN-latency ratio.
      Every rep also cross-checks each stream's concatenation against
      its completion.
    - chaos (`fault_plan` with kill specs): ONE streaming fleet, real
      signals mid-stream, and the report is the CONSUMER'S ledger —
      re-derived duplicate/missing token counts (gated at zero),
      inter-token p99 at the consumer, resume-gap p99, resumed-marker
      count, and the tools/check_stream.py audit over the run's chunk
      lines (held in memory: the JSONL exporter behind `telemetry_out`
      is ROADMAP A6d and raises naming it).

    The workers serve `model`'s widths on `model`'s device (built from
    the width arguments when None), weights from seed 0."""
    from ddp_practice_tpu_torch.serve.faults import FleetFaultDriver
    from ddp_practice_tpu_torch.serve.router import RouterConfig
    from ddp_practice_tpu_torch.serve.supervisor import (
        SupervisorConfig,
        make_fleet_router,
    )

    if telemetry_out is not None:
        raise _a6d("streaming_bench(telemetry_out=)")
    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max_len, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, model_name=model_name,
            precision=precision, device=device)
    trace = build_trace(
        n_requests=n_requests, rate_hz=rate_hz, vocab=model.vocab_size,
        prompt_len_range=prompt_len_range, max_new_range=max_new_range,
        seed=seed,
    )
    chaos = fault_plan is not None and bool(fault_plan.kills())
    if fault_plan is not None and not chaos:
        raise ValueError("streaming_bench interprets only 'kill' specs")
    if chaos:
        _refuse_sim_faults(fault_plan, procs)
    engine_kw = {
        "max_slots": max_slots, "max_len": max_len,
        "prompt_buckets": list(prompt_buckets), "temperature": 0.0,
        "decode_burst": decode_burst, "eos_id": eos_id,
    }
    max_queue = len(trace) * max(1, reps)

    def build(stream: bool, telemetry=None):
        return make_fleet_router(
            _worker_spec(model, dict(engine_kw), max_queue=max_queue,
                         stream=stream),
            procs,
            config=RouterConfig(streaming=stream),
            sup_config=SupervisorConfig(restart_base_s=0.25),
            telemetry=telemetry,
        )

    report = {
        "device": _device_name(model),
        "trace": {
            "n_requests": n_requests, "rate_hz": rate_hz, "seed": seed,
            "prompt_len_range": list(prompt_len_range),
            "max_new_range": list(max_new_range),
        },
        "procs": procs,
    }

    if chaos:
        # ---------------- chaos arm: one streaming fleet, real kills
        log = _ChunkLog()
        router, sup, handles = build(True, telemetry=log)
        try:
            driver = FleetFaultDriver(fault_plan, sup.kill)
            before = len(router.completions)
            row = _replay_row(router, trace, driver=driver,
                                         fleet=True)
            comps = router.completions[before:]
            streams = _score_streams(router, comps)
            m = router.metrics
            row.update({
                "mode": f"stream fleet x{procs}",
                "failovers": m.failovers.value,
                "retries": m.retries.value,
                "worker_restarts": list(sup.restarts),
                "kills_fired": [
                    {"replica": f.replica, "sig": f.sig, "at_s": f.at_s}
                    for f in driver.fired
                ],
                "workers": _worker_counts(sup, handles),
            })
        finally:
            sup.stop()
        report.update({
            "reps": 1,
            "fleet": row,
            "fault_plan": fault_plan.to_json(),
            # the gated keys: exactly-once re-derived at the consumer
            "chunk_dupes": streams["chunk_dupes"],
            "chunk_gaps": streams["chunk_gaps"],
            "lost": row["lost"],
            "unterminated": streams["unterminated"],
            "stream_completion_mismatches":
                streams["stream_completion_mismatches"],
            "inter_token_p99_s": streams["inter_token_p99_s"],
            "resume_gap_p99_s": streams["resume_gap_p99_s"],
            "streams": streams,
            # the same contract judged offline from the chunk lines alone
            "check_stream": _chunk_audit(log.records),
        })
        return report

    # ------------- overhead arm: streaming vs end-of-request delivery
    r_on, sup_on, _ = build(True)
    try:
        r_off, sup_off, _ = build(False)
    except BaseException:
        sup_on.stop()
        raise
    rows = {"on": [], "off": []}
    mismatches = 0
    try:
        for rep in range(reps):
            order = ["on", "off"] if rep % 2 == 0 else ["off", "on"]
            for side in order:
                router = r_on if side == "on" else r_off
                before = len(router.completions)
                rows[side].append(_replay_row(
                    router, trace, rid_offset=rep * 1_000_000, fleet=True))
                if side == "on":
                    streams = _score_streams(
                        router, router.completions[before:])
                    mismatches += (
                        streams["stream_completion_mismatches"]
                        + streams["chunk_dupes"] + streams["chunk_gaps"]
                        + streams["unterminated"])
                    rows[side][-1]["streams"] = streams
        ratios_mean = [on["latency_s"]["mean"] / off["latency_s"]["mean"]
                       for on, off in zip(rows["on"], rows["off"])]
        ratios_p50 = [on["latency_s"]["p50"] / off["latency_s"]["p50"]
                      for on, off in zip(rows["on"], rows["off"])]
        report.update({
            "reps": reps,
            "gate": "mean <= 1.05x",
            "latency_ratio_mean": _med(ratios_mean),
            "latency_ratio_mean_per_rep": ratios_mean,
            "latency_ratio_p50": _med(ratios_p50),
            "goodput_ratio": _med(
                [on["goodput_tokens_per_sec"]
                 / off["goodput_tokens_per_sec"]
                 for on, off in zip(rows["on"], rows["off"])]),
            "streaming": {
                "latency_s": rows["on"][-1]["latency_s"],
                "lost": sum(r["lost"] for r in rows["on"]),
                "last_rep_streams": rows["on"][-1]["streams"],
            },
            "end_of_request": {
                "latency_s": rows["off"][-1]["latency_s"],
                "lost": sum(r["lost"] for r in rows["off"]),
            },
            # every rep's exactly-once cross-check, summed: stream-vs-
            # completion disagreements + re-derived dupes/gaps +
            # unterminated streams (all must be 0 fault-free)
            "stream_violations": mismatches,
        })
        return report
    finally:
        sup_on.stop()
        sup_off.stop()


def _mixed_prefill_trace(*, n_requests, rate_hz, vocab, long_len,
                         short_range=(2, 10), max_new_range=(4, 8),
                         seed=0) -> list:
    """Every third request carries a LONG cold prompt, the rest are
    short interactive ones — the Sarathi mixed workload where one
    monolithic long prefill head-of-line-blocks every short request
    queued behind it. Chunked prefill's whole claim is the short
    requests' TTFT tail on exactly this trace."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, n_requests)
    arrivals = np.cumsum(gaps)
    trace = []
    for i in range(n_requests):
        long = i % 3 == 0
        plen = (long_len if long
                else int(rng.integers(short_range[0], short_range[1] + 1)))
        trace.append({
            "rid": i,
            "arrival": float(arrivals[i]),
            "prompt": rng.integers(0, vocab, plen).tolist(),
            "max_new_tokens": int(rng.integers(
                max_new_range[0], max_new_range[1] + 1)),
            "long": long,
        })
    return trace


def _wire_replay(port, trace, *, body_extra=None,
                 timeout_s: float = 600.0) -> tuple:
    """Fire one arrival trace at a live Frontdoor through REAL client
    sockets — one thread per request, sleeping to its Poisson arrival,
    then a blocking `sse_request`. Returns ``({rid: {status, sent,
    events}}, elapsed_s)``; `body_extra(t)` merges per-request fields
    (sampling knobs, tenant) into the POSTed JSON."""
    import threading

    from ddp_practice_tpu_torch.serve.frontdoor import sse_request

    results: dict = {}
    lock = threading.Lock()
    t0 = time.monotonic()

    def one(t):
        wait = t0 + t["arrival"] - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        body = {"prompt": t["prompt"],
                "max_new_tokens": t["max_new_tokens"], "seed": 0}
        if body_extra is not None:
            body.update(body_extra(t))
        sent = time.monotonic()
        try:
            status, events = sse_request(
                "127.0.0.1", port, body, timeout_s=timeout_s)
        except OSError:
            status, events = -1, []
        with lock:
            results[t["rid"]] = {
                "status": status, "sent": sent, "events": events}

    threads = [threading.Thread(target=one, args=(t,), daemon=True)
               for t in trace]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results, time.monotonic() - t0


def _score_wire(trace, results, elapsed) -> tuple:
    """Score a wire replay the way _replay_row scores an
    in-process one — goodput over terminal-ok streams, client-side
    TTFT/latency percentiles, loss — and keep the raw SSE capture
    (`{"stream", "id", "event", "data"}` records) for the
    tools/check_stream.py --sse audit. Returns (row, tokens_by_rid,
    capture)."""
    tokens: dict = {}
    capture: list = []
    ttfts, lats = [], []
    statuses: dict = {}
    ended_ok = 0
    resumed = 0
    ok_tokens = 0
    for t in trace:
        rid = t["rid"]
        r = results.get(rid)
        if r is None or r["status"] != 200:
            key = f"http_{r['status'] if r else 'none'}"
            statuses[key] = statuses.get(key, 0) + 1
            continue
        toks: list = []
        end_status = None
        first_tok_t = None
        for ev in r["events"]:
            capture.append({"stream": f"rid:{rid}", "id": ev["id"],
                            "event": ev["event"], "data": ev["data"]})
            data = ev["data"] if isinstance(ev["data"], dict) else {}
            if ev["event"] == "tokens":
                toks.extend(data.get("tokens") or [])
                if first_tok_t is None:
                    first_tok_t = ev["t"]
            elif ev["event"] == "resumed":
                resumed += 1
            elif ev["event"] == "end":
                end_status = data.get("status")
        tokens[rid] = toks
        key = end_status if end_status is not None else "unterminated"
        statuses[key] = statuses.get(key, 0) + 1
        if end_status in ("eos", "length", "stop"):
            ended_ok += 1
            ok_tokens += len(toks)
            if first_tok_t is not None:
                ttfts.append(first_tok_t - r["sent"])
            lats.append(r["events"][-1]["t"] - r["sent"])
    row = {
        "elapsed_s": elapsed,
        "useful_tokens": ok_tokens,
        "goodput_tokens_per_sec": ok_tokens / elapsed,
        "ttft_s": _percentiles(ttfts) if ttfts else {},
        "latency_s": _percentiles(lats) if lats else {},
        "completions": ended_ok,
        "lost": len(trace) - ended_ok,
        "statuses": statuses,
        "resumed_markers": resumed,
    }
    return row, tokens, capture


def _sse_audit(capture) -> dict:
    """The offline wire audit, in-process: map the SSE capture through
    tools/check_stream.py --sse and report the verdict (the bench's own
    acceptance row, same rules the CLI applies to a dump)."""
    try:
        from tools.check_stream import sse_to_chunks, stream_verdict
    except ImportError:  # tools/ not importable (installed package)
        return {"ok": None}
    ok, audit = stream_verdict(sse_to_chunks(capture))
    return {
        "ok": ok, "streams": audit["streams"],
        "violations": sum(len(v) for v in audit["violations"].values()),
    }


def _shape_count(stats) -> int:
    if isinstance(stats, dict):
        return sum(_shape_count(v) for v in stats.values())
    return int(stats)


def frontdoor_bench(
    *,
    n_requests: int = 24,
    rate_hz: float = 100.0,
    max_slots: int = 8,
    vocab: int = 32,
    hidden: Optional[int] = 64,
    depth: Optional[int] = 2,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 128,
    max_len: int = 96,
    prompt_buckets=(16,),
    prompt_len_range=(2, 16),
    max_new_range=(4, 24),
    decode_burst: int = 8,
    procs: int = 2,
    seed: int = 0,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
    sse_out: Optional[str] = None,
) -> dict:
    """End-to-end HTTP/SSE front door (serve/frontdoor.py), four arms:

    - **wire vs in-process** — the SAME Poisson trace replays through a
      bare `Router.stream` loop and through real client sockets against
      a Frontdoor over an identical router. `token_identity` (greedy
      streams identical across the wire, 1.0), `goodput_ratio`
      (wire/in-process), and the wire capture audited by
      tools/check_stream.py --sse (`check_stream.ok`).
    - **chunked prefill TTFT** — a mixed long/short trace (long prompts
      of 720) through two paged + prefix-cache front doors,
      `prefill_chunk` 32 against 0: `ttft_p99_ratio_chunked`, the SHORT
      requests' client-side TTFT p99 ratio, and the two arms' token
      identity.
    - **mid-stream SIGKILL** — the same wire consumer against a
      `procs`-worker FLEET front door with a real SIGKILL 0.75 s into
      the replay: `sigkill_lost` == 0 (every socket still gets its
      typed terminal; resumes splice under the same ids the --sse audit
      checks).
    - **mixed sampling churn** — greedy and per-request sampled traffic
      through one per_slot_sampling engine: `sampling_new_compiles` == 0
      (the engine's shape counts, port serve/engine.py compile_stats,
      stay flat).

    `max_len`, `prompt_buckets`, `prompt_len_range` and `max_new_range`
    size arms 1, 3 and 4 (the reference's values by default). `model`
    reuses a built decoder (arm 2 needs max_len >= 1024); the workers of
    arm 3 rebuild its weights from its widths and seed 0. Every
    in-process row reports `decode_steps` and `kernel_launches`, the
    SIGKILL row each live worker's own (`workers`)."""
    import threading

    from ddp_practice_tpu_torch.serve.engine import EngineConfig, PagedEngine
    from ddp_practice_tpu_torch.serve.frontdoor import (
        Frontdoor,
        FrontdoorConfig,
    )
    from ddp_practice_tpu_torch.serve.metrics import ServeMetrics
    from ddp_practice_tpu_torch.serve.router import (
        Router,
        RouterConfig,
        make_router,
    )
    from ddp_practice_tpu_torch.serve.scheduler import (
        MonotonicClock,
        Request,
        Scheduler,
    )
    from ddp_practice_tpu_torch.serve.supervisor import (
        SupervisorConfig,
        make_fleet_router,
    )

    long_len = 720
    if model is None:
        model = _build_model(
            vocab=vocab, max_len=max(1024, max_len), hidden=hidden,
            depth=depth, heads=heads, mlp=mlp, model_name=model_name,
            precision=precision, device=device)
    if model.max_len < 1024:
        raise ValueError("frontdoor_bench's chunked-prefill arm needs a "
                         "model with max_len >= 1024")
    vocab = model.vocab_size
    trace = build_trace(
        n_requests=n_requests, rate_hz=rate_hz, vocab=vocab,
        prompt_len_range=prompt_len_range, max_new_range=max_new_range,
        seed=seed,
    )
    ecfg = EngineConfig(
        max_slots=max_slots, max_len=max_len,
        prompt_buckets=tuple(prompt_buckets), temperature=0.0,
        decode_burst=decode_burst, eos_id=None,
    )
    report: dict = {
        "device": _device_name(model),
        "trace": {
            "n_requests": n_requests, "rate_hz": rate_hz, "seed": seed,
            "prompt_len_range": list(prompt_len_range),
            "max_new_range": list(max_new_range),
        },
    }

    # ---------------- arm 1: wire identity + goodput vs in-process
    launches = _launches()
    ip_router = make_router(model, 1, ecfg)
    ip_router.warmup()
    row_ip = _replay_row(ip_router, trace)
    ref_tokens = {t["rid"]: ip_router.stream(t["rid"]).tokens()
                  for t in trace}
    row_ip["mode"] = "in-process router.stream"
    row_ip.update(_router_counts(ip_router, launches))
    report["in_process"] = row_ip

    launches = _launches()
    fd = Frontdoor(make_router(model, 1, ecfg), config=FrontdoorConfig())
    fd.driver.router.warmup()
    fd.start()
    try:
        results, elapsed = _wire_replay(fd.port, trace)
    finally:
        fd.close()
    row_wire, wire_tokens, capture = _score_wire(trace, results, elapsed)
    row_wire["mode"] = "frontdoor wire"
    row_wire.update(_router_counts(fd.driver.router, launches))
    matched = sum(
        1 for t in trace
        if wire_tokens.get(t["rid"]) == ref_tokens[t["rid"]]
        and ref_tokens[t["rid"]]
    )
    report.update({
        "wire": row_wire,
        "token_identity": matched / len(trace),
        "goodput_ratio": (row_wire["goodput_tokens_per_sec"]
                          / row_ip["goodput_tokens_per_sec"]),
        "check_stream": _sse_audit(capture),
    })

    # ---------------- arm 2: chunked prefill TTFT on mixed long/short
    mixed = _mixed_prefill_trace(
        n_requests=18, rate_hz=rate_hz, vocab=vocab, long_len=long_len,
        seed=seed,
    )

    def paged_frontdoor(chunk: int) -> Frontdoor:
        # bucket 768 + a burst-rounded reservation + the request's own
        # new tokens: leave two bursts of headroom past the bucket
        cap_blocks = -(-(768 + 2 * 32 + decode_burst) // 16)
        engine = PagedEngine(
            model,
            EngineConfig(
                max_slots=4, max_len=1024,
                prompt_buckets=(16, 32, 768), temperature=0.0,
                decode_burst=decode_burst, eos_id=None,
                block_size=16, max_blocks_per_slot=cap_blocks,
                num_blocks=1 + 4 * cap_blocks,
                prefix_cache=True, prefill_chunk=chunk,
            ),
        )
        clock = MonotonicClock()
        sched = Scheduler(engine, clock=clock, max_queue=len(mixed),
                          metrics=ServeMetrics())
        router = Router([sched], clock=clock)
        router.warmup()
        return Frontdoor(router, config=FrontdoorConfig())

    chunk_rows = {}
    chunk_tokens = {}
    for label, chunk in (("unchunked", 0), ("chunked", 32)):
        launches = _launches()
        fd2 = paged_frontdoor(chunk)
        fd2.start()
        try:
            results, elapsed = _wire_replay(fd2.port, mixed)
        finally:
            fd2.close()
        row, toks, cap = _score_wire(mixed, results, elapsed)
        row["mode"] = f"paged frontdoor, prefill_chunk {chunk}"
        row["check_stream"] = _sse_audit(cap)
        short_ttfts = []
        for t in mixed:
            r = results.get(t["rid"])
            if t["long"] or r is None or r["status"] != 200:
                continue
            first = next((ev["t"] for ev in r["events"]
                          if ev["event"] == "tokens"), None)
            if first is not None:
                short_ttfts.append(first - r["sent"])
        row["ttft_short_s"] = (_percentiles(short_ttfts)
                               if short_ttfts else {})
        row.update(_router_counts(fd2.driver.router, launches))
        chunk_rows[label] = row
        chunk_tokens[label] = toks
    ttft_ratio = (chunk_rows["chunked"]["ttft_short_s"]["p99"]
                  / chunk_rows["unchunked"]["ttft_short_s"]["p99"])
    report.update({
        "chunked_prefill": {
            "trace": {"n_requests": len(mixed), "long_len": long_len,
                      "prefill_chunk": 32},
            "chunked": chunk_rows["chunked"],
            "unchunked": chunk_rows["unchunked"],
            "token_identity": sum(
                1 for t in mixed
                if chunk_tokens["chunked"].get(t["rid"])
                == chunk_tokens["unchunked"].get(t["rid"])
                and chunk_tokens["unchunked"].get(t["rid"])
            ) / len(mixed),
        },
        "ttft_p99_ratio_chunked": ttft_ratio,
    })

    # ---------------- arm 3: mid-stream worker SIGKILL, zero lost
    kill_trace = [
        dict(t, rid=t["rid"] + 300_000, max_new_tokens=32)
        for t in build_trace(
            n_requests=12, rate_hz=rate_hz, vocab=vocab,
            prompt_len_range=prompt_len_range, max_new_range=(24, 48),
            seed=seed + 1,
        )
    ]
    router_f, sup, handles = make_fleet_router(
        _worker_spec(
            model,
            {"max_slots": max_slots, "max_len": max_len,
             "prompt_buckets": list(prompt_buckets), "temperature": 0.0,
             "decode_burst": decode_burst, "eos_id": None},
            max_queue=len(kill_trace), stream=True,
        ),
        procs,
        config=RouterConfig(streaming=True),
        sup_config=SupervisorConfig(restart_base_s=0.25),
    )
    kill_at_s = 0.75
    killer = threading.Timer(kill_at_s, sup.kill, (0, "SIGKILL"))
    try:
        fd3 = Frontdoor(router_f, config=FrontdoorConfig())
        fd3.start()
        try:
            killer.start()
            results, elapsed = _wire_replay(fd3.port, kill_trace)
        finally:
            killer.cancel()
            fd3.close()
        workers = _worker_counts(sup, handles)
    finally:
        sup.stop()
    row_kill, _, kill_capture = _score_wire(kill_trace, results, elapsed)
    row_kill["mode"] = f"frontdoor fleet x{procs} + SIGKILL"
    capture.extend(kill_capture)
    report.update({
        "sigkill": {
            **row_kill,
            "kill_at_s": kill_at_s,
            "worker_restarts": list(sup.restarts),
            "workers": workers,
            "check_stream": _sse_audit(kill_capture),
        },
        "sigkill_lost": row_kill["lost"],
    })

    # ---------------- arm 4: mixed greedy+sampled, zero new shapes
    launches = _launches()
    ecfg_s = dataclasses.replace(ecfg, per_slot_sampling=True)
    router_s = make_router(model, 1, ecfg_s)
    router_s.warmup()
    # settle: one greedy + one sampled request so every shape the mixed
    # traffic exercises is resident BEFORE the snapshot
    router_s.submit(Request(rid=400_000, prompt=[1, 2, 3],
                            max_new_tokens=4))
    router_s.submit(Request(rid=400_001, prompt=[4, 5, 6],
                            max_new_tokens=4, temperature=0.9,
                            top_k=8, top_p=0.9, seed=7))
    router_s.run_until_idle()
    before = router_s.compile_stats()
    churn = [
        dict(t, rid=t["rid"] + 410_000)
        for t in build_trace(
            n_requests=16, rate_hz=rate_hz, vocab=vocab,
            prompt_len_range=prompt_len_range, max_new_range=(4, 16),
            seed=seed + 2,
        )
    ]

    def sampling_fields(t):
        i = t["rid"] - 410_000
        if i % 2 == 0:
            return {}
        return {"temperature": 0.6 + 0.05 * (i % 5),
                "top_k": 8 if i % 4 == 1 else 0,
                "top_p": 0.9 if i % 4 == 3 else 0.0,
                "seed": i}

    fd4 = Frontdoor(router_s, config=FrontdoorConfig())
    fd4.start()
    try:
        results, elapsed = _wire_replay(
            fd4.port, churn, body_extra=sampling_fields)
    finally:
        fd4.close()
    row_mix, _, mix_capture = _score_wire(churn, results, elapsed)
    after = router_s.compile_stats()
    report.update({
        "sampling": {
            **row_mix,
            "mode": "per_slot_sampling mixed greedy+sampled",
            "compile_stats_before": before,
            "compile_stats_after": after,
            "check_stream": _sse_audit(mix_capture),
            **_router_counts(router_s, launches),
        },
        "sampling_new_compiles": _shape_count(after) - _shape_count(before),
    })

    if sse_out:
        with open(sse_out, "w") as f:
            for rec in capture:
                f.write(json.dumps(rec) + "\n")
        report["sse_out"] = sse_out
    return report


def _tenant_rows_from(completions) -> dict:
    """Per-tenant latency/volume rows over one arm's completions.

    `window_tokens` counts only tokens delivered while load was still
    ARRIVING (finish <= the last arrival) — the contended window.
    These runs drain to idle, so TOTAL delivered tokens always equal
    the offered totals whatever the scheduler did; only the
    window-bounded count can show who actually got served during the
    fight, which is what Jain's index is judged over."""
    from ddp_practice_tpu_torch.serve.fairshare import tenant_name

    by: dict = {}
    for c in completions:
        by.setdefault(tenant_name(getattr(c, "tenant", None)),
                      []).append(c)
    window_end = max((c.arrival for c in completions
                      if c.arrival is not None), default=None)
    out = {}
    for t, comps in sorted(by.items()):
        ok = [c for c in comps if c.status in ("eos", "length")]
        out[t] = {
            "completions": len(comps),
            "ok": len(ok),
            "output_tokens": sum(len(c.tokens) for c in ok),
            "window_tokens": sum(
                len(c.tokens) for c in ok
                if window_end is not None and c.finish is not None
                and c.finish <= window_end),
            "ttft_s": _percentiles(
                [c.ttft for c in ok if c.ttft is not None]),
            "latency_s": _percentiles(
                [c.finish - c.arrival for c in ok]),
        }
    return out


def qos_bench(
    *,
    rate_hz: float = 100.0,
    duration_s: float = 2.0,
    hostile_share: float = 4.0,
    procs: int = 2,
    max_slots: int = 2,
    vocab: int = 64,
    # heavier than the other serve benches on purpose: the arm is only
    # a fairness experiment if 100 req/s genuinely saturates the
    # fleet, so per-step cost is tuned to put capacity well BELOW the
    # hostile tenant's offered token rate
    hidden: Optional[int] = 256,
    depth: Optional[int] = 4,
    heads: Optional[int] = 4,
    mlp: Optional[int] = 512,
    decode_burst: int = 2,
    seed: int = 0,
    slo=None,
    workload=None,
    kill_at_s: float = 0.75,
    model_name: str = "lm_tiny",
    precision: str = "fp32",
    device="cuda",
    model=None,
    telemetry_out=None,
    trace_out=None,
) -> dict:
    """The multi-tenant QoS lab's bench: one adversarial workload plan
    (serve/workload.py — a hostile tenant offering `hostile_share`x the
    compliant tenant's rate) replayed through three arms:

    - **FIFO** — RouterConfig(fair=False): the control. The hostile
      tenant's backlog head-of-line-blocks the compliant tenant.
    - **fair** — RouterConfig(fair=True): per-tenant weighted-fair
      queues (serve/fairshare.py VTC) + a TenantSLORegistry:
      ``isolation_ttft_p99_ratio`` (compliant tenant's TTFT p99,
      fair/FIFO; the reference's acceptance <= 0.7),
      ``fairness_index`` (Jain over the contended window's tokens,
      >= 0.9), ``hostile_alert_tripped`` / ``compliant_clean`` (1/1),
      and ``token_identity`` vs the FIFO arm (scheduling reorders WHO
      runs next, never WHAT a greedy request decodes) with ``lost`` == 0
      across both arms.
    - **SIGKILL** — the same plan through a `procs`-worker FLEET
      (WorkerSpec(fair=True): each worker runs its own VTC + ledger)
      with a real SIGKILL `kill_at_s` into the replay and a supervised
      restart: ``sigkill.lost`` == 0, ``sigkill.token_identity`` == 1.0
      (failover salvage keeps greedy identity).

    `model` reuses a built decoder (max_len >= 96) for the in-process
    arms; the workers rebuild its weights from its widths and seed 0.
    Each in-process arm reports `decode_steps` and `kernel_launches`,
    the SIGKILL leg each live worker's own. The reference's per-arm JSONL
    (`telemetry_out`, judged offline by tools/check_qos.py) and the
    kill leg's merged fleet trace (`trace_out`) are ROADMAP A6d and
    raise naming it."""
    import threading

    from ddp_practice_tpu_torch.serve.engine import EngineConfig
    from ddp_practice_tpu_torch.serve.fairshare import (
        TenantLedger,
        VirtualTokenCounter,
        jains_index,
        tenant_name,
    )
    from ddp_practice_tpu_torch.serve.router import RouterConfig, make_router
    from ddp_practice_tpu_torch.serve.scheduler import MonotonicClock
    from ddp_practice_tpu_torch.serve.slo import SLOConfig, TenantSLORegistry
    from ddp_practice_tpu_torch.serve.supervisor import (
        SupervisorConfig,
        make_fleet_router,
    )
    from ddp_practice_tpu_torch.serve.workload import TenantSpec, WorkloadPlan
    from ddp_practice_tpu_torch.utils.metrics import MetricsRegistry

    if telemetry_out is not None:
        raise _a6d("qos_bench(telemetry_out=)")
    if trace_out is not None:
        raise _a6d("qos_bench(trace_out=)")
    # short windows so a ~2 s run can trip/resolve; the production
    # defaults (60/300 s) are for fleets, not benches
    slo_cfg = SLOConfig.from_json(slo) if slo is not None else SLOConfig(
        ttft_p99_s=0.5, fast_window_s=0.5, slow_window_s=1.0,
        min_events=5,
    )
    if workload is not None:
        plan = WorkloadPlan.from_json(workload)
    else:
        compliant_rps = rate_hz / (1.0 + hostile_share)
        plan = WorkloadPlan([
            TenantSpec(name="bulk", rate_rps=rate_hz - compliant_rps,
                       arrivals="bursty", burst_every_s=1.0,
                       burst_len_s=0.4, burst_mult=2.0,
                       # long prompts + full budgets: the flood has to
                       # OUTRUN the fleet or there is no contention to
                       # be fair about
                       prompt_len_mean=32.0, prompt_len_cap=64,
                       max_new_mean=16.0, max_new_cap=16,
                       hostile=True),
            TenantSpec(name="acme", rate_rps=compliant_rps,
                       sessions=2, turns_per_session=3,
                       session_prefix_len=8, prompt_len_mean=4.0,
                       prompt_len_cap=8, max_new_mean=8.0,
                       max_new_cap=12),
        ], duration_s=duration_s)
    if model is None:
        model = _build_model(
            vocab=vocab, max_len=128, hidden=hidden, depth=depth,
            heads=heads, mlp=mlp, model_name=model_name,
            precision=precision, device=device)
    trace = plan.build(vocab=model.vocab_size, seed=seed)
    hostile = set(plan.hostile_tenants())
    compliant = sorted(
        {tenant_name(t["tenant"]) for t in trace}
        - {tenant_name(h) for h in hostile})
    ecfg = EngineConfig(
        max_slots=max_slots, max_len=96, prompt_buckets=(16, 64),
        temperature=0.0, decode_burst=decode_burst, eos_id=None,
    )

    def _judge(slo_reg, rows):
        """The isolation verdict off the live registry's alert log."""
        tripped = {t for _, edge, _, t in slo_reg.alert_log
                   if edge == "trip"}
        return {
            "alerts": [
                {"t": t, "event": edge, "objective": obj, "tenant": tn}
                for t, edge, obj, tn in slo_reg.alert_log
            ],
            "hostile_alert_tripped": float(bool(
                tripped & {tenant_name(h) for h in hostile})),
            "compliant_clean": float(not (tripped & set(compliant))),
            # judged over the CONTENDED window (_tenant_rows_from): a
            # drain-to-idle run delivers everyone's totals in the end,
            # so whole-run token counts cannot show starvation
            "fairness_index": jains_index(
                [rows[t]["window_tokens"] for t in sorted(rows)]),
        }

    def run_arm(fair: bool) -> tuple:
        launches = _launches()
        registry = MetricsRegistry()
        clock = MonotonicClock()
        slo_reg = TenantSLORegistry(slo_cfg, clock=clock,
                                    registry=registry)
        vtc = VirtualTokenCounter() if fair else None
        ledger = TenantLedger(registry=registry, vtc=vtc)
        router = make_router(
            model, procs, ecfg, clock=clock, max_queue=len(trace),
            config=RouterConfig(fair=fair), registry=registry,
            slo=slo_reg, vtc=vtc, ledger=ledger,
        )
        router.warmup()
        warm = router.compile_stats()
        row = _replay_row(router, trace)
        rows = _tenant_rows_from(router.completions)
        row.update({
            "mode": f"{'fair' if fair else 'fifo'} x{procs}",
            "per_tenant": rows,
            "tenants": ledger.report(),
            "warm_compile_stats": warm,
            "compile_stats": router.compile_stats(),
            **_router_counts(router, launches),
            **_judge(slo_reg, rows),
        })
        tokens = {c.rid: list(c.tokens) for c in router.completions
                  if c.status in ("eos", "length")}
        return row, tokens

    fifo_row, fifo_tokens = run_arm(False)
    fair_row, fair_tokens = run_arm(True)
    matched = sum(1 for rid, toks in fifo_tokens.items()
                  if toks and fair_tokens.get(rid) == toks)
    comp = compliant[0] if compliant else None
    isolation = (
        fair_row["per_tenant"][comp]["ttft_s"]["p99"]
        / fifo_row["per_tenant"][comp]["ttft_s"]["p99"]
        if comp and fifo_row["per_tenant"].get(comp, {})
        .get("ttft_s", {}).get("p99") else None
    )
    report: dict = {
        "device": _device_name(model),
        "workload": json.loads(plan.to_json()),
        "slo": json.loads(slo_cfg.to_json()),
        "seed": seed,
        "hostile_tenants": sorted(hostile),
        "compliant_tenants": compliant,
        "fifo": fifo_row,
        "fair": fair_row,
        "isolation_ttft_p99_ratio": isolation,
        # the verdict against the acceptance bound, beside the raw ratio
        "isolation_ok": float(isolation is not None and isolation <= 0.7),
        "token_identity": (matched / len(fifo_tokens)
                           if fifo_tokens else 0.0),
        "lost": fifo_row["lost"] + fair_row["lost"],
        "fairness_index": fair_row["fairness_index"],
        "hostile_alert_tripped": fair_row["hostile_alert_tripped"],
        "compliant_clean": fair_row["compliant_clean"],
    }

    # ------------- SIGKILL leg: fair FLEET + real mid-run worker death
    # judged against the FAILURE budget, not the steady-state one: the
    # killed worker's flights ride out the restart whoever the
    # scheduler favours, so 5x the latency targets is the
    # single-worker-outage budget; the flooder's backlog sails past it
    chaos_cfg = dataclasses.replace(
        slo_cfg,
        ttft_p99_s=(None if slo_cfg.ttft_p99_s is None
                    else slo_cfg.ttft_p99_s * 5),
        tpot_p99_s=(None if slo_cfg.tpot_p99_s is None
                    else slo_cfg.tpot_p99_s * 5),
    )
    registry = MetricsRegistry()
    clock = MonotonicClock()
    slo_reg = TenantSLORegistry(chaos_cfg, clock=clock, registry=registry)
    ledger = TenantLedger(registry=registry)
    router_f, sup, handles = make_fleet_router(
        _worker_spec(
            model,
            {"max_slots": max_slots, "max_len": 96,
             "prompt_buckets": [16, 64], "temperature": 0.0,
             "decode_burst": decode_burst, "eos_id": None},
            max_queue=len(trace), fair=True,
        ),
        procs,
        clock=clock,
        sup_config=SupervisorConfig(restart_base_s=0.25),
        registry=registry, slo=slo_reg, ledger=ledger,
    )
    killer = threading.Timer(kill_at_s, sup.kill, (0, "SIGKILL"))
    try:
        killer.start()
        kill_row = _replay_row(router_f, trace, fleet=True)
        workers = _worker_counts(sup, handles)
    finally:
        killer.cancel()
        sup.stop()
    rows = _tenant_rows_from(router_f.completions)
    kill_tokens = {c.rid: list(c.tokens) for c in router_f.completions
                   if c.status in ("eos", "length")}
    kmatched = sum(1 for rid, toks in fifo_tokens.items()
                   if toks and kill_tokens.get(rid) == toks)
    kill_row.update({
        "mode": f"fair fleet x{procs} + SIGKILL",
        "kill_at_s": kill_at_s,
        "slo_chaos": json.loads(chaos_cfg.to_json()),
        "per_tenant": rows,
        "worker_restarts": list(sup.restarts),
        "workers": workers,
        "token_identity": (kmatched / len(fifo_tokens)
                           if fifo_tokens else 0.0),
        **_judge(slo_reg, rows),
    })
    report["sigkill"] = kill_row
    report["sigkill_lost"] = kill_row["lost"]
    return report


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(","))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "ddp_practice_tpu_torch serve",
        description="continuous-batching serving benches on the card: one "
                    "synthetic Poisson trace through the slot engine, the "
                    "static-batch baseline and (--paged) the paged "
                    "engine; or the shared-prefix or speculative-decoding "
                    "bench",
    )
    p.add_argument("--ckpt_dir", default=None,
                   help="serve these --prompt strings from a checkpoint "
                        "instead of running the bench (needs a "
                        "pos_emb=rope LM checkpoint)")
    p.add_argument("--prompt", action="append", default=None,
                   help="repeatable; byte-level prompt(s) to serve")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--trace-out", "--trace_out", dest="trace_out",
                   default=None, metavar="PATH",
                   help="write a Chrome trace-event JSON of the request "
                        "lifecycle (queued/prefill/decode-burst spans, "
                        "retry/failover instants; pid=replica, tid=slot): "
                        "the router run with --replicas, else the "
                        "continuous run, or the --ckpt_dir run; validate "
                        "with tools/check_traces.py")
    p.add_argument("--trace-sample", dest="trace_sample", type=float,
                   default=None, metavar="RATE",
                   help="head-sampling rate in [0,1] of the --trace_out "
                        "recorder: one keep/stage decision per trace_id "
                        "(crc32), staged spans kept by the tail rules "
                        "(errors, sheds, retries, failovers, "
                        "--trace-keep-slow-s); default 1.0")
    p.add_argument("--trace-keep-slow-s", dest="trace_keep_slow_s",
                   type=float, default=None, metavar="S",
                   help="tail keep-rule: a request slower than this end "
                        "to end is kept whatever the head decision")
    p.add_argument("--trace-tenant-rates", "--trace_tenant_rates",
                   dest="trace_tenant_rates", default=None, metavar="JSON",
                   help="per-tenant head-rate overrides as a JSON object")
    p.add_argument("--replicas", type=int, default=0,
                   help="also run the trace through N SlotEngine replicas "
                        "behind the fault-tolerant router on this device "
                        "(serve/router.py; 0 = skip)")
    p.add_argument("--fault-plan", dest="fault_plan", default=None,
                   metavar="JSON",
                   help="inject a serve/faults.py FaultPlan (a JSON string "
                        "or a path to a JSON file) into the router run, "
                        "whose row then reports goodput under those "
                        "faults (requires --replicas)")
    p.add_argument("--slo", default=None, metavar="JSON|PATH",
                   help="SLO config (serve/slo.py SLOConfig: ttft_p99_s/"
                        "tpot_p99_s/error_rate/availability + windows): "
                        "arms the burn-rate watchdog on the router run; "
                        "alerts land in the trace and can trip the "
                        "router's brown-out (requires --replicas)")
    p.add_argument("--alert-sink", "--alert_sink", dest="alert_sink",
                   action="append", default=None, metavar="KIND:TARGET",
                   help="repeatable; push SLO alert edges to a sink: "
                        "command:..., webhook:http://..., jsonl:path "
                        "(retry backoff, dead-sink breaker); needs --slo")
    p.add_argument("--procs", type=int, default=0,
                   help="run the trace through N worker OS PROCESSES "
                        "behind the RPC seam AND through N in-process "
                        "router replicas: the seam's latency and goodput "
                        "ratios (serve/worker.py + serve/supervisor.py; "
                        "--fault-plan kill specs deliver real "
                        "SIGKILL/SIGSTOP to live workers)")
    p.add_argument("--streaming", action="store_true",
                   help="with --procs: bench STREAMING token delivery "
                        "through the worker fleet: streaming against "
                        "end-of-request delivery, or with --fault-plan "
                        "kill specs the consumer's exactly-once ledger "
                        "under real kills")
    p.add_argument("--frontdoor", action="store_true",
                   help="bench the HTTP/SSE front door end to end "
                        "through real client sockets "
                        "(serve/frontdoor.py): wire-vs-in-process "
                        "goodput and greedy token identity, chunked-"
                        "prefill short-request TTFT p99 ratio, a "
                        "mid-stream worker SIGKILL with zero lost streams "
                        "(--procs workers, default 2), and mixed greedy+"
                        "sampled churn with zero new shapes")
    p.add_argument("--sse-out", dest="sse_out", default=None,
                   metavar="PATH",
                   help="with --frontdoor: dump the wire-side SSE frame "
                        "capture as JSONL; audit with "
                        "tools/check_stream.py --sse")
    p.add_argument("--qos", action="store_true",
                   help="the multi-tenant QoS lab (serve/workload.py): "
                        "one adversarial plan (hostile tenant at 4x the "
                        "compliant share) through FIFO and weighted-fair "
                        "arms plus a fair FLEET leg under a real SIGKILL "
                        "(--procs workers, default 2): the compliant "
                        "tenant's TTFT-p99 isolation ratio, Jain's "
                        "fairness index, per-tenant alert attribution, "
                        "greedy token identity and zero lost. "
                        "--workload/--slo override the plan and targets")
    p.add_argument("--workload", default=None, metavar="JSON|PATH",
                   help="with --qos: a serve/workload.py WorkloadPlan "
                        "(JSON literal or path) replacing the default "
                        "hostile+compliant plan")
    p.add_argument("--qos-duration", dest="qos_duration", type=float,
                   default=2.0,
                   help="with --qos: plan duration in seconds (arrival "
                        "window; the run drains past it)")
    p.add_argument("--cache-aware", dest="cache_aware",
                   action="store_true",
                   help="with --procs: A/B cache-aware (prefix-affinity) "
                        "routing against least-loaded over one "
                        "shared-prefix trace through two identical paged, "
                        "prefix-caching worker fleets at the same pool "
                        "(serve/affinity.py): the fleet prefix-hit-token "
                        "rate and goodput ratios, zero lost, greedy token "
                        "identity")
    p.add_argument("--autoscale", action="store_true",
                   help="with --procs: A/B an ELASTIC fleet against the "
                        "fixed --procs fleet under a 4x arrival step "
                        "(serve/autoscaler.py: SLO-burn/queue-pressure "
                        "policy, warm standby promotion, graceful drain "
                        "down): goodput per worker-second at equal SLO, "
                        "reaction within one evaluation window, zero "
                        "lost, no thrash")
    p.add_argument("--autoscale-max", dest="autoscale_max", type=int,
                   default=3,
                   help="with --autoscale: elastic fleet size ceiling "
                        "(floor is 1)")
    p.add_argument("--standby", type=int, default=1,
                   help="with --autoscale: warm standby workers kept "
                        "ready to promote (the pool replenishes in the "
                        "background after each promotion)")
    # the later slices' flags: accepted, and refused by ROADMAP item
    for flags, kw, _ in _LATER:
        p.add_argument(*flags, default=None, help=argparse.SUPPRESS, **kw)
    p.add_argument("--model", default="lm_tiny",
                   choices=("lm_tiny", "lm_base"),
                   help="registry model (weights from --seed); lm_tiny "
                        "uses the reference bench's widths")
    p.add_argument("--precision", default="fp32", choices=("fp32", "bf16"))
    p.add_argument("--kv-cache-dtype", dest="kv_cache_dtype", default=None,
                   choices=("bf16", "int8"),
                   help="KV-cache storage (default: the compute dtype)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--max_slots", type=int, default=None,
                   help="slots (default: each bench's own; 4 for the "
                        "serving bench)")
    p.add_argument("--decode_burst", type=int, default=None,
                   help="decode steps per dispatch (default 8; the "
                        "spec bench defaults to 1)")
    p.add_argument("--requests", type=int, default=32,
                   help="trace length")
    p.add_argument("--rate", type=float, default=None,
                   help="Poisson arrival rate in req/s (default 8; the "
                        "shared-prefix bench defaults to 1000)")
    p.add_argument("--vocab", type=int, default=None,
                   help="vocabulary (default 64 for lm_tiny, 256 for "
                        "lm_base)")
    p.add_argument("--max-len", dest="max_len", type=int, default=128,
                   help="slot-pool span per slot")
    p.add_argument("--prompt-buckets", dest="prompt_buckets", type=_ints,
                   default=(8, 16), help="comma-separated bucket widths")
    p.add_argument("--prompt-len-range", dest="prompt_len_range",
                   type=_ints, default=(2, 16))
    p.add_argument("--max-new-range", dest="max_new_range", type=_ints,
                   default=(2, 96))
    p.add_argument("--eos_id", type=int, default=None,
                   help="end-of-sequence id (default: none when serving "
                        "a checkpoint, 46 for the benches)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--paged", action="store_true",
                   help="also run the trace through the paged-KV engine "
                        "(a 'paged' row); compare it with 'continuous' at "
                        "large --max-len to see the span decoupling")
    p.add_argument("--block-size", dest="block_size", type=int, default=16,
                   help="paged engine: positions per KV block")
    p.add_argument("--shared-prefix", dest="shared_prefix",
                   action="store_true",
                   help="replay a K-system-prompts x continuations trace "
                        "through the plain paged engine AND the "
                        "prefix-sharing engine at the same undersized "
                        "pool: goodput ratio, hit/miss tokens, "
                        "preemptions")
    p.add_argument("--kv-int8", dest="kv_int8", action="store_true",
                   help="with --shared-prefix: an int8 pool with "
                        "per-block scale pages (halved KV bytes/token)")
    p.add_argument("--spec-decode", dest="spec_decode",
                   action="store_true",
                   help="replay one repeated-motif trace through the "
                        "plain paged engine AND the speculative-decoding "
                        "engine: tpot ratio, accept rate, token identity")
    p.add_argument("--spec-k", dest="spec_k", type=int, default=4,
                   help="with --spec-decode: drafted tokens per verify")
    p.add_argument("--json", action="store_true")
    return p


# the reference bench's flags that belong to later slices of the port:
# ((flags...), argparse keywords, ROADMAP item)
_LATER = (
    (("--metrics-port", "--metrics_port"), {"type": int}, "A6d"),
    (("--telemetry-out", "--telemetry_out"), {}, "A6d"),
    (("--scrape-hz",), {"type": float}, "A6d"),
    (("--otlp-out", "--otlp_out"), {}, "A6d"),
    (("--otlp-endpoint", "--otlp_endpoint"), {}, "A6d"),
    (("--otlp-push-overhead",), {"action": "store_true"}, "A6d"),
    (("--trace-overhead",), {"action": "store_true"}, "A6d"),
    (("--trace-sampling",), {"action": "store_true"}, "A6d"),
    (("--adaptive-sampling",), {"action": "store_true"}, "A6d"),
    (("--trace-budget-sps",), {"type": float}, "A6d"),
)


def _refuse_later_flags(args) -> None:
    """A flag of a later slice raises NotImplementedError naming its
    ROADMAP item, as the training config's unported fields do."""
    for flags, _, item in _LATER:
        given = getattr(args, flags[0].lstrip("-").replace("-", "_"))
        if given is not None and given is not False:   # 0 is a value
            raise NotImplementedError(
                f"{flags[0]} is not ported yet (ROADMAP {item})")


def _print_rows(rows) -> None:
    for r in rows:
        line = (f"  {r['mode']:>12}: {r['tokens_per_sec']:8.1f} tok/s  "
                f"ttft p50 {r['ttft_s']['p50'] * 1e3:7.1f} ms  "
                f"p99 {r['ttft_s']['p99'] * 1e3:7.1f} ms")
        if "tpot_s" in r:
            line += (f"  tpot p50 {r['tpot_s']['p50'] * 1e3:6.2f} ms  "
                     f"p99 {r['tpot_s']['p99'] * 1e3:6.2f} ms")
        if "preemptions" in r:
            line += (f"  preemptions {r['preemptions']}  kv "
                     f"{r['kv_bytes_per_token']:.0f} B/token")
        if "retries" in r:
            line += (f"  retries {r['retries']:.0f}  failovers "
                     f"{r['failovers']:.0f}  breaker trips "
                     f"{r['breaker_trips']:.0f}  statuses {r['statuses']}  "
                     f"replicas {r['replica_states']}")
        print(line)
        ph = r.get("phases")
        if ph:
            print("                phases p50/p99 ms:  " + "  ".join(
                f"{k[:-2]} {ph[k]['p50'] * 1e3:.1f}/{ph[k]['p99'] * 1e3:.1f}"
                for k in ("queue_s", "prefill_s", "decode_s", "stall_s")))


def serve_checkpoint(ckpt_dir, prompts, *, max_new_tokens=64,
                     temperature=0.0, top_k=0, top_p=0.0, eos_id=None,
                     max_slots=4, decode_burst=1, seed=0, device="cuda",
                     kv_cache="policy", tracer=None):
    """Serve `prompts` (strings) from the LM checkpoint under `ckpt_dir`
    through a SlotEngine with one prompt bucket (the smallest power of
    two >= 8 that holds the longest prompt) and the Scheduler; `tracer`
    (utils/trace.py TraceRecorder) records the run's timeline. Returns
    (completions sorted by request id, elapsed seconds, step)."""
    from ddp_practice_tpu_torch.generate import load_lm
    from ddp_practice_tpu_torch.inference import encode_bytes
    from ddp_practice_tpu_torch.serve.engine import EngineConfig, SlotEngine
    from ddp_practice_tpu_torch.serve.scheduler import Request, Scheduler

    model, step = load_lm(ckpt_dir, device=device, kv_cache=kv_cache)
    max_prompt = max(len(p.encode("utf-8")) for p in prompts)
    bucket = 8
    while bucket < max_prompt:
        bucket *= 2
    engine = SlotEngine(model, EngineConfig(
        max_slots=max_slots, prompt_buckets=(bucket,),
        temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
        decode_burst=decode_burst))
    if tracer is not None:
        from ddp_practice_tpu_torch.utils.trace import label_replica

        engine.set_tracer(tracer, 0)
        label_replica(tracer, 0, max_slots)
    sched = Scheduler(engine, max_queue=max(64, len(prompts)),
                      tracer=tracer)
    t0 = time.monotonic()
    for i, text in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=encode_bytes(text)[0].tolist(),
                             max_new_tokens=max_new_tokens, seed=seed))
    completions = sched.run_until_idle()
    elapsed = time.monotonic() - t0
    return sorted(completions, key=lambda c: c.rid), elapsed, step


def _serve_checkpoint(args) -> int:
    from ddp_practice_tpu_torch.generate import cut_at_eos
    from ddp_practice_tpu_torch.inference import decode_bytes

    tracer = _make_tracer(**_sampling(args)) if args.trace_out else None
    prompts = args.prompt or ["\n"]
    completions, elapsed, step = serve_checkpoint(
        args.ckpt_dir, prompts, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_id=args.eos_id, max_slots=args.max_slots or 4,
        decode_burst=args.decode_burst or 1, seed=args.seed,
        device=args.device, tracer=tracer)
    for c in completions:
        ttft = "" if c.ttft is None else f" ttft {c.ttft:.3f}s"
        print(f"--- request {c.rid} [{c.status}]{ttft} ---")
        toks = cut_at_eos(c.tokens, args.eos_id)
        print(prompts[c.rid] + decode_bytes(torch.tensor(toks,
                                                         dtype=torch.int64)))
    tokens = sum(len(c.tokens) for c in completions)
    print(f"[serve] ckpt step {step}: {len(completions)} requests, {tokens} "
          f"tokens in {elapsed:.2f}s ({tokens / max(elapsed, 1e-9):.1f} "
          f"tok/s)")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"wrote trace to {args.trace_out} ({len(tracer)} events)")
    return 0


def _sampling(args) -> dict:
    """The recorder's sampling knobs from the command line."""
    return {"sample": 1.0 if args.trace_sample is None
            else args.trace_sample,
            "keep_slow_s": args.trace_keep_slow_s,
            "tenant_rates": (json.loads(args.trace_tenant_rates)
                             if args.trace_tenant_rates else None)}


def _frontdoor_main(args, door: dict, opt: dict) -> int:
    report = frontdoor_bench(n_requests=args.requests,
                             procs=args.procs or 2, sse_out=args.sse_out,
                             **door, **opt)
    if args.json:
        print(json.dumps(report))
        return 0
    ip, w = report["in_process"], report["wire"]
    print(f"[frontdoor_bench] {report['trace']['n_requests']} requests @ "
          f"{report['trace']['rate_hz']}/s through real sockets, "
          f"{args.model} {args.precision} on {report['device']}")
    for r in (ip, w):
        print(f"  {r['mode']:>24}: {r['goodput_tokens_per_sec']:8.1f} "
              f"tok/s  ttft p50 {r['ttft_s']['p50'] * 1e3:7.1f} ms  "
              f"lost {r['lost']}")
    cs = report["check_stream"]
    print(f"  wire/in-process goodput {report['goodput_ratio']:.3f}x  "
          f"token identity {report['token_identity']:.2f}  --sse audit "
          f"ok={cs.get('ok')} ({cs.get('streams', 0)} streams, "
          f"{cs.get('violations', 0)} violations)")
    cp = report["chunked_prefill"]
    print(f"  chunked prefill: short-TTFT p99 "
          f"{cp['chunked']['ttft_short_s']['p99'] * 1e3:.0f} ms vs "
          f"{cp['unchunked']['ttft_short_s']['p99'] * 1e3:.0f} ms "
          f"unchunked, ratio {report['ttft_p99_ratio_chunked']:.3f}x  "
          f"identity {cp['token_identity']:.2f}")
    sk = report["sigkill"]
    print(f"  SIGKILL @ {sk['kill_at_s']}s: lost {report['sigkill_lost']}  "
          f"resumed markers {sk['resumed_markers']}  restarts "
          f"{sk['worker_restarts']}  audit "
          f"ok={sk['check_stream'].get('ok')}")
    sm = report["sampling"]
    print(f"  sampling churn: new shapes {report['sampling_new_compiles']}"
          f"  statuses {sm['statuses']}  audit "
          f"ok={sm['check_stream'].get('ok')}")
    if "sse_out" in report:
        print(f"  wrote SSE capture to {report['sse_out']}: audit with "
              f"tools/check_stream.py --sse")
    return 0


def _qos_main(args, door: dict, opt: dict) -> int:
    opt = {k: v for k, v in opt.items() if k != "rate_hz"}
    report = qos_bench(rate_hz=args.rate or 100.0,
                       duration_s=args.qos_duration,
                       procs=args.procs or 2, slo=args.slo,
                       workload=args.workload, **door, **opt)
    if args.json:
        print(json.dumps(report))
        return 0
    print(f"[qos_bench] {len(report['workload']['tenants'])} tenants @ "
          f"{args.rate or 100.0}/s for {report['workload']['duration_s']}"
          f"s, hostile {report['hostile_tenants']} vs compliant "
          f"{report['compliant_tenants']}, on {report['device']}")
    for tag in ("fifo", "fair"):
        r = report[tag]
        for t, row in r["per_tenant"].items():
            print(f"  {r['mode']:>10} {t:>8}: ttft p99 "
                  f"{row['ttft_s'].get('p99', 0) * 1e3:7.1f} ms  "
                  f"{row['output_tokens']:5d} tok  "
                  f"({row['ok']}/{row['completions']} ok)")
        print(f"  {r['mode']:>10} fairness {r['fairness_index']:.4f}  "
              f"trips {sum(a['event'] == 'trip' for a in r['alerts'])}  "
              f"lost {r['lost']}")
    iso = report["isolation_ttft_p99_ratio"]
    print(f"  isolation ttft p99 fair/fifo "
          f"{'n/a' if iso is None else f'{iso:.3f}x'}  token identity "
          f"{report['token_identity']:.2f}  hostile tripped "
          f"{report['hostile_alert_tripped']:.0f}  compliant clean "
          f"{report['compliant_clean']:.0f}")
    sk = report["sigkill"]
    print(f"  SIGKILL @ {sk['kill_at_s']}s: lost {sk['lost']}  identity "
          f"{sk['token_identity']:.2f}  fairness "
          f"{sk['fairness_index']:.4f}  restarts {sk['worker_restarts']}")
    return 0


def _streaming_main(args, fleet_kw: dict) -> int:
    report = streaming_bench(**fleet_kw)
    if args.json:
        print(json.dumps(report))
    elif "fleet" in report:  # chaos arm
        fl, st = report["fleet"], report["streams"]
        print(f"[streaming_bench chaos] {args.requests} requests, "
              f"{args.procs} workers, kills {fl['kills_fired']}")
        print(f"  consumer ledger: dupes {report['chunk_dupes']}  gaps "
              f"{report['chunk_gaps']}  lost {report['lost']}  "
              f"unterminated {report['unterminated']}  resumed markers "
              f"{st['resumed_markers']}  suppressed "
              f"{st['suppressed_tokens']} tok")
        print(f"  inter-token p99 {report['inter_token_p99_s'] * 1e3:.2f} "
              f"ms  resume gap p99 {report['resume_gap_p99_s'] * 1e3:.1f} "
              f"ms")
        cs = report.get("check_stream", {})
        print(f"  check_stream audit: ok={cs.get('ok')} over "
              f"{cs.get('streams', 0)} stream(s), "
              f"{cs.get('violations', 0)} violation(s)")
    else:
        print(f"[streaming_bench] {args.requests} requests, {args.procs} "
              f"workers, {report['reps']} order-balanced reps")
        print(f"  streaming vs end-of-request: latency mean "
              f"{report['latency_ratio_mean']:.3f}x  p50 "
              f"{report['latency_ratio_p50']:.3f}x  goodput "
              f"{report['goodput_ratio']:.3f}x  ({report['gate']})")
        print(f"  exactly-once cross-check violations: "
              f"{report['stream_violations']}")
    return 0


def _fleet_main(args, fleet_kw: dict) -> int:
    report = fleet_bench(**fleet_kw)
    if args.json:
        print(json.dumps(report))
        return 0
    ip, fl = report["in_process"], report["fleet"]
    kills = " under real kills" if args.fault_plan else ""
    print(f"[fleet_bench] {args.requests} requests @ "
          f"{report['trace']['rate_hz']}/s, {args.procs} workers{kills}, "
          f"{args.model} {args.precision} on {report['device']}")
    for r in (ip, fl):
        print(f"  {r['mode']:>12}: {r['goodput_tokens_per_sec']:8.1f} "
              f"tok/s  ttft p50 {r['ttft_s']['p50'] * 1e3:7.1f} ms  "
              f"latency p50 {r['latency_s']['p50'] * 1e3:7.1f}/p99 "
              f"{r['latency_s']['p99'] * 1e3:.1f} ms")
    print(f"  latency ratio p50 {report['latency_ratio_p50']:.3f}x  p99 "
          f"{report['latency_ratio_p99']:.3f}x  goodput "
          f"{report['goodput_ratio']:.3f}x  tpot "
          f"{report['tpot_ratio_p50']:.3f}x  ttft "
          f"{report['ttft_ratio_p50']:.3f}x")
    print(f"  fleet: statuses {fl['statuses']}  lost {fl['lost']}  "
          f"failovers {fl['failovers']:.0f}  restarts "
          f"{fl['worker_restarts']}"
          + (f"  kills {fl['kills_fired']}" if "kills_fired" in fl else ""))
    return 0


def _autoscale_main(args, widths: dict, opt: dict) -> int:
    report = fleet_autoscale_bench(
        procs=args.procs, autoscale_max=args.autoscale_max,
        standby=args.standby,
        **{k: v for k, v in widths.items() if k != "block_size"}, **opt)
    if args.json:
        print(json.dumps(report))
        return 0
    au, fx = report["autoscaled"], report["fixed"]
    sc = report["autoscale"]
    print(f"[fleet_autoscale] {report['rate_hz']}/s -> "
          f"{report['step_rate_hz']}/s step; fixed "
          f"{report['procs_fixed']} workers vs elastic {sc['min']}.."
          f"{sc['max']} (+{sc['standby']} standby), {args.model} "
          f"{args.precision}")
    for r in (fx, au):
        print(f"  {r['mode']:>10}: {r['goodput_per_worker']:7.1f} "
              f"tok/s/worker  ({r['useful_tokens']} tok over "
              f"{r['worker_seconds']:.1f} worker-s)  lost {r['lost']}")
    rs, pj = report["reaction_s"], report["promote_join_s"]
    print(f"  goodput/worker ratio "
          f"{report['goodput_per_worker_ratio']:.2f}x  "
          + (f"reaction {rs:.2f}s (window "
             f"{report['reaction_window_s']:.2f}s, within="
             f"{report['reaction_within_window']:.0f})"
             if rs is not None
             else "no scale-up observed after the step"))
    print("  warm promotion " + (f"{pj:.3f}s" if pj is not None else "n/a")
          + f" vs cold spawn {report['cold_spawn_s']:.1f}s  direction "
          f"changes {au['direction_changes']} (bound "
          f"{au['oscillation_bound']}, ok={report['oscillation_ok']:.0f})")
    return 0


def _cache_routing_main(args, widths: dict, opt: dict) -> int:
    report = cache_routing_bench(n_requests=args.requests,
                                 procs=args.procs, **widths, **opt)
    if args.json:
        print(json.dumps(report))
        return 0
    aff, ll = report["affinity"], report["least_loaded"]
    print(f"[cache_routing_bench] {report['trace']['n_requests']} requests"
          f" @ {report['trace']['rate_hz']}/s, {report['procs']} workers, "
          f"{report['trace']['k_prefixes']} prefix families x "
          f"{report['trace']['prefix_len']} tokens, pool "
          f"{report['pool']['num_blocks']} x {report['pool']['block_size']}"
          f", {args.model} {args.precision}")
    for r in (ll, aff):
        print(f"  {r['mode']:>16}: {r['goodput_tokens_per_sec']:8.1f} "
              f"tok/s  hit rate {r['hit_rate']:.3f}  ({r['hit_tokens']}/"
              f"{r['hit_tokens'] + r['miss_tokens']} prefill tokens warm)"
              f"  lost {r['lost']}")
    print(f"  affinity/least-loaded: hit rate "
          f"{report['hit_rate_ratio']:.2f}x  goodput "
          f"{report['goodput_ratio']:.2f}x  token identity "
          f"{report['token_identity']:.2f}  routes "
          f"{aff['route_decisions']}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_later_flags(args)
    if args.ckpt_dir:
        return _serve_checkpoint(args)
    if args.alert_sink and not args.slo:
        raise SystemExit("--alert-sink needs --slo (the sinks carry the "
                         "watchdog's trip/resolve edges)")
    if args.fault_plan and not (args.replicas or args.procs):
        raise SystemExit("--fault-plan needs --replicas N (faults are "
                         "injected into the router fleet run) or --procs "
                         "N (kill specs signal the worker processes)")
    if args.slo and not (args.replicas or args.qos):
        raise SystemExit("--slo needs --replicas N (the watchdog feeds "
                         "the router's brown-out hook) or --qos")
    if args.streaming and not args.procs:
        raise SystemExit("--streaming needs --procs N (chunks ride the "
                         "worker push stream; the in-process router "
                         "streams by default already)")
    if (args.cache_aware or args.autoscale) and not args.procs:
        raise SystemExit("--cache-aware and --autoscale need --procs N "
                         "(both A/B worker fleets)")
    if args.eos_id is None:
        args.eos_id = 46
    if args.kv_int8 and not args.shared_prefix:
        raise SystemExit("--kv-int8 rides the --shared-prefix bench")
    base = args.model == "lm_base"
    widths = dict(vocab=args.vocab or (256 if base else 64),
                  hidden=None if base else 128, depth=None if base else 2,
                  heads=None if base else 4, mlp=None if base else 256,
                  model_name=args.model, precision=args.precision,
                  device=args.device, seed=args.seed,
                  block_size=args.block_size)
    opt = {k: v for k, v in (("max_slots", args.max_slots),
                             ("decode_burst", args.decode_burst),
                             ("rate_hz", args.rate)) if v is not None}
    if args.shared_prefix:
        opt.pop("decode_burst", None)
        report = shared_prefix_bench(n_requests=args.requests,
                                     kv_int8=args.kv_int8, **widths, **opt)
        if args.json:
            print(json.dumps(report))
            return 0
        pf = report["paged_prefix"]
        pc = pf["prefix_cache"]
        print(f"[shared_prefix_bench] {args.requests} requests, pool "
              f"{report['pool']['num_blocks']} blocks x "
              f"{report['pool']['block_size']} "
              f"({report['pool']['kv_cache_dtype']}), {args.model} "
              f"{args.precision} on {report['device']}")
        _print_rows((report["paged"], pf))
        print(f"  prefix/paged goodput: {report['prefix_vs_paged']:.2f}x  "
              f"hit/miss tokens {pc['hit_tokens']}/{pc['miss_tokens']} "
              f"(hit rate {pc['hit_rate']:.2f})")
        if args.kv_int8:
            print(f"  kv bytes/token: int8 {pf['kv_bytes_per_token']:.0f} "
                  f"vs f32 {report['kv_bytes_per_token_f32']:.0f} "
                  f"({report['kv_bytes_ratio']:.2f}x)")
        return 0
    if args.spec_decode:
        report = spec_decode_bench(n_requests=args.requests,
                                   spec_k=args.spec_k, **widths, **opt)
        if args.json:
            print(json.dumps(report))
            return 0
        print(f"[spec_decode_bench] {args.requests} requests, spec_k "
              f"{report['spec_k']}, {args.model} {args.precision} on "
              f"{report['device']}")
        _print_rows((report["paged"], report["paged_spec"]))
        print(f"  spec/paged tpot: {report['tpot_ratio']:.2f}x  latency "
              f"p50: {report['latency_ratio_p50']:.2f}x  accept rate "
              f"{report['accept_rate']:.2f}  token identity "
              f"{report['token_identity']:.2f}")
        return 0
    if args.frontdoor or args.qos:
        # lm_tiny keeps each bench's own (the reference's) widths
        door = dict(model_name=args.model, precision=args.precision,
                    device=args.device, seed=args.seed)
        if base:
            door.update(vocab=widths["vocab"], hidden=None, depth=None,
                        heads=None, mlp=None)
        if args.frontdoor:
            return _frontdoor_main(args, door, opt)
        return _qos_main(args, door, opt)
    if args.procs and args.autoscale:
        return _autoscale_main(args, widths, opt)
    if args.procs and args.cache_aware:
        return _cache_routing_main(args, widths, opt)
    if args.procs:
        fleet_kw = dict(
            n_requests=args.requests, procs=args.procs,
            max_len=args.max_len, prompt_buckets=args.prompt_buckets,
            prompt_len_range=args.prompt_len_range,
            max_new_range=args.max_new_range, eos_id=args.eos_id,
            **{k: v for k, v in widths.items() if k != "block_size"},
            **opt)
        if args.fault_plan:
            from ddp_practice_tpu_torch.serve.faults import FaultPlan

            fleet_kw["fault_plan"] = FaultPlan.from_json(args.fault_plan)
        if args.streaming:
            return _streaming_main(args, fleet_kw)
        return _fleet_main(args, fleet_kw)
    kv = {"bf16": torch.bfloat16, "int8": "int8", None: None}
    fleet = {}
    if args.replicas:
        from ddp_practice_tpu_torch.serve.faults import FaultPlan

        fleet = dict(replicas=args.replicas, slo=args.slo,
                     alert_sinks=args.alert_sink,
                     fault_plan=(FaultPlan.from_json(args.fault_plan)
                                 if args.fault_plan else None))
    sampling = _sampling(args)
    report = serve_bench(
        n_requests=args.requests, max_len=args.max_len,
        prompt_buckets=args.prompt_buckets,
        prompt_len_range=args.prompt_len_range,
        max_new_range=args.max_new_range, eos_id=args.eos_id,
        kv_cache_dtype=kv[args.kv_cache_dtype], paged=args.paged,
        trace_out=args.trace_out, trace_sample=sampling["sample"],
        trace_keep_slow_s=sampling["keep_slow_s"],
        trace_tenant_rates=sampling["tenant_rates"],
        **{"max_slots": 4, **widths, **opt, **fleet},
    )
    if args.json:
        print(json.dumps(report))
        return 0
    print(f"[serve_bench] {args.requests} requests @ "
          f"{report['trace']['rate_hz']}/s, {args.model} {args.precision} "
          f"on {report['device']}")
    rows = [report["continuous"], report["static"]]
    if args.paged:
        rows.append(report["paged"])
    if "router" in report:
        rows.append(report["router"])
    _print_rows(rows)
    print(f"  continuous/static throughput: "
          f"{report['throughput_ratio']:.2f}x")
    if args.paged:
        print(f"  paged/static: {report['paged_vs_static']:.2f}x  "
              f"paged/continuous: {report['paged_vs_continuous']:.2f}x")
    if "router" in report:
        faults = " under injected faults" if args.fault_plan else ""
        print(f"  router{faults}: goodput "
              f"{report['router']['goodput_tokens_per_sec']:.1f} tok/s, "
              f"router/continuous throughput "
              f"{report['router_vs_continuous']:.2f}x")
        slo_rep = report["router"].get("slo")
        if slo_rep:
            trips = sum(a["event"] == "trip" for a in slo_rep["alerts"])
            print(f"  slo: {trips} alert trip(s), active at end: "
                  f"{[k for k, v in slo_rep['active'].items() if v]}")
    if "trace_out" in report:
        print(f"  wrote trace to {report['trace_out']} "
              f"({report['trace_events']} events): validate with "
              f"tools/check_traces.py")
    return 0


if __name__ == "__main__":
    sys.exit(main())
