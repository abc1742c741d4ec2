"""Serving benches on the card (counterpart of
ddp_practice_tpu/serve/bench.py: serve_bench with its continuous, static,
paged and router rows, shared_prefix_bench and spec_decode_bench).

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

Not ported in this slice, and refused by name: the front door and QoS
(ROADMAP A6b), the worker fleet (A6c) and the telemetry plane (A6d).
"""

from __future__ import annotations

import argparse
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


def _replay(server, trace, request_cls) -> float:
    """Submit each request of `trace` at its arrival on the monotonic
    clock and step `server` (a Scheduler or a Router) until it drains;
    returns the elapsed seconds."""
    t0 = time.monotonic()
    i = 0
    while not (i >= len(trace) and server.idle):
        now = time.monotonic() - t0
        while i < len(trace) and trace[i]["arrival"] <= now:
            t = trace[i]
            # stamp the TRUE trace arrival: a request polled one dispatch
            # late still counts that wait in its TTFT
            server.submit(request_cls(
                rid=t["rid"], prompt=t["prompt"],
                max_new_tokens=t["max_new_tokens"],
                arrival=t0 + t["arrival"],
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
    return time.monotonic() - t0


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
    from ddp_practice_tpu_torch.serve.scheduler import Request, Scheduler

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

    elapsed = _replay(sched, trace, Request)

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
    from ddp_practice_tpu_torch.serve.scheduler import MonotonicClock, Request

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
    elapsed = _replay(router, trace, Request)

    ok = [c for c in router.completions if c.status in ("eos", "length")]
    ok_tokens = sum(len(c.tokens) for c in ok)
    m = router.metrics
    out = {
        "mode": f"router x{replicas}",
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
        "completions": len(router.completions),
        "statuses": dict(Counter(c.status for c in router.completions)),
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
    (("--frontdoor",), {"action": "store_true"}, "A6b"),
    (("--sse-out",), {}, "A6b"),
    (("--qos",), {"action": "store_true"}, "A6b"),
    (("--qos-duration",), {"type": float}, "A6b"),
    (("--workload",), {}, "A6b"),
    (("--procs",), {"type": int}, "A6c"),
    (("--streaming",), {"action": "store_true"}, "A6c"),
    (("--cache-aware",), {"action": "store_true"}, "A6c"),
    (("--autoscale",), {"action": "store_true"}, "A6c"),
    (("--autoscale-max",), {"type": int}, "A6c"),
    (("--standby",), {"type": int}, "A6c"),
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_later_flags(args)
    if args.ckpt_dir:
        return _serve_checkpoint(args)
    if args.alert_sink and not args.slo:
        raise SystemExit("--alert-sink needs --slo (the sinks carry the "
                         "watchdog's trip/resolve edges)")
    if args.fault_plan and not args.replicas:
        raise SystemExit("--fault-plan needs --replicas N (faults are "
                         "injected into the router fleet run)")
    if args.slo and not args.replicas:
        raise SystemExit("--slo needs --replicas N (the watchdog feeds "
                         "the router's brown-out hook)")
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
