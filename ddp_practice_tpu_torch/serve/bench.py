"""serve_bench: throughput-latency of continuous vs static batching
(counterpart of ddp_practice_tpu/serve/bench.py, slot-engine rows).

- One synthetic Poisson trace (seeded NumPy), two servers.
- Continuous: SlotEngine + Scheduler on the monotonic clock; requests
  join the running decode batch at slot granularity and release at their
  own length.
- Static baseline: the one-shot generator (inference.make_generate_fn) at
  batch = max_slots, every prompt padded to the largest bucket and every
  request run to the trace's largest token budget; arrivals wait for the
  whole batch.
- Both servers are scored on the tokens each request asked for.

Timed windows close with a host readback of tokens, which waits for the
device. Warmup runs before the trace clock starts for both servers. Each
row reports `decode_steps`, the single-token model applications it ran
(warmup included), so a caller can hold kernel launch counts against
depth x steps.

Not ported in this slice: the paged, router, fleet, tracing and
telemetry rows, and checkpoint serving (`--ckpt_dir`).
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


def _run_continuous(model, trace, *, max_slots, prompt_buckets, max_len,
                    decode_burst, eos_id,
                    collect_tokens: bool = False) -> dict:
    from ddp_practice_tpu_torch.serve.engine import (
        EngineConfig,
        SlotEngine,
        warm_engine,
    )
    from ddp_practice_tpu_torch.serve.scheduler import Request, Scheduler

    engine = SlotEngine(
        model,
        EngineConfig(
            max_slots=max_slots, max_len=max_len,
            prompt_buckets=prompt_buckets, temperature=0.0,
            decode_burst=decode_burst, eos_id=eos_id,
        ),
    )
    sched = Scheduler(engine, max_queue=len(trace))
    # warmup outside the timed window: one admit per bucket in play + one
    # decode dispatch, then rewind
    warm_engine(engine,
                sorted({engine.bucket_for(len(t["prompt"])) for t in trace}))

    t0 = time.monotonic()
    i = 0
    while not (i >= len(trace) and sched.idle):
        now = time.monotonic() - t0
        while i < len(trace) and trace[i]["arrival"] <= now:
            t = trace[i]
            # stamp the TRUE trace arrival: a request polled one dispatch
            # late still counts that wait in its TTFT
            sched.submit(Request(
                rid=t["rid"], prompt=t["prompt"],
                max_new_tokens=t["max_new_tokens"],
                arrival=t0 + t["arrival"],
            ))
            i += 1
        if sched.idle:
            time.sleep(max(0.0, trace[i]["arrival"] - now))
            continue
        sched.step()
    elapsed = time.monotonic() - t0

    tokens = sum(len(c.tokens) for c in sched.completions)
    lat = [c.finish - c.arrival for c in sched.completions]
    extra = {}
    if collect_tokens:
        extra["tokens_by_rid"] = {
            c.rid: list(c.tokens) for c in sched.completions
        }
    return {
        "mode": "continuous",
        **extra,
        "max_servable_context": max_len,
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
    }


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
) -> dict:
    """Replay one Poisson trace through both servers; return the report.
    `model` reuses an already built decoder (its vocab and max_len must
    cover the trace); otherwise one is built from the arguments."""
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
    cont = _run_continuous(
        model, trace, max_slots=max_slots,
        prompt_buckets=tuple(prompt_buckets), max_len=max_len,
        decode_burst=decode_burst, eos_id=eos_id,
        collect_tokens=collect_tokens,
    )
    static = _run_static(
        model, trace, max_slots=max_slots, width=max(prompt_buckets),
        max_new=max(max_new_range), eos_id=eos_id,
    )
    dev = model.tok_embed.weight.device
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "trace": {
            "n_requests": n_requests, "rate_hz": rate_hz, "seed": seed,
            "prompt_len_range": list(prompt_len_range),
            "max_new_range": list(max_new_range),
        },
        "max_len": max_len,
        "continuous": cont,
        "static": static,
        "throughput_ratio": (
            cont["tokens_per_sec"] / static["tokens_per_sec"]
            if static["tokens_per_sec"] else float("inf")
        ),
    }


# --------------------------------------------------------------------- CLI
def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(","))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "ddp_practice_tpu_torch serve",
        description="continuous-batching serving bench on the card: one "
                    "synthetic Poisson trace through the slot engine and "
                    "the static-batch baseline",
    )
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
    p.add_argument("--max_slots", type=int, default=4)
    p.add_argument("--decode_burst", type=int, default=8,
                   help="decode steps per dispatch")
    p.add_argument("--requests", type=int, default=32,
                   help="trace length")
    p.add_argument("--rate", type=float, default=8.0,
                   help="Poisson arrival rate (req/s)")
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
    p.add_argument("--eos_id", type=int, default=46)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    base = args.model == "lm_base"
    kv = {"bf16": torch.bfloat16, "int8": "int8", None: None}
    report = serve_bench(
        n_requests=args.requests, rate_hz=args.rate,
        max_slots=args.max_slots, seed=args.seed,
        vocab=args.vocab or (256 if base else 64),
        hidden=None if base else 128, depth=None if base else 2,
        heads=None if base else 4, mlp=None if base else 256,
        max_len=args.max_len, prompt_buckets=args.prompt_buckets,
        prompt_len_range=args.prompt_len_range,
        max_new_range=args.max_new_range, decode_burst=args.decode_burst,
        eos_id=args.eos_id, model_name=args.model,
        precision=args.precision, kv_cache_dtype=kv[args.kv_cache_dtype],
        device=args.device,
    )
    if args.json:
        print(json.dumps(report))
        return 0
    print(f"[serve_bench] {args.requests} requests @ {args.rate}/s, "
          f"{args.max_slots} slots, {args.model} {args.precision} on "
          f"{report['device']}")
    for r in (report["continuous"], report["static"]):
        print(
            f"  {r['mode']:>10}: {r['tokens_per_sec']:8.1f} tok/s  "
            f"ttft p50 {r['ttft_s']['p50'] * 1e3:7.1f} ms  "
            f"p99 {r['ttft_s']['p99'] * 1e3:7.1f} ms  "
            f"latency p50 {r['latency_s']['p50'] * 1e3:7.1f} ms"
        )
        ph = r.get("phases")
        if ph:
            print("              phases p50/p99 ms:  " + "  ".join(
                f"{k[:-2]} {ph[k]['p50'] * 1e3:.1f}/{ph[k]['p99'] * 1e3:.1f}"
                for k in ("queue_s", "prefill_s", "decode_s", "stall_s")))
    print(f"  continuous/static throughput: "
          f"{report['throughput_ratio']:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
