#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ddp_practice_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and passed):

1. setup: print the card's name and power limit (nvidia-smi) and build
   the CUDA kernels from csrc/ with nvcc;
2. kernels: hold each kernel against its plain PyTorch version at lm_base
   shapes (h=12, hd=64, b in {1, 8}, L in {1024, 2048}, cur in {0, mid,
   L-1}, random attn_start, plus the serve path's own shape) and print its
   device time (CUDA events around one call queued behind a spin kernel,
   L2 flushed before each, median of 20), the plain version's time,
   F.scaled_dot_product_attention's time on the same masked problem (a
   yardstick only; the port never calls it) and the HBM-bytes bound;
3. serve: lm_base under the bf16 policy from a seeded random init
   (d=768, depth 12, 12 heads, mlp 3072, vocab 256) serves a Poisson
   trace through serve_bench's continuous and static rows; every request
   completes, and kernel A's launches equal depth x decode steps. A
   shorter int8-cache run does the same for kernel B;
4. cross-check: the fp32 engine with the kernel and with the plain
   version, on one deterministic schedule, emits identical greedy tokens;
5. profile: where one decode step of the serve configuration spends its
   time (torch.profiler over two bursts with every slot busy): host
   wall per step, device busy time per step and the device's idle share,
   device ops per step, and the attention kernel's share.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.

Tolerances: fp32 2e-5 (the reference's decode-attention tests). bf16
|err| <= 1.6e-2 + 2^-7 |ref|: the kernel and its plain version round at
the same points (q*scale, p, the output) and differ only in fp32
summation order, which can flip the final bf16 rounding of an output, or
of one p, by an ulp (2^-7 relative, 7.8e-3 absolute below 1).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

H, HD = 12, 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
TIMED_RUNS = 20
SPIN_CYCLES = 4_000_000            # ~2 ms at the H100's 1.98 GHz boost
FP32_TOL = (2e-5, 2e-5)            # (atol, rtol)
BF16_TOL = (1.6e-2, 2.0 ** -7)
SOURCE = "ddp_practice_tpu_torch/csrc/decode_attention.cu"
REPLACES = {
    "decode_attention": "ddp_practice_tpu/ops/decode_attention.py:199",
    "decode_attention_int8": "ddp_practice_tpu/ops/decode_attention.py:279",
}
# the serve phase: lm_base under the bf16 policy
SERVE = dict(max_slots=8, max_len=2048, prompt_buckets=(16, 64, 256),
             decode_burst=8, prompt_len_range=(4, 200),
             max_new_range=(8, 64), eos_id=None)


def log(*args) -> None:
    print(*args, flush=True)


# ------------------------------------------------------------------ kernels
def _inputs(torch, b, L, cur, dtype, quant, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((b, 1, H * HD), generator=g, device=dev).to(dtype)
    starts = torch.randint(0, cur + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    if quant:
        kc = torch.randint(-127, 128, (b, L, H * HD), generator=g,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (b, L, H * HD), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((b, H, L), generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand((b, H, L), generator=g, device=dev) * 0.02 + 1e-3
        return q, kc, vc, starts, ks, vs
    kc = torch.randn((b, L, H * HD), generator=g, device=dev).to(dtype)
    vc = torch.randn((b, L, H * HD), generator=g, device=dev).to(dtype)
    return q, kc, vc, starts, None, None


def _bound_ms(q, kc, starts, cur, quant) -> float:
    """HBM bytes the step must move (q and the output once, each valid K
    and V row once, the valid scale entries, attn_start) over 3.35 TB/s.
    The arithmetic, ~4 flop per cache element, is far under the card's
    flop-per-byte ridge, so bytes bound it."""
    rows = int((cur + 1 - starts.clamp(max=cur + 1)).sum())
    b = q.shape[0]
    nbytes = 2 * q.numel() * q.element_size()
    nbytes += 2 * rows * H * HD * kc.element_size()
    nbytes += b * 4
    if quant:
        nbytes += 2 * rows * H * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def _time_ms(torch, fn, flush, runs=TIMED_RUNS) -> float:
    """Device time of one call of `fn`, median of `runs`. Each call starts
    with a cold L2 and queued behind a ~2 ms spin kernel, so the host has
    enqueued the whole call before the start event fires: the events
    bracket device work, not Python dispatch."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        flush.zero_()   # 64 MB > the 50 MB L2: every launch starts cold
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def check_kernel(torch, F, ops, *, b, L, cur, dtype, quant, flush, seed):
    q, kc, vc, starts, ks, vs = _inputs(torch, b, L, cur, dtype, quant,
                                        seed)
    kw = dict(n_heads=H, k_scale=ks, v_scale=vs)
    got = ops.decode_attention_packed(q, kc, vc, cur, starts,
                                      impl="kernel", **kw)
    want = ops.decode_attention_plain(q, kc, vc, cur, starts, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite kernel output b={b} L={L}")
    err = (got.float() - want.float()).abs()
    atol, rtol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    bad = err > atol + rtol * want.float().abs()
    name = "decode_attention_int8" if quant else "decode_attention"
    if bad.any():
        raise AssertionError(
            f"{name} disagrees with its plain version: b={b} L={L} "
            f"cur={cur} {dtype}: max |err| {float(err.max()):.3e}"
        )
    # the yardstick: SDPA on the same masked problem (int8: on the cache
    # dequantized outside the timed call)
    kd, vd = kc, vc
    if quant:
        kd = (kc.view(b, L, H, HD).float()
              * ks.transpose(1, 2)[..., None]).to(dtype)
        vd = (vc.view(b, L, H, HD).float()
              * vs.transpose(1, 2)[..., None]).to(dtype)
    q4 = q.view(b, 1, H, HD).transpose(1, 2)
    k4 = kd.reshape(b, L, H, HD).transpose(1, 2)
    v4 = vd.reshape(b, L, H, HD).transpose(1, 2)
    pos = torch.arange(L, device="cuda")
    mask = ((pos[None, :] <= cur) & (pos[None, :] >= starts[:, None]))
    mask = mask[:, None, None, :]
    row = {
        "kernel": name, "b": b, "L": L, "cur": cur,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": float(err.max()),
        "ms": _time_ms(torch, lambda: ops.decode_attention_packed(
            q, kc, vc, cur, starts, impl="kernel", **kw), flush),
        "plain_ms": _time_ms(torch, lambda: ops.decode_attention_plain(
            q, kc, vc, cur, starts, **kw), flush),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask), flush),
        "bound_ms": _bound_ms(q, kc, starts, cur, quant),
    }
    log(f"  {name:>21} b={b} L={L:4d} cur={cur:4d} {row['dtype']:>8}: "
        f"err {row['max_abs_err']:.2e}  kernel {row['ms'] * 1e3:8.2f} us  "
        f"plain {row['plain_ms'] * 1e3:8.2f} us  "
        f"sdpa {row['library_ms'] * 1e3:8.2f} us  "
        f"bound {row['bound_ms'] * 1e3:7.3f} us")
    return row


def kernel_phase(torch, F, ops) -> dict:
    """Every shape of the sweep; returns {kernel: the serve-shape row}
    with max_abs_err raised to the sweep's worst."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    worst = {"decode_attention": 0.0, "decode_attention_int8": 0.0}
    seed = 0
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 8):
                for L in (1024, 2048):
                    for cur in (0, L // 2, L - 1):
                        seed += 1
                        row = check_kernel(torch, F, ops, b=b, L=L,
                                           cur=cur, dtype=dtype,
                                           quant=quant, flush=flush,
                                           seed=seed)
                        worst[row["kernel"]] = max(worst[row["kernel"]],
                                                   row["max_abs_err"])
    # the serve phase's own shape: 8 slots, a 2048-position pool, bf16
    # queries, the shared cursor a burst past the 256-wide base bucket
    main = {}
    for quant in (False, True):
        row = check_kernel(torch, F, ops, b=8, L=2048, cur=320,
                           dtype=torch.bfloat16, quant=quant, flush=flush,
                           seed=1000 + quant)
        row["max_abs_err"] = max(row["max_abs_err"], worst[row["kernel"]])
        main[row["kernel"]] = row
    del flush
    return main


# -------------------------------------------------------------------- serve
def _lm_base(torch, policy, seed=0, **kw):
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model

    return create_model("lm_base", policy=PrecisionPolicy.from_name(policy),
                        device="cuda", seed=seed, vocab_size=256,
                        max_len=SERVE["max_len"], pos_emb="rope", **kw)


def serve_phase(torch, ops, *, n_requests, kv_cache_dtype, kernel):
    """serve_bench's continuous and static rows at lm_base width; kernel
    launches counted from zero around the run."""
    from ddp_practice_tpu_torch.serve.bench import serve_bench

    model = _lm_base(torch, "bf16", kv_cache_dtype=kv_cache_dtype)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    report = serve_bench(model=model, n_requests=n_requests, rate_hz=16.0,
                         seed=0, **SERVE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    cont, static = report["continuous"], report["static"]
    steps = cont["decode_steps"] + static["decode_steps"]
    log(f"serve[{kv_cache_dtype or 'bf16'} cache] on {report['device']}: "
        f"{n_requests} requests, wall {wall:.1f} s, launches {launches}, "
        f"decode steps {steps} x depth {model.depth}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for r in (cont, static):
        ttft, lat = r["ttft_s"], r["latency_s"]
        line = (f"  {r['mode']:>10}: {r['tokens_per_sec']:9.1f} tok/s  "
                f"ttft p50/p99 {ttft['p50'] * 1e3:.1f}/"
                f"{ttft['p99'] * 1e3:.1f} ms  latency p50/p99 "
                f"{lat['p50'] * 1e3:.1f}/{lat['p99'] * 1e3:.1f} ms")
        if "tpot_s" in r:
            tpot = r["tpot_s"]
            line += (f"  tpot p50/p99 {tpot['p50'] * 1e3:.2f}/"
                     f"{tpot['p99'] * 1e3:.2f} ms")
        log(line)
    statuses = cont["statuses"]
    if (cont["completions"] != n_requests
            or static["completions"] != n_requests
            or set(statuses) - {"length", "eos"}):
        raise AssertionError(f"requests did not all complete: {statuses}")
    other = ("decode_attention_int8" if kernel == "decode_attention"
             else "decode_attention")
    if launches[kernel] != model.depth * steps or launches[other]:
        raise AssertionError(
            f"{kernel} launched {launches[kernel]} times, want depth "
            f"{model.depth} x {steps} decode steps; {other} "
            f"{launches[other]}")
    del model
    torch.cuda.empty_cache()
    return report, launches[kernel]


def cross_check(torch):
    """fp32 engine, kernel vs plain version, one fixed schedule (fake
    clock, every request queued up front): greedy tokens identical."""
    from ddp_practice_tpu_torch.serve import (
        EngineConfig, FakeClock, Request, Scheduler, SlotEngine,
    )
    from ddp_practice_tpu_torch.serve.bench import build_trace

    model = _lm_base(torch, "fp32", seed=1)
    trace = build_trace(n_requests=8, rate_hz=8.0, vocab=256,
                        prompt_len_range=(4, 60), max_new_range=(8, 32),
                        seed=1)
    runs = {}
    for impl in ("kernel", "plain"):
        model.set_decode_impl(impl)
        engine = SlotEngine(model, EngineConfig(
            max_slots=4, max_len=512, prompt_buckets=(16, 64),
            decode_burst=4))
        sched = Scheduler(engine, clock=FakeClock(), max_queue=64)
        for t in trace:
            sched.submit(Request(rid=t["rid"], prompt=t["prompt"],
                                 max_new_tokens=t["max_new_tokens"]))
        runs[impl] = {c.rid: list(c.tokens)
                      for c in sched.run_until_idle()}
    n = sum(len(v) for v in runs["kernel"].values())
    if runs["kernel"] != runs["plain"]:
        diff = [r for r in runs["kernel"]
                if runs["kernel"][r] != runs["plain"].get(r)]
        raise AssertionError(f"fp32 greedy tokens differ for rids {diff}")
    log(f"cross-check fp32: kernel vs plain greedy tokens identical "
        f"({len(trace)} requests, {n} tokens)")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ profile
def profile_phase(torch):
    """One decode step of the serve configuration, every slot busy with a
    200-token prompt: host wall per step from the monotonic clock (bursts
    end in a token readback), device time per step from the kernels a
    torch.profiler trace of two more bursts records."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ddp_practice_tpu_torch.serve import EngineConfig, SlotEngine

    model = _lm_base(torch, "bf16")
    engine = SlotEngine(model, EngineConfig(
        max_slots=SERVE["max_slots"], max_len=SERVE["max_len"],
        prompt_buckets=SERVE["prompt_buckets"],
        decode_burst=SERVE["decode_burst"]))
    rng = np.random.default_rng(0)
    for _ in range(SERVE["max_slots"]):
        engine.admit(rng.integers(0, model.vocab_size, 200).tolist())
    engine.step_burst()                                    # warm
    bursts, k = 2, SERVE["decode_burst"]
    t0 = time.perf_counter()
    for _ in range(bursts):
        engine.step_burst()
    host_ms = (time.perf_counter() - t0) * 1e3 / (bursts * k)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(bursts):
            engine.step_burst()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == cuda]
    steps = bursts * k
    if not kernels:
        log("profile: torch.profiler recorded no device events; device "
            f"time not measured (host wall {host_ms:.3f} ms per step)")
        return
    by_kind = {"decode_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.name.lower()
        kind = ("decode_attention" if "decode_attention" in name
                else "matmul" if any(t in name for t in (
                    "gemm", "cutlass", "xmma", "nvjet", "gemv"))
                else "other")
        by_kind[kind] += e.time_range.elapsed_us()
    device_ms = sum(by_kind.values()) / 1e3 / steps
    share = {kind: us / 1e3 / steps / device_ms
             for kind, us in by_kind.items()}
    log(f"profile (lm_base bf16, {SERVE['max_slots']} busy slots, cursor "
        f"{engine.cursor}): host wall {host_ms:.3f} ms/step, device busy "
        f"{device_ms:.3f} ms/step, device idle share "
        f"{max(0.0, 1 - device_ms / host_ms):.3f}, "
        f"{len(kernels) / steps:.0f} device ops/step; device time by kind "
        + ", ".join(f"{kind} {s:.3f}" for kind, s in share.items()))
    per_name = {}
    for e in kernels:
        n, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for name, (n, us) in sorted(per_name.items(),
                                key=lambda kv: -kv[1][1])[:10]:
        log(f"  {us / steps:9.2f} us/step {n / steps:5.1f} calls/step  "
            f"{name[:110]}")
    del engine, model
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from ddp_practice_tpu_torch.ops import cuda_build
    from ddp_practice_tpu_torch.ops import decode_attention as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.monotonic()
    cuda_build.build(["decode_attention"])
    log(f"built {SOURCE} for sm_90a in {time.monotonic() - t0:.1f} s")
    for name, info in cuda_build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    log(f"kernel phase (b, L, cur, dtype; device times are medians of "
        f"{TIMED_RUNS}):")
    main_rows = kernel_phase(torch, F, ops)

    _, launches_a = serve_phase(torch, ops, n_requests=12,
                                kv_cache_dtype=None,
                                kernel="decode_attention")
    _, launches_b = serve_phase(torch, ops, n_requests=6,
                                kv_cache_dtype="int8",
                                kernel="decode_attention_int8")
    cross_check(torch)
    profile_phase(torch)

    launches = {"decode_attention": launches_a,
                "decode_attention_int8": launches_b}
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row["library_ms"],
        })
    log(smi)   # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
