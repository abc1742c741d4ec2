#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ddp_practice_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and passed):

1. setup: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from csrc/ with nvcc and print ptxas's register and spill
   lines;
2. kernels: hold each kernel against its plain PyTorch version at lm_base
   shapes (h=12, hd=64) and print its device time (CUDA events around one
   call queued behind a spin kernel, L2 flushed before each, median of
   20), the plain version's time, a yardstick PyTorch call's time (the
   port never calls it) and the HBM-bytes bound:
   - kernels A and B (flat cache): b in {1, 8}, L in {1024, 2048}, cur in
     {0, mid, L-1}, random attn_start, plus the serve path's shape; the
     yardstick is F.scaled_dot_product_attention on the same masked
     problem;
   - kernels C and D (paged pool): 16-position blocks, 128 blocks per
     slot (2048 positions) over a 1 + 8*128-block pool, b in {1, 8},
     lengths 0, mid and 2047 mixed across slots, random attn_start, two
     slots sharing blocks and one retired garbage-block row; plus the
     main path's shapes (the paged serve row's mid-run step for C, the
     int8 shared-prefix run's step for D). No single PyTorch call walks a
     page table, so the yardstick is SDPA over each slot's span gathered
     OUTSIDE the timed region: it skips the gather the kernel does;
3. serve: lm_base under the bf16 policy from a seeded random init
   (d=768, depth 12, 12 heads, mlp 3072, vocab 256) serves a Poisson trace
   through serve_bench's continuous, static and paged rows; every request
   completes, and in each row each kernel's launches equal depth x that
   row's decode steps (A in the slot and static rows, C in the paged row,
   nothing else). A shorter int8-cache run does the same for kernel B;
4. shared prefix: shared_prefix_bench at lm_base bf16 with its undersized
   pool, plain paged vs prefix cache (hit rate, preemptions, goodput
   ratio), then again over an int8 pool for kernel D;
5. spec: spec_decode_bench at lm_base fp32: token identity between the
   plain paged and the speculative arm must be 1.0; kernel C's launches
   include the verify correction steps;
6. cross-check (fp32, one deterministic schedule): the slot engine and
   the paged engine, each with its kernel and with the plain version,
   emit identical greedy tokens;
7. profile: where one decode step of the serve configuration spends its
   time, for the slot and the paged engine (torch.profiler over two
   bursts with every slot busy): host wall per step, device busy time per
   step and the device's idle share, device ops per step, and the
   attention kernel's share.

Launch counts are zeroed just before each phase's run and read just
after it. The second-to-last line is the kernels' JSON record; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.

Tolerances: fp32 2e-5 (the reference's decode-attention tests). bf16
|err| <= 1.6e-2 + 2^-7 |ref|: each kernel and its plain version round at
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
    "paged_decode_attention":
        "ddp_practice_tpu/ops/decode_attention.py:517",
    "paged_decode_attention_int8":
        "ddp_practice_tpu/ops/decode_attention.py:606",
}
# the serve phase: lm_base under the bf16 policy
SERVE = dict(max_slots=8, max_len=2048, prompt_buckets=(16, 64, 256),
             decode_burst=8, prompt_len_range=(4, 200),
             max_new_range=(8, 64), eos_id=None)
# the paged sweep: 2048-position slots over a full-backing pool
BS, MB = 16, 128
NB = 1 + 8 * MB


def log(*args) -> None:
    print(*args, flush=True)


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


def _compare(torch, name, got, want, dtype, what):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite {name} output: {what}")
    err = (got.float() - want.float()).abs()
    atol, rtol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    if (err > atol + rtol * want.float().abs()).any():
        raise AssertionError(
            f"{name} disagrees with its plain version: {what}: max |err| "
            f"{float(err.max()):.3e}")
    return float(err.max())


# ------------------------------------------------------- kernels A and B
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


def check_kernel(torch, F, ops, *, b, L, cur, dtype, quant, flush, seed):
    q, kc, vc, starts, ks, vs = _inputs(torch, b, L, cur, dtype, quant,
                                        seed)
    kw = dict(n_heads=H, k_scale=ks, v_scale=vs)
    name = "decode_attention_int8" if quant else "decode_attention"
    err = _compare(
        torch, name,
        ops.decode_attention_packed(q, kc, vc, cur, starts, impl="kernel",
                                    **kw),
        ops.decode_attention_plain(q, kc, vc, cur, starts, **kw), dtype,
        f"b={b} L={L} cur={cur} {dtype}")
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
        "max_abs_err": err,
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


def kernel_phase(torch, F, ops, flush) -> dict:
    """Kernels A and B over the sweep; returns {kernel: the serve-shape
    row} with max_abs_err raised to the sweep's worst."""
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
    return main


# ------------------------------------------------------- kernels C and D
def _sweep_case(np, rng, lengths):
    """Tables of distinct blocks over the full pool, slots 0 and 1 sharing
    their first half, and (b > 2) the last row retired: garbage block 0,
    length 0. Random attn_start in [0, length]."""
    b = len(lengths)
    tables = rng.permutation(np.arange(1, NB))[: b * MB].reshape(b, MB)
    lengths = list(lengths)
    if b > 1:
        tables[1, : MB // 2] = tables[0, : MB // 2]
    starts = [int(rng.integers(0, n + 1)) for n in lengths]
    if b > 2:
        tables[-1] = 0
        lengths[-1] = starts[-1] = 0
    return dict(tables=tables, lengths=lengths, starts=starts, nb=NB)


def _serve_case(np, rng):
    """The paged serve row's mid-run step: 8 slots, per-slot capacity
    ceil((256 + 64) / 16) = 20 blocks over the bench's 1 + 8*128-block
    pool; each slot a left-padded prompt of 4-200 tokens in its bucket
    and 0-63 tokens decoded."""
    mb = -(-(max(SERVE["prompt_buckets"]) + SERVE["max_new_range"][1])
           // BS)
    free = list(rng.permutation(np.arange(1, NB)))
    tables = np.zeros((8, mb), np.int64)
    lengths, starts = [], []
    for i in range(8):
        p = int(rng.integers(4, 201))
        w = next(w for w in SERVE["prompt_buckets"] if p <= w)
        n = w + int(rng.integers(0, 64))
        nblk = -(-(n + 1) // BS)
        tables[i, :nblk] = [free.pop() for _ in range(nblk)]
        lengths.append(n)
        starts.append(w - p)
    return dict(tables=tables, lengths=lengths, starts=starts, nb=NB)


def _shared_prefix_case(np, rng):
    """The int8 shared-prefix run's step: 8 slots over its 20-block pool,
    the bench's per-slot capacity for that trace, ceil((96 + 128 + 8) /
    16) = 15 blocks; each slot one of two 6-block prefix chains plus a
    private block, 97-104 prompt tokens and 0-7 decoded."""
    tables = np.zeros((8, 15), np.int64)
    lengths = []
    for i in range(8):
        tables[i, :6] = np.arange(1, 7) + 6 * (i % 2)
        tables[i, 6] = 13 + i % 7
        lengths.append(96 + int(rng.integers(1, 9))
                       + int(rng.integers(0, 8)))
    return dict(tables=tables, lengths=lengths, starts=[0] * 8, nb=20)


def _paged_inputs(torch, case, dtype, quant, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = len(case["lengths"])
    q = torch.randn((b, 1, H * HD), generator=g, device="cuda").to(dtype)
    shape = (case["nb"], BS, H * HD)
    ks = vs = None
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        scale_shape = (case["nb"], H, BS)
        ks = torch.rand(scale_shape, generator=g, device="cuda") * 0.02 + 1e-3
        vs = torch.rand(scale_shape, generator=g, device="cuda") * 0.02 + 1e-3
    else:
        kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=g, device="cuda").to(dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    return (q, kp, vp, i32(case["tables"]), i32(case["lengths"]),
            i32(case["starts"]), ks, vs)


def _paged_bound_ms(torch, q, kp, tables, lengths, starts, quant) -> float:
    """HBM bytes the step must move: q and the output once, the page table
    and the cursors, and each distinct pool row that some slot reads, once
    with its scale entries: the union over slots of (page_table[b, p //
    bs], p % bs) for p in [start_b, min(length_b, capacity - 1)]. Slots
    that share blocks share those rows. Over 3.35 TB/s."""
    pos = torch.arange(tables.shape[1] * BS, device=tables.device)
    valid = ((pos[None, :] >= starts[:, None].long())
             & (pos[None, :] <= lengths[:, None].long()))
    row_id = (tables.long().repeat_interleave(BS, dim=1) * BS
              + pos[None, :] % BS)
    rows = int(torch.unique(row_id[valid]).numel())
    nbytes = 2 * q.numel() * q.element_size()
    nbytes += 2 * rows * H * HD * kp.element_size()
    nbytes += tables.numel() * 4 + 2 * q.shape[0] * 4
    if quant:
        nbytes += 2 * rows * H * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_paged(torch, F, ops, *, case, dtype, quant, flush, seed, label):
    q, kp, vp, tables, lengths, starts, ks, vs = _paged_inputs(
        torch, case, dtype, quant, seed)
    kw = dict(n_heads=H, k_scale=ks, v_scale=vs)
    args = (q, kp, vp, tables, lengths, starts)
    name = ("paged_decode_attention_int8" if quant
            else "paged_decode_attention")
    err = _compare(
        torch, name, ops.paged_decode_attention(*args, impl="kernel", **kw),
        ops.paged_decode_attention_plain(*args, **kw), dtype,
        f"{label} {dtype}")
    # the yardstick: SDPA over each slot's span, gathered (and for int8
    # dequantized) OUTSIDE the timed call — it skips the gather
    b = q.shape[0]
    k4 = ops.gather_pages(kp, tables, H, ks).to(dtype).transpose(1, 2)
    v4 = ops.gather_pages(vp, tables, H, vs).to(dtype).transpose(1, 2)
    pos = torch.arange(k4.shape[2], device="cuda")
    mask = ((pos[None, :] <= lengths[:, None])
            & (pos[None, :] >= starts[:, None]))[:, None, None, :]
    q4 = q.view(b, 1, H, HD).transpose(1, 2)
    row = {
        "kernel": name, "shape": label,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": _time_ms(torch, lambda: ops.paged_decode_attention(
            *args, impl="kernel", **kw), flush),
        "plain_ms": _time_ms(torch, lambda: ops.paged_decode_attention_plain(
            *args, **kw), flush),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask), flush),
        "bound_ms": _paged_bound_ms(torch, q, kp, tables, lengths, starts,
                                    quant),
    }
    log(f"  {name:>27} {label:<34} {row['dtype']:>8}: "
        f"err {err:.2e}  kernel {row['ms'] * 1e3:8.2f} us  "
        f"plain {row['plain_ms'] * 1e3:8.2f} us  sdpa-pregathered "
        f"{row['library_ms'] * 1e3:8.2f} us  "
        f"bound {row['bound_ms'] * 1e3:7.3f} us")
    return row


def paged_kernel_phase(torch, F, ops, flush) -> dict:
    """Kernels C and D over the sweep; returns {kernel: main-path row}
    with max_abs_err raised to the sweep's worst."""
    import numpy as np

    rng = np.random.default_rng(0)
    top = MB * BS - 1
    cases = [(f"b=1 mb={MB} len={n}", _sweep_case(np, rng, [n]))
             for n in (0, top // 2, top)]
    cases.append((f"b=8 mb={MB} mixed+shared+garbage", _sweep_case(
        np, rng, [top, top // 2, 0, 1500, top, 777, 64, 0])))
    worst = {"paged_decode_attention": 0.0,
             "paged_decode_attention_int8": 0.0}
    seed = 2000
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for label, case in cases:
                seed += 1
                row = check_paged(torch, F, ops, case=case, dtype=dtype,
                                  quant=quant, flush=flush, seed=seed,
                                  label=label)
                worst[row["kernel"]] = max(worst[row["kernel"]],
                                           row["max_abs_err"])
    main = {}
    for quant, label, case in (
            (False, "serve b=8 mb=20 (paged row)", _serve_case(np, rng)),
            (True, "prefix b=8 mb=15 nb=20 (int8 run)",
             _shared_prefix_case(np, rng))):
        row = check_paged(torch, F, ops, case=case, dtype=torch.bfloat16,
                          quant=quant, flush=flush, seed=3000 + quant,
                          label=label)
        row["max_abs_err"] = max(row["max_abs_err"], worst[row["kernel"]])
        main[row["kernel"]] = row
    return main


# -------------------------------------------------------------------- serve
def _lm_base(torch, policy, seed=0, **kw):
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model

    return create_model("lm_base", policy=PrecisionPolicy.from_name(policy),
                        device="cuda", seed=seed, vocab_size=256,
                        max_len=SERVE["max_len"], pos_emb="rope", **kw)


def _row_line(r) -> str:
    ttft, lat = r["ttft_s"], r["latency_s"]
    line = (f"  {r['mode']:>12}: {r['tokens_per_sec']:9.1f} tok/s  "
            f"ttft p50/p99 {ttft['p50'] * 1e3:.1f}/{ttft['p99'] * 1e3:.1f} "
            f"ms  latency p50/p99 {lat['p50'] * 1e3:.1f}/"
            f"{lat['p99'] * 1e3:.1f} ms")
    if "tpot_s" in r:
        tpot = r["tpot_s"]
        line += (f"  tpot p50/p99 {tpot['p50'] * 1e3:.2f}/"
                 f"{tpot['p99'] * 1e3:.2f} ms")
    if "preemptions" in r:
        line += (f"  preemptions {r['preemptions']}  kv "
                 f"{r['kv_bytes_per_token']:.0f} B/token")
    return line + f"  decode steps {r['decode_steps']}"


def _check_rows(rows, n_requests, depth, kernel_of):
    """Every request of every row completed, and in each row exactly the
    row's own kernel launched, depth x its decode steps times."""
    for r in rows:
        statuses = r.get("statuses", {"length": r["completions"]})
        if r["completions"] != n_requests or set(statuses) - {"length",
                                                               "eos"}:
            raise AssertionError(
                f"{r['mode']}: requests did not all complete: {statuses}")
        launched = {k: v for k, v in r["kernel_launches"].items() if v}
        want = {kernel_of[r["mode"]]: depth * r["decode_steps"]}
        if launched != want:
            raise AssertionError(
                f"{r['mode']}: launches {launched}, want {want} (depth "
                f"{depth} x {r['decode_steps']} decode steps)")


def serve_phase(torch, ops, *, n_requests, kv_cache_dtype, paged):
    """serve_bench at lm_base bf16; launch counts zeroed around the run."""
    from ddp_practice_tpu_torch.serve.bench import serve_bench

    model = _lm_base(torch, "bf16", kv_cache_dtype=kv_cache_dtype)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    report = serve_bench(model=model, n_requests=n_requests, rate_hz=16.0,
                         seed=0, paged=paged, **SERVE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    flat = ("decode_attention_int8" if kv_cache_dtype == "int8"
            else "decode_attention")
    rows = [report["continuous"], report["static"]]
    kernel_of = {"continuous": flat, "static": flat}
    if paged:
        rows.append(report["paged"])
        kernel_of["paged"] = "paged_decode_attention"
    log(f"serve[{kv_cache_dtype or 'bf16'} cache] on {report['device']}: "
        f"{n_requests} requests, wall {wall:.1f} s, launches {launches}, "
        f"depth {model.depth}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for r in rows:
        log(_row_line(r))
    if paged:
        log(f"  paged/static {report['paged_vs_static']:.2f}x  "
            f"paged/continuous {report['paged_vs_continuous']:.2f}x  "
            f"max servable context {report['paged']['max_servable_context']}")
    _check_rows(rows, n_requests, model.depth, kernel_of)
    del model
    torch.cuda.empty_cache()
    return report, launches


def shared_prefix_phase(torch, ops, *, n_requests, kv_int8):
    """shared_prefix_bench at lm_base bf16 with its undersized pool."""
    from ddp_practice_tpu_torch.serve.bench import shared_prefix_bench

    model = _lm_base(torch, "bf16",
                     kv_cache_dtype="int8" if kv_int8 else None)
    ops.reset_launches()
    t0 = time.monotonic()
    report = shared_prefix_bench(model=model, n_requests=n_requests,
                                 seed=0, kv_int8=kv_int8)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    kernel = ("paged_decode_attention_int8" if kv_int8
              else "paged_decode_attention")
    rows = [report["paged"], report["paged_prefix"]]
    pool = report["pool"]
    pc = report["paged_prefix"]["prefix_cache"]
    log(f"shared-prefix[{pool['kv_cache_dtype']} pool, {pool['num_blocks']}"
        f" blocks x {pool['block_size']}] on {report['device']}: "
        f"{n_requests} requests, wall {wall:.1f} s, launches {launches}")
    for r in rows:
        log(_row_line(r))
    line = (f"  prefix/paged goodput {report['prefix_vs_paged']:.2f}x  "
            f"hit rate {pc['hit_rate']:.3f} (hit/miss tokens "
            f"{pc['hit_tokens']}/{pc['miss_tokens']})")
    if kv_int8:
        line += (f"  kv bytes/token int8 "
                 f"{report['paged_prefix']['kv_bytes_per_token']:.0f} vs "
                 f"fp32 {report['kv_bytes_per_token_f32']:.0f}")
    log(line)
    _check_rows(rows, n_requests, model.depth,
                {"paged": kernel, "paged+prefix": kernel})
    if pc["hit_tokens"] <= 0:
        raise AssertionError("the prefix cache never hit")
    del model
    torch.cuda.empty_cache()
    return report, launches


def spec_phase(torch, ops, *, n_requests):
    """spec_decode_bench at lm_base fp32: greedy speculation must emit the
    plain engine's tokens."""
    from ddp_practice_tpu_torch.serve.bench import spec_decode_bench

    model = _lm_base(torch, "fp32")
    ops.reset_launches()
    t0 = time.monotonic()
    report = spec_decode_bench(model=model, n_requests=n_requests, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    rows = [report["paged"], report["paged_spec"]]
    spec = report["paged_spec"]["spec"]
    log(f"spec[fp32, spec_k {report['spec_k']}] on {report['device']}: "
        f"{n_requests} requests, wall {wall:.1f} s, launches {launches}")
    for r in rows:
        log(_row_line(r))
    log(f"  spec/paged tpot p50 {report['tpot_ratio']:.3f}x  latency p50 "
        f"{report['latency_ratio_p50']:.3f}x  accept rate "
        f"{report['accept_rate']:.3f} ({spec['accepted_tokens']}/"
        f"{spec['drafted_tokens']} drafted tokens, "
        f"{spec['verify_dispatches']} verify dispatches)  token identity "
        f"{report['token_identity']:.3f}")
    kernel = "paged_decode_attention"
    _check_rows(rows, n_requests, model.depth,
                {"paged": kernel, "paged+spec": kernel})
    if report["token_identity"] != 1.0:
        raise AssertionError(
            f"speculative tokens differ from plain paged decode: identity "
            f"{report['token_identity']}")
    del model
    torch.cuda.empty_cache()
    return report, launches


def cross_check(torch):
    """fp32, one fixed schedule (fake clock, every request queued up
    front): the slot engine and the paged engine, each with its kernel
    and with the plain version, emit identical greedy tokens."""
    from ddp_practice_tpu_torch.serve import (
        EngineConfig, FakeClock, PagedEngine, Request, Scheduler,
        SlotEngine,
    )
    from ddp_practice_tpu_torch.serve.bench import build_trace

    model = _lm_base(torch, "fp32", seed=1)
    trace = build_trace(n_requests=8, rate_hz=8.0, vocab=256,
                        prompt_len_range=(4, 60), max_new_range=(8, 32),
                        seed=1)
    cfg = EngineConfig(max_slots=4, max_len=512, prompt_buckets=(16, 64),
                       decode_burst=4, block_size=BS)
    runs = {}
    for engine_cls in (SlotEngine, PagedEngine):
        for impl in ("kernel", "plain"):
            model.set_decode_impl(impl)
            sched = Scheduler(engine_cls(model, cfg), clock=FakeClock(),
                              max_queue=64)
            for t in trace:
                sched.submit(Request(rid=t["rid"], prompt=t["prompt"],
                                     max_new_tokens=t["max_new_tokens"]))
            runs[(engine_cls.__name__, impl)] = {
                c.rid: list(c.tokens) for c in sched.run_until_idle()}
    model.set_decode_impl("auto")
    want = runs[("SlotEngine", "kernel")]
    n = sum(len(v) for v in want.values())
    for key, got in runs.items():
        if got != want:
            diff = [r for r in want if got.get(r) != want[r]]
            raise AssertionError(f"fp32 greedy tokens of {key} differ from "
                                 f"the slot engine's kernel run: rids {diff}")
    log(f"cross-check fp32: slot and paged engines, kernel and plain, "
        f"greedy tokens identical ({len(trace)} requests, {n} tokens)")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ profile
def profile_phase(torch, engine_name):
    """One decode step of the serve configuration, every slot busy with a
    200-token prompt: host wall per step from the monotonic clock (bursts
    end in a token readback), device time per step from the kernels a
    torch.profiler trace of two more bursts records."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ddp_practice_tpu_torch.serve import (
        EngineConfig, PagedEngine, SlotEngine,
    )

    engine_cls = {"slot": SlotEngine, "paged": PagedEngine}[engine_name]
    model = _lm_base(torch, "bf16")
    engine = engine_cls(model, EngineConfig(
        max_slots=SERVE["max_slots"], max_len=SERVE["max_len"],
        prompt_buckets=SERVE["prompt_buckets"],
        decode_burst=SERVE["decode_burst"], block_size=BS))
    rng = np.random.default_rng(0)
    slots = [engine.admit(rng.integers(0, model.vocab_size, 200).tolist())
             for _ in range(SERVE["max_slots"])]
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
    where = (f"cursor {engine.cursor}" if engine_name == "slot" else
             f"slot lengths {sorted({engine.context_len(s) for s in slots})}")
    if not kernels:
        log(f"profile[{engine_name}]: torch.profiler recorded no device "
            f"events; device time not measured (host wall {host_ms:.3f} ms "
            f"per step)")
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
    log(f"profile[{engine_name}] (lm_base bf16, {SERVE['max_slots']} busy "
        f"slots, {where}): host wall {host_ms:.3f} ms/step, device busy "
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
    log(f"built {SOURCE} (kernels A-D) for sm_90a in "
        f"{time.monotonic() - t0:.1f} s")
    for name, info in cuda_build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    log(f"kernel phase, flat cache (b, L, cur, dtype; device times are "
        f"medians of {TIMED_RUNS}):")
    main_rows = kernel_phase(torch, F, ops, flush)
    log(f"kernel phase, paged pool (block {BS}; device times are medians "
        f"of {TIMED_RUNS}):")
    main_rows.update(paged_kernel_phase(torch, F, ops, flush))
    del flush

    _, serve_launches = serve_phase(torch, ops, n_requests=12,
                                    kv_cache_dtype=None, paged=True)
    _, int8_launches = serve_phase(torch, ops, n_requests=6,
                                   kv_cache_dtype="int8", paged=False)
    shared_prefix_phase(torch, ops, n_requests=32, kv_int8=False)
    _, prefix8_launches = shared_prefix_phase(torch, ops, n_requests=16,
                                              kv_int8=True)
    spec_phase(torch, ops, n_requests=16)
    cross_check(torch)
    profile_phase(torch, "slot")
    profile_phase(torch, "paged")

    # each kernel's launches on its main path's run
    launches = {
        "decode_attention": serve_launches["decode_attention"],
        "decode_attention_int8": int8_launches["decode_attention_int8"],
        "paged_decode_attention": serve_launches["paged_decode_attention"],
        "paged_decode_attention_int8":
            prefix8_launches["paged_decode_attention_int8"],
    }
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
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
