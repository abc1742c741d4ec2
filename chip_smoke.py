#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ddp_practice_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and passed):

1. setup: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from csrc/ with nvcc (both sources at once) and print
   ptxas's register and spill lines;
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
   attention kernel's share;
8. flash kernels: E (forward) and F+G (backward) against their plain
   versions at the lm_base training shape (b=8, h=12, d=64, s=2048,
   causal, bf16) with packed and fused-QKV strides, at s=8192 b=1, folded
   at h=24 d=32 (the folded leg's shape) and in fp32 at s=512, with
   kernel, plain and SDPA (F.scaled_dot_product_attention, forward and
   its autograd backward; the port never calls it) device times and the
   bound, forward and backward apart;
9. train: `fit` through the CLI's parser and config, lm_base (d=768,
   depth 12, 12 heads, mlp 3072) at seq 2048, batch 8, bf16, AdamW lr
   3e-4, attn_impl flash, 30 steps on the synthetic Markov corpus: the
   loss at steps 1, 10, 20, 30 (30 below 1), the median step time (CUDA
   events between step ends), tokens/s, MFU against 989.4e12, eval
   accuracy and perplexity, peak memory; flash_fwd_packed launches equal
   12 x (30 + eval batches) and flash_bwd_packed 12 x 30;
10. legs: 10 steps with RoPE (the packed rows again, through
   dot_product_attention) and 10 with 24 heads of 32 (the folded rows);
11. cross-check, one lm_base train step at depth 2, b=2: in fp32 at
   s=512 the kernels, the plain versions and attn_impl="xla" give one
   loss (1e-5) and grads (1e-4); in bf16 at s=2048 the tensor-core
   kernels and the plain versions give one loss (1e-3 relative) and
   grads within 1e-2 of each grad's norm;
12. train profile: one bf16 lm_base train step under torch.profiler:
   host wall, device busy, idle share, device ops, E/F/G's share.

Launch counts are zeroed just before each phase's run and read just
after it. The second-to-last line is the kernels' JSON record; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.

Tolerances: fp32 2e-5 (the reference's decode-attention tests). bf16
|err| <= 1.6e-2 + 2^-7 |ref|: each kernel and its plain version round at
the same points (q*scale, p, the output) and differ only in fp32
summation order, which can flip the final bf16 rounding of an output, or
of one p, by an ulp (2^-7 relative, 7.8e-3 absolute below 1). Flash
holds the output and each of dq, dk and dv apart: element by element at
the reference flash tests' 2e-5 (forward) and 1e-4 (grads) in fp32, and
at the bf16 limit above in bf16 (the same rounding points: p, ds and the
outputs can flip by an ulp); and in norm, ||kernel - plain|| / ||plain||
under 1e-5 in fp32 and 2e-3 in bf16 per tensor, since ulp flips are rare
and scattered while a kernel wrong on one tile moves all of its elements.
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
FLASH_SOURCE = "ddp_practice_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd_packed": "ddp_practice_tpu/ops/flash_attention.py:541",
    "flash_bwd_packed": "ddp_practice_tpu/ops/flash_attention.py:730",
    "flash_fwd_folded": "ddp_practice_tpu/ops/flash_attention.py:236",
    "flash_bwd_folded": "ddp_practice_tpu/ops/flash_attention.py:375",
}
# H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores;
# fp32 runs outside them (the kernels do not use TF32)
PEAK = {"bfloat16": 989.4e12, "float32": 67e12}
# flash: per-element (atol, rtol) for (forward, grads), and the limit on
# each tensor's relative error norm
FLASH_TOL = {"float32": ((2e-5, 2e-5), (1e-4, 1e-4)),
             "bfloat16": (BF16_TOL, BF16_TOL)}
FLASH_REL = {"float32": 1e-5, "bfloat16": 2e-3}
MODEL_BF16_REL = 1e-2     # a bf16 model step, kernels vs plain versions
TRAIN_ARGS = ["--model", "lm_base", "--attn_impl", "flash", "--precision",
              "bf16", "--optimizer", "adamw", "--lr", "3e-4", "--seq_len",
              "2048", "-b", "8", "-e", "1", "--log_every", "10"]
TRAIN_STEPS = 30
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


# ------------------------------------------------------- kernels E, F, G
def _flash_bound_ms(b, h, sq, sk, d, causal, dtype, elt, backward):
    """The larger of the operations and the bytes over the card's peaks.
    Operations: the products over the (query, key) pairs this causal
    pattern leaves visible (2 flop per multiply-add), 2 products forward
    and 5 backward (qk^T again, p^T.do, do.v^T, ds^T.q, ds.k). Bytes:
    each input read once, each output written once (q, k, v in, out and
    the fp32 lse out; backward q, k, v, o, do, lse in, dq, dk, dv out)."""
    offset = sk - sq if causal else 0
    pairs = sum(min(sk, i + offset + 1) for i in range(sq)) if causal \
        else sq * sk
    flops = (10 if backward else 4) * b * h * pairs * d
    elems = b * h * d * (sq + 2 * sk)
    if backward:
        nbytes = (2 * elems + 2 * b * h * sq * d) * elt + b * h * sq * 4
    else:
        nbytes = (elems + b * h * sq * d) * elt + b * h * sq * 4
    t_ops = flops / PEAK[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _flash_err(torch, name, got, want, dtype, backward, what):
    """(max |got - want|, ||got - want|| / ||want||) of one tensor; raises
    past FLASH_TOL element by element or past FLASH_REL in norm."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite {name} output: {what}")
    got, want = got.float(), want.float()
    atol, rtol = FLASH_TOL[dtype][backward]
    err = (got - want).abs()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    if (err > atol + rtol * want.abs()).any() or rel > FLASH_REL[dtype]:
        raise AssertionError(
            f"{name} disagrees with its plain version: {what}: max |err| "
            f"{float(err.max()):.3e}, relative norm {rel:.3e}")
    return float(err.max()), rel


def check_flash(torch, F, fa, *, label, route, b, h, sq, sk, d, dtype,
                flush, seed, causal=True):
    """E and F+G against the plain versions on one shape and route
    ("qkv": fused-QKV windows, "packed": flat (b, s, h*d), "folded":
    (b, s, h, d) heads that do not pack); the timed calls are the
    launches alone on prepared operands."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    elt = torch.tensor([], dtype=tdt).element_size()
    if route == "qkv":
        qkv = torch.randn((b, sq, 3 * h * d), generator=g,
                          device="cuda").to(tdt)
        w = qkv.unflatten(-1, (3, h, d))
        q4, k4, v4 = (w[:, :, i].transpose(1, 2) for i in range(3))
        inputs = [qkv]

        def entry(x, impl):
            return fa.flash_attention_qkv(x, h, causal=causal, impl=impl)
    else:
        q, k, v = (torch.randn((b, s, h, d), generator=g,
                               device="cuda").to(tdt)
                   for s in (sq, sk, sk))
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
        inputs = [q, k, v]

        def entry(*xs, impl):
            return fa.flash_attention(*xs[:3], causal=causal, impl=impl)
    row = "packed" if route in ("qkv", "packed") else "folded"
    assert (fa._heads_per_pack(h, d) is not None) == (row == "packed")
    do = torch.randn((b, sq, h, d), generator=g, device="cuda").to(tdt)
    what = f"{label} {dtype}"

    def run(impl):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = entry(*xs, impl=impl)
        grads = torch.autograd.grad(out, xs, do)
        return out.detach(), grads

    out_k, grads_k = run("kernel")
    out_p, grads_p = run("plain")
    if route == "qkv":           # the (b, s, 3hd) gradient's three windows
        grads_k, grads_p = grads_k[0].chunk(3, -1), grads_p[0].chunk(3, -1)
    err_f, rel_f = _flash_err(torch, "E", out_k, out_p, dtype, False,
                              f"{what} out")
    errs = [_flash_err(torch, "F+G", a, b_, dtype, True, f"{what} {n}")
            for n, a, b_ in zip(("dq", "dk", "dv"), grads_k, grads_p)]
    err_b = max(e for e, _ in errs)
    log(f"  {'E, F+G vs plain':>16} {label:<34} {dtype:>8}: max |err| / "
        f"relative norm: out {err_f:.2e} / {rel_f:.2e}  " + "  ".join(
            f"{n} {e:.2e} / {r:.2e}"
            for n, (e, r) in zip(("dq", "dk", "dv"), errs)))
    # the launches alone, on the forward's own residuals
    out4 = torch.empty_like(q4)
    lse = fa._launch_fwd(q4, k4, v4, out4, causal)
    do4 = do.transpose(1, 2)
    dq4, dk4, dv4 = (torch.empty_like(t) for t in (q4, k4, v4))
    row_f, row_b = f"flash_fwd_{row}", f"flash_bwd_{row}"
    ms_f = _time_ms(torch, lambda: fa._launch_fwd(q4, k4, v4, out4, causal),
                    flush)
    ms_b = _time_ms(torch, lambda: fa._launch_bwd(
        q4, k4, v4, out4, do4, lse, None, dq4, dk4, dv4, causal), flush)
    plain_f = _time_ms(torch, lambda: fa.flash_attention_plain(
        q4, k4, v4, causal=causal), flush, runs=5)
    plain_b = _time_ms(torch, lambda: fa.flash_attention_plain_bwd(
        q4, k4, v4, out4, do4, lse, causal=causal), flush, runs=5)
    lib_f = lib_b = None
    if sq == sk:
        qs, ks, vs = (t.detach().contiguous().requires_grad_(True)
                      for t in (q4, k4, v4))

        def sdpa_forward():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal)

        lib_f = _time_ms(torch, sdpa_forward, flush)
        ref = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        do4c = do4.contiguous()
        lib_b = _time_ms(torch, lambda: torch.autograd.grad(
            ref, (qs, ks, vs), do4c, retain_graph=True), flush)
    rows = {}
    for name, err, ms, plain, lib, backward in (
            (row_f, err_f, ms_f, plain_f, lib_f, False),
            (row_b, err_b, ms_b, plain_b, lib_b, True)):
        bound, by = _flash_bound_ms(b, h, sq, sk, d, causal, dtype, elt,
                                    backward)
        rows[name] = {"kernel": name, "shape": label, "dtype": dtype,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": bound, "bound_by": by}
        lib_txt = "-" if lib is None else f"{lib:8.3f}"
        log(f"  {name:>16} {label:<34} {dtype:>8}: err {err:.2e}  "
            f"kernel {ms:8.3f} ms  plain {plain:8.3f} ms  sdpa {lib_txt} ms"
            f"  bound {bound:7.3f} ms ({by})")
    return rows


def flash_kernel_phase(torch, F, fa, flush) -> dict:
    """E/F/G over the shapes; returns {row: main-path row} with
    max_abs_err raised to the sweep's worst. The packed rows' main path is
    the lm_base training shape through the fused-QKV windows, the folded
    rows' the folded leg's (24 heads of 32)."""
    worst = {n: 0.0 for n in FLASH_REPLACES}
    main = {}
    cases = [
        ("lm_base train b=8 s=2048 fused-qkv", "qkv", 8, 12, 2048, 2048, 64,
         "bfloat16", True),
        ("lm_base train b=8 s=2048 packed", "packed", 8, 12, 2048, 2048, 64,
         "bfloat16", False),
        ("b=1 s=8192 packed", "packed", 1, 12, 8192, 8192, 64, "bfloat16",
         False),
        ("folded leg b=8 s=2048 h=24 d=32", "folded", 8, 24, 2048, 2048, 32,
         "bfloat16", True),
        ("fp32 b=2 s=512 fused-qkv", "qkv", 2, 12, 512, 512, 64, "float32",
         False),
        ("fp32 b=2 s=512 h=24 d=32", "folded", 2, 24, 512, 512, 32,
         "float32", False),
    ]
    for seed, (label, route, b, h, sq, sk, d, dtype, is_main) in \
            enumerate(cases):
        rows = check_flash(torch, F, fa, label=label, route=route, b=b, h=h,
                           sq=sq, sk=sk, d=d, dtype=dtype, flush=flush,
                           seed=4000 + seed)
        for name, row in rows.items():
            worst[name] = max(worst[name], row["max_abs_err"])
            if is_main:
                main[name] = row
    for name, row in main.items():
        row["max_abs_err"] = worst[name]
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


# -------------------------------------------------------------------- train
def train_phase(torch, fa, extra, *, steps, label, row, metrics_file=None):
    """`fit` through the CLI's parser and config (lm_base, bf16, AdamW,
    flash) for `steps` steps; each step's loss stays on the device and a
    CUDA event marks its end (no extra readback). Checks that the loss
    fell and that `row`'s kernels launched depth x (steps + eval batches)
    forward and depth x steps backward, and nothing else. Returns the
    trainer (for the profile) and the report."""
    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.train.loop import Trainer
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        lm_train_flops_per_token,
    )

    argv = TRAIN_ARGS + ["--max_steps", str(steps)] + extra
    if metrics_file:
        argv += ["--metrics_file", metrics_file]
    config = config_from_args(build_parser().parse_args(argv))
    trainer = Trainer(config)
    losses, ends = [], []
    step = trainer.train_step

    def recorded(state, batch):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return state, metrics

    trainer.train_step = recorded
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.monotonic()
    summary = trainer.fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(fa.LAUNCHES)
    loss = [float(x) for x in losses]
    step_ms = statistics.median(ends[i - 1].elapsed_time(ends[i])
                                for i in range(1, len(ends)))
    model = trainer.model
    tokens = trainer.global_batch * config.seq_len
    flops = lm_train_flops_per_token(
        hidden_dim=model.hidden_dim, depth=model.depth,
        mlp_dim=model.mlp_dim, vocab_size=model.vocab_size,
        seq_len=config.seq_len) * tokens
    peak = chip_peak_flops(torch.cuda.get_device_name(0))
    eval_batches = len(trainer.eval_loader)
    report = {
        "loss": loss, "step_ms": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "mfu": flops / (step_ms / 1e3) / peak if peak else None,
        "accuracy": summary["accuracy"],
        "perplexity": summary["perplexity"],
        "fit_tokens_per_s": summary["tokens_per_sec_per_chip"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches, "eval_batches": eval_batches, "wall_s": wall,
    }
    shown = [i for i in (1, 10, 20, 30) if i <= len(loss)]
    log(f"train[{label}] {config.model} {config.precision} "
        f"{config.optimizer}, seq {config.seq_len}, batch "
        f"{trainer.global_batch}, {steps} steps + {eval_batches} eval "
        f"batches, wall {wall:.1f} s: loss "
        + ", ".join(f"step {i} {loss[i - 1]:.4f}" for i in shown))
    mfu = "not measured" if peak is None else f"{report['mfu']:.4f}"
    log(f"  median step {step_ms:.2f} ms (CUDA events between step ends), "
        f"{report['tokens_per_s']:.0f} tokens/s, MFU {mfu} against "
        f"{(peak or 0) / 1e12:.1f} TFLOP/s ({flops / 1e12:.2f} TFLOP/step "
        f"analytic); "
        f"fit's own {report['fit_tokens_per_s']:.0f} tokens/s incl. the "
        f"first steps; eval accuracy {report['accuracy']:.4f} perplexity "
        f"{report['perplexity']:.3f}; peak memory "
        f"{report['peak_gib']:.2f} GiB; launches {launches}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"train[{label}]: loss did not fall: {loss}")
    want = {n: 0 for n in fa.LAUNCHES}
    want[f"flash_fwd_{row}"] = model.depth * (steps + eval_batches)
    want[f"flash_bwd_{row}"] = model.depth * steps
    if launches != want:
        raise AssertionError(f"train[{label}]: launches {launches}, want "
                             f"{want}")
    return trainer, report


def _model_step(torch, fa, *, precision, attn_impl, impl, seq):
    """One train step's loss and parameter grads of lm_base at depth 2,
    b=2, from seed 3, with every flash entry forced to `impl`."""
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops.losses import cross_entropy

    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 64, (2, seq + 1), generator=g).cuda()
    model = create_model("lm_base", device="cuda", seed=3, depth=2,
                         max_len=seq, vocab_size=64, attn_impl=attn_impl,
                         policy=PrecisionPolicy.from_name(precision))
    fa.reset_launches()
    with fa.forced_impl(impl):
        loss = cross_entropy(model(tokens[:, :-1], train=True),
                             tokens[:, 1:])
        loss.backward()
    torch.cuda.synchronize()
    want = 2 if impl == "kernel" else 0
    if (fa.LAUNCHES["flash_fwd_packed"], fa.LAUNCHES["flash_bwd_packed"]) \
            != (want, want):
        raise AssertionError(f"cross-check {precision} {impl}: launches "
                             f"{fa.LAUNCHES}")
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    del model
    return float(loss.detach()), grads


def train_cross_check(torch, fa):
    """One lm_base train step at depth 2, b=2, with the kernels against
    the same step without them. fp32 at s=512: the kernels, the plain
    versions and attn_impl="xla" give one loss (1e-5) and grads (1e-4
    absolute and relative). bf16 at s=2048 (the tensor-core kernels at
    the training length): the kernels and the plain versions give one
    loss (1e-3 relative) and grads whose error norm stays under
    MODEL_BF16_REL of each grad's norm."""
    runs = {impl: _model_step(torch, fa, precision="fp32", attn_impl=attn,
                              impl=impl, seq=512)
            for attn, impl in (("flash", "kernel"), ("flash", "plain"),
                               ("xla", "auto"))}
    want_loss, want = runs["kernel"]
    worst = 0.0
    for label in ("plain", "auto"):
        got_loss, got = runs[label]
        if abs(got_loss - want_loss) > 1e-5 * max(1.0, abs(want_loss)):
            raise AssertionError(f"cross-check: {label} loss {got_loss} vs "
                                 f"kernel {want_loss}")
        for name, gk in want.items():
            err = (got[name] - gk).abs()
            if (err > 1e-4 + 1e-4 * gk.abs()).any():
                raise AssertionError(f"cross-check: {label} grad {name} "
                                     f"max |err| {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
    log(f"cross-check fp32 (lm_base depth 2, s=512, b=2): loss kernel "
        f"{want_loss:.7f} plain {runs['plain'][0]:.7f} xla "
        f"{runs['auto'][0]:.7f}; grads agree, max |err| {worst:.2e}")
    del runs, want
    k_loss, k_grads = _model_step(torch, fa, precision="bf16",
                                  attn_impl="flash", impl="kernel", seq=2048)
    p_loss, p_grads = _model_step(torch, fa, precision="bf16",
                                  attn_impl="flash", impl="plain", seq=2048)
    if abs(k_loss - p_loss) > 1e-3 * abs(p_loss):
        raise AssertionError(f"cross-check bf16: kernel loss {k_loss} vs "
                             f"plain {p_loss}")
    rel = {n: float((k_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in p_grads.items()}
    worst_name = max(rel, key=rel.get)
    if rel[worst_name] > MODEL_BF16_REL:
        raise AssertionError(f"cross-check bf16: grad {worst_name} relative "
                             f"error norm {rel[worst_name]:.3e}")
    log(f"cross-check bf16 (lm_base depth 2, s=2048, b=2): loss kernel "
        f"{k_loss:.7f} plain {p_loss:.7f}; grads' relative error norm "
        f"median {statistics.median(rel.values()):.2e}, worst "
        f"{rel[worst_name]:.2e} ({worst_name})")
    torch.cuda.empty_cache()


def train_profile(torch, trainer):
    """One bf16 lm_base train step under torch.profiler, after warm
    steps: host wall per step (ends in a synchronize), device busy time,
    idle share, device ops per step, E/F/G's share of device time."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._to_device(next(iter(trainer.train_loader)))
    for _ in range(2):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == cuda]
    if not kernels:
        log(f"train profile: torch.profiler recorded no device events; "
            f"device time not measured (host wall {host_ms:.2f} ms/step)")
        return
    by_kind = {"E": 0.0, "F": 0.0, "G": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.name.lower()
        kind = ("E" if "flash_fwd" in name
                else "F" if "flash_bwd_dkdv" in name
                else "G" if "flash_bwd_dq" in name
                else "matmul" if any(t in name for t in (
                    "gemm", "cutlass", "xmma", "nvjet", "gemv"))
                else "other")
        by_kind[kind] += e.time_range.elapsed_us()
    device_ms = sum(by_kind.values()) / 1e3
    log(f"train profile (lm_base bf16 step, b=8, s=2048): host wall "
        f"{host_ms:.2f} ms/step, device busy {device_ms:.2f} ms/step, "
        f"device idle share {max(0.0, 1 - device_ms / host_ms):.3f}, "
        f"{len(kernels)} device ops/step; device time by kind "
        + ", ".join(f"{k} {v / 1e3 / device_ms:.3f}"
                    for k, v in by_kind.items()))
    per_name = {}
    for e in kernels:
        c, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
    for name, (c, us) in sorted(per_name.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        log(f"  {us / 1e3:9.3f} ms/step {c:4d} calls/step  {name[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from ddp_practice_tpu_torch.ops import cuda_build
    from ddp_practice_tpu_torch.ops import decode_attention as ops
    from ddp_practice_tpu_torch.ops import flash_attention as fa

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
    cuda_build.build(["decode_attention", "flash_attention"])
    log(f"built {SOURCE} (kernels A-D) and {FLASH_SOURCE} (E-G) for sm_90a "
        f"in {time.monotonic() - t0:.1f} s")
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
    log(f"kernel phase, flash attention (device times are medians of "
        f"{TIMED_RUNS}, plain of 5):")
    flash_rows = flash_kernel_phase(torch, F, fa, flush)
    del flush
    torch.cuda.empty_cache()

    trainer, train = train_phase(
        torch, fa, ["--synthetic_size", "600000"], steps=TRAIN_STEPS,
        label="learned", row="packed",
        metrics_file="build/train_metrics.jsonl")
    train_profile(torch, trainer)
    del trainer
    torch.cuda.empty_cache()
    train_phase(torch, fa, ["--pos_emb", "rope"], steps=10, label="rope",
                row="packed")
    _, folded = train_phase(torch, fa, ["--num_heads", "24"], steps=10,
                            label="24 heads of 32", row="folded")
    torch.cuda.empty_cache()
    train_cross_check(torch, fa)

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
        "flash_fwd_packed": train["launches"]["flash_fwd_packed"],
        "flash_bwd_packed": train["launches"]["flash_bwd_packed"],
        "flash_fwd_folded": folded["launches"]["flash_fwd_folded"],
        "flash_bwd_folded": folded["launches"]["flash_bwd_folded"],
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
    for name, row in flash_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    log(smi)   # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
