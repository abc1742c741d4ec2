"""Benchmark harness: steady-state training throughput and MFU, decode
throughput and MBU (counterpart of ddp_practice_tpu/benchmarks.py, with
the suite of the repo's root bench.py as its entry point).

    python -m ddp_practice_tpu_torch.benchmarks [--models convnet,lm_decode]

Methodology, the reference's, on one card:

- **Device-resident data.** `bench_train` keeps a pool of uint8 images
  and their labels on the device; every step gathers a batch from it by a
  (steps, batch) index grid drawn on the device and turns uint8 into
  [0, 1] floats there (train/steps.py `make_resident_train_step`).
  `bench_lm_train` keeps a token stream on the device and gathers windows
  from it (`make_resident_lm_train_step`): with `data="corpus"` the
  windows of the synthetic Markov corpus (data/lm_corpus.py), with
  `data="random"` windows at random starts of a stream of uniform random
  tokens drawn on the device (the reference draws fresh uniform tokens
  each step; both give uniform tokens).
- **K steps a call.** A call runs `steps_per_call` steps; on the card
  they are replays of one step captured as a CUDA graph (utils/graphs.py,
  the counterpart of the reference's `lax.scan` over K steps), on the CPU
  the same step eagerly.
- **Fenced timing.** Warm-up calls run first (the first call captures
  the graph); every timed window closes with a host readback of a scalar
  (the loss, a generated token), which waits for the whole chain.
  `bench_train` times two windows of `calls - calls // 2` and
  `calls // 2` calls and reports their disagreement, `window_spread_pct`.
- **Analytic FLOPs and bytes** (utils/flops.py): MFU against the card's
  dense bf16 peak, MBU against its memory rate.

The reports keep the reference's keys and rounding; `device_kind` holds
`torch.cuda.get_device_name()` ("cpu" on the CPU) and `n_chips` is 1 (one
process on one card). Every bench runs on the card unless `device="cpu"`.

`bench_lm_decode`'s `mbu_pct` counts every parameter once a decode step,
as the reference's formula does; for lm_moe that is every expert's
weights, while a routed step reads only the experts its tokens picked, so
its `mbu_pct` overstates the bytes a step reads. `bench_pipeline` is the
reference's GPipe vs 1F1B sweep over the microbatch count, its ranks
threads of this process (parallel/threads.py), and the suite's entries
the port cannot run yet (`NOT_RUNNABLE`) give a record that says why instead
of a result.

The suite writes every record to `build/benchmarks/suite.json`
(`suite.partial.json` for a subset or an override), or to `--out`, and
prints one JSON line per entry, then the compact line of the root
bench.py.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ddp_practice_tpu_torch.config import (
    PrecisionPolicy,
    TrainConfig,
    resolve_device,
)


def _device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _train_state(model, *, model_name, optimizer, learning_rate, device):
    from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer

    config = TrainConfig(model=model_name, optimizer=optimizer,
                         learning_rate=learning_rate, device=str(device))
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(config, model))


def bench_train(
    model_name: str,
    *,
    image_shape=(32, 32, 3),
    num_classes: int = 10,
    batch_size: int = 1024,
    steps_per_call: int = 32,
    calls: int = 8,
    warmup_calls: int = 2,
    precision: str = "bf16",
    pool_size: int = 8192,
    optimizer: str = "sgd",
    learning_rate: float = 1e-4,
    model_kwargs: Optional[dict] = None,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Steady-state training throughput of one image model on one card:
    images/sec, ms/step, and (on a card utils/flops knows) TFLOP/s and
    MFU against the dense bf16 peak."""
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.train.steps import make_resident_train_step
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        train_flops_per_image,
    )

    dev = resolve_device(device)
    model = create_model(
        model_name, policy=PrecisionPolicy.from_name(precision), device=dev,
        seed=seed, num_classes=num_classes, image_shape=tuple(image_shape),
        **(model_kwargs or {}))
    state = _train_state(model, model_name=model_name, optimizer=optimizer,
                         learning_rate=learning_rate, device=dev)
    # a uint8 pool on the device, labels beside it (synthetic: the bench
    # measures the compute rate, not convergence)
    host_rng = np.random.default_rng(seed)
    pool = {
        "image": torch.from_numpy(host_rng.integers(
            0, 256, size=(pool_size,) + tuple(image_shape),
            dtype=np.uint8)).to(dev),
        "label": torch.from_numpy(host_rng.integers(
            0, num_classes, size=(pool_size,), dtype=np.int32)).to(dev),
    }
    step = make_resident_train_step(model, seed=seed)
    draws = torch.Generator(device=dev).manual_seed(seed + 1)
    k_steps = steps_per_call

    def chunk():
        nonlocal state
        idx = torch.randint(0, pool_size, (k_steps, batch_size),
                            generator=draws, device=dev)
        state, metrics = step(state, pool, idx)
        return metrics

    # at least one: the timed calls capture nothing
    for _ in range(max(warmup_calls, 1)):
        metrics = chunk()
    float(metrics["loss"])                  # the fence

    # two fenced windows covering exactly `calls` calls: their agreement
    # is the run-to-run evidence; calls=1 runs one window and reports no
    # spread
    window_rates = []
    t0 = time.perf_counter()
    for wc in (calls - calls // 2, calls // 2):
        if wc == 0:
            continue
        tw = time.perf_counter()
        for _ in range(wc):
            metrics = chunk()
        final_loss = float(metrics["loss"])   # the fence closes the window
        window_rates.append(wc * k_steps * batch_size
                            / (time.perf_counter() - tw))
    dt = time.perf_counter() - t0

    n_chips = 1
    ips = calls * k_steps * batch_size / dt
    ips_chip = ips / n_chips
    spread_pct = (100.0 * abs(window_rates[0] - window_rates[-1])
                  / max(ips, 1e-9) if len(window_rates) > 1 else None)
    device_kind = _device_kind(dev)
    vit_kw = {}
    if model_name.startswith("vit"):
        # the built module's own dims, so the count matches what ran
        vit_kw = dict(patch_size=model.patch_size,
                      hidden_dim=model.hidden_dim, depth=model.depth,
                      mlp_dim=model.mlp_dim)
    flops_img = train_flops_per_image(model_name, tuple(image_shape),
                                      num_classes, **vit_kw)
    out = {
        "model": model_name,
        "image_shape": list(image_shape),
        "batch_size": batch_size,
        "steps_per_call": k_steps,
        "precision": precision,
        "device_kind": device_kind,
        "n_chips": n_chips,
        "images_per_sec": round(ips, 1),
        "images_per_sec_per_chip": round(ips_chip, 1),
        "ms_per_step": round(dt / (calls * k_steps) * 1e3, 3),
        "final_loss": round(final_loss, 4),
    }
    if spread_pct is not None:
        # the two fenced windows' disagreement, % of the mean rate
        out["window_spread_pct"] = round(spread_pct, 2)
    if flops_img:
        tflops_chip = ips_chip * flops_img / 1e12
        out["train_flops_per_image"] = flops_img
        out["tflops_per_chip"] = round(tflops_chip, 2)
        peak = chip_peak_flops(device_kind)
        if peak:
            out["mfu_pct"] = round(100.0 * tflops_chip * 1e12 / peak, 2)
            out["peak_bf16_tflops"] = peak / 1e12
    return out


def bench_lm_train(
    model_name: str = "lm_base",
    *,
    seq_len: int = 2048,
    vocab_size: int = 32768,
    batch_size: int = 8,
    steps_per_call: int = 4,
    calls: int = 4,
    warmup_calls: int = 1,
    precision: str = "bf16",
    attn_impl: str = "flash",
    optimizer: str = "adamw",
    learning_rate: float = 3e-4,
    model_kwargs: Optional[dict] = None,
    seed: int = 0,
    # "random": uniform tokens (a compute-rate measurement); "corpus": the
    # synthetic Markov corpus's windows, whose vocabulary replaces
    # vocab_size (router health is a property of trained routing: the MoE
    # entries bench on the corpus, as the reference's)
    data: str = "random",
    device="cuda",
) -> dict:
    """Steady-state LM training throughput: tokens/sec and MFU over the
    analytic FLOPs, with lm_moe's router health from the last step."""
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.train.steps import (
        make_resident_lm_train_step,
    )
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        lm_train_flops_per_token,
    )

    dev = resolve_device(device)
    window = seq_len + 1
    if data == "corpus":
        from ddp_practice_tpu_torch.data.lm_corpus import (
            synthetic_token_corpus,
        )

        c = synthetic_token_corpus(n_tokens=1 << 20, seed=seed + 7)
        vocab_size = c.vocab_size
        windows = c.windows(seq_len)
        stream = torch.from_numpy(windows.reshape(-1)).to(dev)
        n_windows = windows.shape[0]
    elif data != "random":
        raise ValueError(f"unknown data source {data!r}")
    kwargs = dict(vocab_size=vocab_size, max_len=seq_len,
                  attn_impl=attn_impl)
    kwargs.update(model_kwargs or {})
    model = create_model(model_name,
                         policy=PrecisionPolicy.from_name(precision),
                         device=dev, seed=seed, **kwargs)
    state = _train_state(model, model_name=model_name, optimizer=optimizer,
                         learning_rate=learning_rate, device=dev)
    draws = torch.Generator(device=dev).manual_seed(seed + 1)
    if data == "random":
        n_tokens = max(1 << 22, 16 * batch_size * window)
        stream = torch.randint(0, vocab_size, (n_tokens,), generator=draws,
                               device=dev, dtype=torch.int32)
    # loss-only metrics: the accuracy argmax is a whole extra pass over
    # the logits that the reference's train loop never makes
    step = make_resident_lm_train_step(model, window=window, seed=seed,
                                       with_accuracy=False)
    data_ = {"tokens": stream}
    k_steps = steps_per_call

    def chunk():
        nonlocal state
        if data == "corpus":
            starts = torch.randint(0, n_windows, (k_steps, batch_size),
                                   generator=draws, device=dev) * window
        else:
            starts = torch.randint(0, stream.numel() - window + 1,
                                   (k_steps, batch_size), generator=draws,
                                   device=dev)
        state, metrics = step(state, data_, starts)
        return metrics

    for _ in range(max(warmup_calls, 1)):
        metrics = chunk()
    float(metrics["loss"])

    t0 = time.perf_counter()
    for _ in range(calls):
        metrics = chunk()
    final_loss = float(metrics["loss"])
    dt = time.perf_counter() - t0

    n_chips = 1
    tps = calls * k_steps * batch_size * seq_len / dt
    tps_chip = tps / n_chips
    device_kind = _device_kind(dev)
    flops_tok = lm_train_flops_per_token(
        hidden_dim=model.hidden_dim, depth=model.depth,
        mlp_dim=model.mlp_dim, vocab_size=vocab_size, seq_len=seq_len,
        causal=True, moe_every=getattr(model, "moe_every", 0),
        moe_top_k=getattr(model, "moe_top_k", 2))
    out = {
        "model": model_name,
        "seq_len": seq_len,
        "vocab_size": vocab_size,
        "batch_size": batch_size,
        "steps_per_call": k_steps,
        "precision": precision,
        "attn_impl": attn_impl,
        "device_kind": device_kind,
        "n_chips": n_chips,
        "tokens_per_sec": round(tps, 1),
        "tokens_per_sec_per_chip": round(tps_chip, 1),
        "ms_per_step": round(dt / (calls * k_steps) * 1e3, 3),
        "final_loss": round(final_loss, 4),
        "train_flops_per_token": flops_tok,
    }
    tflops_chip = tps_chip * flops_tok / 1e12
    out["tflops_per_chip"] = round(tflops_chip, 2)
    peak = chip_peak_flops(device_kind)
    if peak:
        out["mfu_pct"] = round(100.0 * tflops_chip * 1e12 / peak, 2)
        out["peak_bf16_tflops"] = peak / 1e12
    # router health from the last step's metrics (lm_moe)
    for k in ("moe_drop_rate", "moe_load_max", "moe_load_min"):
        if k in metrics:
            out[k] = round(float(metrics[k]), 4)
    return out


def bench_lm_decode(
    model_name: str = "lm_base",
    *,
    prompt_len: int = 128,
    max_new_tokens: int = 512,
    batch_size: int = 8,
    vocab_size: int = 256,
    precision: str = "bf16",
    calls: int = 3,
    warmup_calls: int = 1,
    temperature: float = 1.0,
    top_k: int = 0,
    model_kwargs: Optional[dict] = None,
    seed: int = 0,
    # the dtype the parameters stream in during decode; None follows the
    # policy (bf16 compute -> bf16 parameters, inference needs no fp32
    # masters: inference.cast_params_for_streaming; fp32 -> fp32)
    stream_dtype: Optional[str] = None,
    # KV-cache storage: "policy" (the compute dtype) or "int8" (quantized
    # cache with per-(head, position) scales: kernel B)
    kv_cache: str = "policy",
    device="cuda",
) -> dict:
    """Autoregressive generation throughput: tokens/sec end to end
    (prefill included, what a caller of the generator sees), and per
    decode step (a prefill-only call timed apart and subtracted) the step
    time and the bandwidth use: `mbu_pct` the parameters' bytes a step,
    `mbu_total_pct` with the KV cache's bytes a step, over the card's
    memory rate. A configuration whose prefill would dominate is refused;
    a window the subtraction would leave under a fifth of the call is
    clamped there and flagged `decode_window_clamped`."""
    if prompt_len > max_new_tokens:
        raise ValueError(
            f"prompt_len {prompt_len} > max_new_tokens {max_new_tokens}: "
            "end-to-end tokens_per_sec would be prefill-dominated — "
            "generate more tokens")
    from ddp_practice_tpu_torch.inference import (
        cast_params_for_streaming,
        make_cache,
        make_generate_fn,
    )
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.utils.flops import chip_hbm_bandwidth

    dev = resolve_device(device)
    policy = PrecisionPolicy.from_name(precision)
    kwargs = dict(vocab_size=vocab_size,
                  max_len=prompt_len + max_new_tokens)
    if kv_cache == "int8":
        kwargs["kv_cache_dtype"] = "int8"
    elif kv_cache != "policy":
        raise ValueError(f"kv_cache {kv_cache!r} (want 'policy'|'int8')")
    kwargs.update(model_kwargs or {})
    model = create_model(model_name, policy=policy, device=dev, seed=seed,
                         **kwargs)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(
        rng.integers(0, vocab_size, (batch_size, prompt_len))).to(dev)
    if stream_dtype is None:
        stream_dtype = "bf16" if precision == "bf16" else "fp32"
    if stream_dtype not in ("bf16", "fp32"):
        raise ValueError(f"stream_dtype {stream_dtype!r} (want bf16|fp32)")
    param_bytes = 2 if stream_dtype == "bf16" else 4
    if stream_dtype == "bf16":
        cast_params_for_streaming(model)
    n_params = sum(p.numel() for p in model.parameters())
    gen = make_generate_fn(model, max_new_tokens=max_new_tokens,
                           temperature=temperature, top_k=top_k)

    def generator(i):
        if temperature == 0.0:
            return None
        return torch.Generator(device=dev).manual_seed(seed + 1 + i)

    for i in range(max(warmup_calls, 1)):
        tokens = gen(prompt, generator(i))
    int(tokens[0, -1])                          # the fence

    @torch.no_grad()
    def prefill_only():
        # gen()'s first leg: the cache allocation and the prompt pass
        cache = make_cache(model, batch_size, prompt_len + max_new_tokens)
        return model(prompt, cache=cache)[:, -1, 0]

    for _ in range(2):                          # a warm call first
        float(prefill_only()[0])
    t0 = time.perf_counter()
    for _ in range(calls):
        float(prefill_only()[0])
    prefill_dt = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(calls):
        tokens = gen(prompt, generator(100 + i))
        int(tokens[0, -1])                      # a fence every call
    dt = time.perf_counter() - t0
    # the decode-only window; guard the subtraction against timer noise
    # and say so when the floor engages
    decode_window_clamped = dt - prefill_dt < 0.2 * dt
    decode_dt = max(dt - prefill_dt, 0.2 * dt)
    if decode_window_clamped:
        print("[bench] decode window clamped to 20% of the call: prefill "
              f"timing ({prefill_dt:.3f}s) ate >80% of {dt:.3f}s — "
              "ms_per_token_step/mbu come from the floor, not the "
              "measurement", file=sys.stderr)

    n_chips = 1
    tps = calls * batch_size * max_new_tokens / dt
    steps_per_sec = calls * max_new_tokens / decode_dt
    device_kind = _device_kind(dev)
    out = {
        "model": model_name,
        "mode": "decode",
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "batch_size": batch_size,
        "vocab_size": vocab_size,
        "precision": precision,
        "stream_dtype": stream_dtype,
        "device_kind": device_kind,
        "n_chips": n_chips,
        "n_params": n_params,
        "tokens_per_sec": round(tps, 1),
        "tokens_per_sec_per_chip": round(tps / n_chips, 1),
        "ms_per_token_step": round(1e3 / steps_per_sec, 3),
        "seconds_per_call": round(dt / calls, 3),
        "prefill_ms_per_call": round(prefill_dt / calls * 1e3, 1),
        "kv_cache": "int8" if kv_cache == "int8" else policy.name,
    }
    if decode_window_clamped:
        out["decode_window_clamped"] = True
    bw = chip_hbm_bandwidth(device_kind)
    if bw:
        # mbu_pct: the parameters alone at the streamed dtype (every
        # parameter, every expert of a routed block included)
        bytes_per_sec = n_params * param_bytes * steps_per_sec
        out["mbu_pct"] = round(100.0 * bytes_per_sec / (bw * n_chips), 2)
        # mbu_total_pct: parameters + the KV bytes a step reads over the
        # allocated length (int8 adds its fp32 scale rows); the cache's
        # bytes follow the cache dtype, not stream_dtype
        L = prompt_len + max_new_tokens
        kv_elem = (1 if kv_cache == "int8" else
                   torch.empty((), dtype=policy.compute_dtype).element_size())
        kv_step = 2 * model.depth * L * model.hidden_dim * batch_size * kv_elem
        if kv_cache == "int8":
            kv_step += 2 * model.depth * model.num_heads * L * 4 * batch_size
        out["kv_bytes_per_step_mb"] = round(kv_step / 2**20, 1)
        out["mbu_total_pct"] = round(
            100.0 * (n_params * param_bytes + kv_step) * steps_per_sec
            / (bw * n_chips), 2)
        out["hbm_gbps"] = bw / 1e9
    return out


def bench_pipeline(
    *,
    num_stages: int = 4,
    microbatch_counts=(2, 4, 8),
    hidden_dim: int = 256,
    depth: int = 4,
    num_heads: int = 8,
    mlp_dim: int = 1024,
    vocab_size: int = 256,
    seq_len: int = 256,
    mb_rows: int = 4,
    fixed_global_batch: int = 0,
    steps: int = 5,
    warmup: int = 2,
    precision: str = "bf16",
    device="cuda",
) -> list:
    """The reference's pipeline schedule comparison, GPipe vs 1F1B over
    the microbatch count M, lm_pipe on a mesh of pipe = num_stages, the
    ranks threads of this process (on one card they share it), AdamW
    1e-3, the tokens drawn from seed 0.

    Per (schedule, M), the reference's keys: `ms_per_step`, rank 0's
    wall over `steps` timed steps, each fenced by a read of the loss;
    `temp_bytes`, here the card's peak allocated bytes over the timed
    steps (`torch.cuda.max_memory_allocated`, reset before them; None on
    the CPU), in place of XLA's temp-memory analysis. With the ranks as
    threads on one card that peak is the whole process's: every stage's
    parameters, optimizer state and activations summed. The default
    holds the rows of a microbatch fixed (the global batch grows with
    M), and `efficiency_pct` = slope * M / t(M), the slope from the two
    largest M of a schedule, as the reference's; `fixed_global_batch`
    holds the global batch instead (the memory-story mode: GPipe's
    stash of stage inputs grows with M, 1F1B's must not). The step times
    of ranks that share one card are not a pipeline's speed."""
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.parallel.mesh import build_mesh, parallelize
    from ddp_practice_tpu_torch.parallel.threads import run_ranks
    from ddp_practice_tpu_torch.train.steps import make_lm_train_step

    dev = resolve_device(device)
    policy = PrecisionPolicy.from_name(precision)
    results = []
    for schedule in ("gpipe", "1f1b"):
        for mb_count in microbatch_counts:
            if fixed_global_batch:
                if fixed_global_batch % mb_count:
                    raise ValueError(
                        f"fixed_global_batch {fixed_global_batch} not "
                        f"divisible by M = {mb_count}")
                b = fixed_global_batch
            else:
                b = mb_count * mb_rows
            tokens = torch.from_numpy(np.random.default_rng(0).integers(
                0, vocab_size, (b, seq_len + 1))).long()
            # the last configuration's models may sit in reference cycles:
            # free them before this one's peak is read
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

            def rank(r, mb_count=mb_count, tokens=tokens):
                import torch.distributed as tdist

                from ddp_practice_tpu_torch.config import MeshConfig

                mesh = build_mesh(MeshConfig(pipe=num_stages), dev.type)
                model = create_model(
                    "lm_pipe", policy=policy, device=dev,
                    vocab_size=vocab_size, max_len=seq_len,
                    hidden_dim=hidden_dim, depth=depth, num_heads=num_heads,
                    mlp_dim=mlp_dim, num_stages=num_stages,
                    num_microbatches=mb_count, schedule=schedule)
                forward, after = parallelize(model, mesh,
                                             model_name="lm_pipe",
                                             fsdp=False)
                state = _train_state(model, model_name="lm_pipe",
                                     optimizer="adamw", learning_rate=1e-3,
                                     device=dev)
                step = make_lm_train_step(model, forward=forward,
                                          after_backward=after)
                batch = {"tokens": tokens.to(dev)}
                for _ in range(max(warmup, 1)):
                    state, metrics = step(state, batch)
                float(metrics["loss"])
                tdist.barrier()
                cuda = dev.type == "cuda"
                if cuda and r == 0:
                    torch.cuda.reset_peak_memory_stats(dev)
                tdist.barrier()
                t0 = time.perf_counter()
                for _ in range(max(steps, 1)):
                    state, metrics = step(state, batch)
                    loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                tdist.barrier()
                peak = (torch.cuda.max_memory_allocated(dev)
                        if cuda else None)
                return dt, loss, peak

            dt, loss, peak = run_ranks(rank, num_stages, timeout=1200)[0]
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            results.append({
                "schedule": schedule,
                "num_stages": num_stages,
                "microbatches": mb_count,
                "global_batch": b,
                "seq_len": seq_len,
                "ms_per_step": round(dt / max(steps, 1) * 1e3, 1),
                "temp_bytes": peak,
                "loss": round(loss, 4),
            })
    if fixed_global_batch:
        return results
    for schedule in ("gpipe", "1f1b"):
        rs = sorted((r for r in results if r["schedule"] == schedule),
                    key=lambda r: r["microbatches"])
        if len(rs) >= 2:
            a, bb = rs[-2], rs[-1]
            slope = (bb["ms_per_step"] - a["ms_per_step"]) / (
                bb["microbatches"] - a["microbatches"])
            for r in rs:
                if slope > 0:
                    r["efficiency_pct"] = round(
                        100.0 * slope * r["microbatches"] / r["ms_per_step"],
                        1)
    return results


def bench_serve(**kwargs) -> dict:
    """Continuous-batching vs static-batch serving on one Poisson trace:
    serve/bench.py `serve_bench`, which owns its methodology."""
    from ddp_practice_tpu_torch.serve.bench import serve_bench

    return serve_bench(**kwargs)


# ------------------------------------------------------------------ suite
# the reference ConvNet's rate (its README, 60000 images x 3 epochs in
# 22.72 s including eval): the denominator of the root bench.py's
# vs_baseline
REFERENCE_IMAGES_PER_SEC = 60000 * 3 / 22.72

# the root bench.py's suite (its entry names and configurations): (name,
# kwargs); "kind" picks the bench (image by default)
_LM_BASE_MOE = {"hidden_dim": 768, "depth": 12, "num_heads": 12,
                "mlp_dim": 3072, "moe_every": 2, "num_experts": 8,
                "moe_group_size": 256}
_SUITE = {
    # vit_tiny's default path: fused="auto" takes the fused encoder-layer
    # kernels (H, I) on one card
    "vit_tiny": dict(
        image_shape=(32, 32, 3), batch_size=1024, steps_per_call=32,
        calls=8),
    # the per-op path
    "vit_tiny_unfused": dict(
        model="vit_tiny", image_shape=(32, 32, 3), batch_size=1024,
        steps_per_call=32, calls=8, model_kwargs={"fused": False}),
    # the fused layer forced (raises if the kernels cannot run)
    "vit_tiny_fused": dict(
        model="vit_tiny", image_shape=(32, 32, 3), batch_size=1024,
        steps_per_call=32, calls=8, model_kwargs={"fused": True}),
    "vit_base": dict(
        image_shape=(32, 32, 3), batch_size=192, steps_per_call=8,
        calls=24),
    # the vs_baseline entry: long windows for a ~0.5 ms step
    "convnet": dict(
        image_shape=(28, 28, 1), batch_size=32, steps_per_call=512,
        calls=32, warmup_calls=4, pool_size=4096),
    "resnet18": dict(
        image_shape=(32, 32, 3), batch_size=512, steps_per_call=16,
        calls=16),
    "resnet50": dict(
        image_shape=(224, 224, 3), num_classes=1000, batch_size=128,
        steps_per_call=8, calls=12, pool_size=512),
    # LM training (kind "lm": bench_lm_train), causal flash attention;
    # the longer lengths are opt-in (--models lm_8k, ...)
    "lm_long": dict(
        kind="lm", seq_len=2048, batch_size=8, steps_per_call=8, calls=6),
    # lm_moe at lm_base widths under expert choice (cf 1.0, groups of 256)
    "lm_moe": dict(
        kind="lm", model="lm_moe", seq_len=2048, batch_size=8,
        steps_per_call=4, calls=4, warmup_calls=10, data="corpus",
        model_kwargs={**_LM_BASE_MOE, "capacity_factor": 1.0,
                      "moe_router": "expert_choice"}),
    # token choice (top-2, cf 1.5, strided groups of 256): tokens/s, MFU
    # over active FLOPs and the warm router's health
    "lm_moe_tc": dict(
        kind="lm", model="lm_moe", seq_len=2048, batch_size=8,
        steps_per_call=4, calls=4, warmup_calls=10, data="corpus",
        model_kwargs={**_LM_BASE_MOE, "capacity_factor": 1.5}),
    # lm_tiny with 4 heads of 64 through the fused layer, forced
    "lm_tiny_fused": dict(
        kind="lm", model="lm_tiny", seq_len=256, batch_size=256,
        steps_per_call=16, calls=12, warmup_calls=4, attn_impl="xla",
        data="corpus", model_kwargs={"num_heads": 4, "fused": True}),
    "lm_8k": dict(
        kind="lm", seq_len=8192, batch_size=2, steps_per_call=2, calls=3),
    "lm_16k": dict(
        kind="lm", seq_len=16384, batch_size=1, steps_per_call=2, calls=3),
    "lm_32k": dict(
        kind="lm", seq_len=32768, batch_size=1, steps_per_call=1, calls=2,
        model_kwargs={"remat": True}),
    # generation (kind "decode": bench_lm_decode): tokens/s and MBU
    "lm_decode": dict(
        kind="decode", prompt_len=128, max_new_tokens=512, batch_size=8,
        calls=3),
    "lm_decode_bs1": dict(
        kind="decode", prompt_len=128, max_new_tokens=512, batch_size=1,
        calls=3),
    # the int8 KV cache at 1024 positions (kernel B)
    "lm_decode_1k": dict(
        kind="decode", prompt_len=256, max_new_tokens=768, batch_size=8,
        calls=3, kv_cache="int8"),
}
# entries the port cannot run yet -> why, and the ROADMAP item
NOT_RUNNABLE = {
    "lm_tiny_fused": "the fused encoder layer's kernels (H, I) take no "
                     "256-position sequence yet: its fp32 staging tile "
                     "outgrows an SM's shared memory (ROADMAP B, item 3, "
                     "'H, the rest')",
}
DEFAULT_MODELS = ("vit_base,vit_tiny,vit_tiny_unfused,vit_tiny_fused,"
                  "convnet,resnet18,resnet50,lm_long,lm_moe,lm_moe_tc,"
                  "lm_tiny_fused,lm_decode,lm_decode_bs1,lm_decode_1k")


def run_entry(name: str, kw: dict, *, device="cuda") -> dict:
    """One suite entry through its bench; the record's `model` is the
    entry's name."""
    kw = dict(kw)
    kind = kw.pop("kind", "image")
    if kind == "lm":
        r = bench_lm_train(kw.pop("model", "lm_base"), device=device, **kw)
    elif kind == "decode":
        r = bench_lm_decode("lm_base", device=device, **kw)
    else:
        r = bench_train(kw.pop("model", name), device=device, **kw)
    r["model"] = name
    return r


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "ddp_practice_tpu_torch.benchmarks",
        description="the benchmark suite on the card: one JSON line per "
                    "entry, then a compact line")
    p.add_argument("--models", default=DEFAULT_MODELS,
                   help="comma-separated; the first that runs is the "
                        "headline")
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--batch_size", type=int, default=0, help="override")
    p.add_argument("--steps_per_call", type=int, default=0, help="override")
    p.add_argument("--calls", type=int, default=0, help="override")
    p.add_argument("--out", default=None,
                   help="where the full suite goes (default "
                        "build/benchmarks/suite.json, suite.partial.json "
                        "for a subset or an override)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    names = [m.strip() for m in args.models.split(",") if m.strip()]
    unknown = [n for n in names if n not in _SUITE]
    if unknown:
        p.error(f"no bench config for {unknown}; known: {sorted(_SUITE)}")
    results, errors = [], []
    for name in names:
        kw = dict(_SUITE[name])
        kw["precision"] = args.precision
        if args.batch_size:
            if name.endswith("_bs1"):
                # the entry's name pins its batch size
                print(f"[bench] --batch_size ignored for {name}",
                      file=sys.stderr)
            else:
                kw["batch_size"] = args.batch_size
        if args.steps_per_call and kw.get("kind") != "decode":
            # decode has no steps a call
            kw["steps_per_call"] = args.steps_per_call
        if args.calls:
            kw["calls"] = args.calls
        if name in NOT_RUNNABLE:
            err = {"model": name,
                   "error": f"not runnable yet: {NOT_RUNNABLE[name]}"}
            errors.append(err)
            print(json.dumps(err), flush=True)
            continue
        try:
            r = run_entry(name, kw, device=args.device)
            results.append(r)
            print(json.dumps(r), flush=True)
        # one failed entry must not end the suite
        except Exception:  # noqa: BLE001
            err = {"model": name, "error": traceback.format_exc(limit=3)}
            errors.append(err)
            print(json.dumps(err), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    if not results:
        print(json.dumps({
            "metric": "bench failed", "value": 0.0,
            "unit": "images/sec/chip", "vs_baseline": 0.0,
            "n_errors": len(errors)}))
        return 1
    head = results[0]
    head_rate = head.get("images_per_sec_per_chip",
                         head.get("tokens_per_sec_per_chip", 0.0))
    head_unit = ("images/sec/chip" if "images_per_sec_per_chip" in head
                 else "tokens/sec/chip")
    convnet = next((r for r in results if r["model"] == "convnet"), None)
    if convnet:
        vs_baseline = round(convnet["images_per_sec_per_chip"]
                            / REFERENCE_IMAGES_PER_SEC, 3)
        vs_note = ("ratio of the ConvNet/MNIST entry to the reference's "
                   "~7,923 images/s")
    else:
        vs_baseline = round(head_rate / REFERENCE_IMAGES_PER_SEC, 3)
        vs_note = (f"CROSS-MODEL ratio: {head['model']} {head_unit} over "
                   "the reference ConvNet's ~7,923 images/s (no convnet "
                   "entry ran)")
    head_mode = "decode" if head.get("mode") == "decode" else "train"
    line = {
        "metric": (f"{head['model']} {head_mode} throughput "
                   f"(bs={head['batch_size']}, {head['precision']}, "
                   f"{head['n_chips']} chip(s), {head['device_kind']})"),
        "value": head_rate,
        "unit": head_unit,
        "vs_baseline": vs_baseline,
    }
    if "mfu_pct" in head:
        line["mfu_pct"] = head["mfu_pct"]
        line["tflops_per_chip"] = head["tflops_per_chip"]
    if "mbu_pct" in head:
        line["mbu_pct"] = head["mbu_pct"]
    if errors:
        line["n_errors"] = len(errors)
    partial = (args.models != p.get_default("models")
               or args.precision != p.get_default("precision")
               or bool(args.batch_size or args.steps_per_call
                       or args.calls))
    _write_suite({"headline": head, "results": results,
                  "vs_baseline": vs_baseline, "vs_baseline_note": vs_note,
                  "errors": errors},
                 args.out or os.path.join(
                     "build", "benchmarks",
                     "suite.partial.json" if partial else "suite.json"))
    print(json.dumps(line))
    return 0


def _write_suite(suite: dict, path: str) -> None:
    """The full suite to `path`; a failed write never loses the line."""
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(suite, f, indent=1)
        print(f"full suite -> {path}", file=sys.stderr)
    except OSError as e:
        print(f"could not write {path}: {e}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
