"""Profile the batched decode step: per-category device time of one
generate call (counterpart of experiments/decode_profile.py).

    python -m ddp_practice_tpu_torch.experiments.decode_profile \
        [--batch 8] [--new 64]

lm_base (d=768, depth 12, 12 heads of 64) under the bf16 policy with
RoPE, vocab 32768, max_len 1024, from a seeded random init with its
parameters cast to bf16 (the reference's `cast_params_for_streaming`: the
bf16 policy casts every weight on use, so the cast changes no value the
matmuls see); a 128-token prompt of ones and `--new` tokens sampled at
temperature 1 through `inference.make_generate_fn`. One warm call, one
untraced call for the host wall per token, then one call traced with
torch.profiler and summarised by utils/xprof: device ms per generated
token by category (kernel A is "decode A-D"), each category's share, the
top ops, and the device's idle share against the untraced wall. `device="cpu"` (the tests, lm_tiny) summarises the host's ops
instead: no device number comes from it.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ddp_practice_tpu_torch.config import PrecisionPolicy
from ddp_practice_tpu_torch.inference import make_generate_fn
from ddp_practice_tpu_torch.models import create_model
from ddp_practice_tpu_torch.utils import xprof


def main(batch: int = 8, new_tokens: int = 64, *, model_name="lm_base",
         device="cuda", prompt_len: int = 128, top: int = 12, **model_kw):
    model_kw = {"vocab_size": 32768, "max_len": 1024, **model_kw}
    model = create_model(model_name, policy=PrecisionPolicy.bf16(),
                         device=device, pos_emb="rope", **model_kw)
    model.to(torch.bfloat16).eval()
    dev = next(model.parameters()).device
    prompt = torch.ones((batch, prompt_len), dtype=torch.long, device=dev)
    gen = make_generate_fn(model, max_new_tokens=new_tokens,
                           temperature=1.0)
    g = torch.Generator(device=dev)

    def run():
        g.manual_seed(1)
        toks = gen(prompt, g)
        int(toks[0, -1])                 # the readback ends the call
        return toks

    run()                                # warm: builds and loads kernels
    t0 = time.perf_counter()
    run()                                # untraced: the host wall
    host_ms = (time.perf_counter() - t0) * 1e3
    on_card = dev.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        toks = run()
    if on_card:
        summary = xprof.op_summary_events(xprof.device_events(prof))
        where = torch.cuda.get_device_name(dev)
    else:
        summary = xprof.op_summary_events(
            [{"ph": "X", "cat": "cpu_op", "name": e.name,
              "dur": e.time_range.elapsed_us()} for e in prof.events()],
            device_substr="cpu")
        where = "cpu (host ops, nested ones counted again: no device time)"
    total = summary["total_ps"]
    shares = {cat: c["ps"] / total
              for cat, c in sorted(summary["categories"].items(),
                                   key=lambda kv: -kv[1]["ps"])}
    idle = (f", device idle share {max(0.0, 1 - total / 1e9 / host_ms):.3f}"
            if on_card else "")
    print(f"decode_profile on {where}: {model_name} bf16 rope, batch "
          f"{batch}, prompt {prompt_len} + {new_tokens} new tokens; host "
          f"wall {host_ms / new_tokens:.3f} ms/token, ops "
          f"{total / 1e9 / new_tokens:.3f} ms/token{idle}", flush=True)
    for cat, share in shares.items():
        c = summary["categories"][cat]
        print(f"  {share * 100:5.1f}%  {c['ps'] / 1e9 / new_tokens:8.4f} "
              f"ms/token  x{c['count'] / new_tokens:7.1f}/token  {cat}",
              flush=True)
    print(f"top {top} ops:", flush=True)
    for (cat, name), ps in sorted(summary["ops"].items(),
                                  key=lambda kv: -kv[1])[:top]:
        print(f"  {ps / 1e9 / new_tokens:8.4f} ms/token  [{cat[:18]}] "
              f"{name[:70]}", flush=True)
    return {"tokens": toks, "shares": shares, "host_ms": host_ms,
            "summary": summary}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--new", type=int, default=64)
    a = p.parse_args()
    main(a.batch, a.new)
    sys.exit(0)
