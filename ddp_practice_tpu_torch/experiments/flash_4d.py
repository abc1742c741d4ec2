"""Does kernel E reading (b, s, h, d) straight from the projection beat
the fold-and-transpose path? (Counterpart of experiments/flash_4d.py.)

    python -m ddp_practice_tpu_torch.experiments.flash_4d

The model boundary: q, k, v are (b, s, h*d) as the QKV projection makes
them, and the output must be (b, s, h*d); lm_base's shape, b = 8, s =
2048, h = 12, d = 64, causal, bf16.

  fold+transpose  permute to (b, h, s, d) and make it contiguous, run E on
                  the folded (b*h, s, d) copy, permute back and copy;
  4d-direct       `fwd4d`: `flash_attention` on the (b, s, h, d) view
                  itself, which runs E on its (batch, head, position)
                  strides with no copy (the reference needed a 4D grid for
                  this; E already takes the strides). lm_base's heads pack,
                  so the launch counts as `LAUNCHES["flash_fwd_packed"]`.

`device_ms` captures K = 24 chained calls with utils/profiling and reads
the device time back with utils/xprof.op_summary (the reference's method),
per call and per category.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import torch

from ddp_practice_tpu_torch.experiments.flash_variants import (
    card_line, require_card,
)
from ddp_practice_tpu_torch.ops import flash_attention as fa
from ddp_practice_tpu_torch.utils import profiling
from ddp_practice_tpu_torch.utils.xprof import op_summary

K = 24
B, S, H, D = 8, 2048, 12, 64
PROFILES = Path(__file__).resolve().parents[2] / "build" / "profiles"


def fwd4d(q, k, v, *, causal=True, block_q=512, block_k=1024, impl="auto"):
    """q, k, v: (b, s, h, d), no transpose: kernel E on their strides."""
    return fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                              block_k=block_k, impl=impl)


def path_fold(qf, kf, vf, *, heads=H):
    b, s, hd = qf.shape
    d = hd // heads
    q, k, v = (x.view(b, s, heads, d).permute(0, 2, 1, 3).contiguous()
               .view(b * heads, s, d) for x in (qf, kf, vf))
    o, _ = fa.flash_attention_with_lse(q, k, v, causal=True)
    return o.view(b, heads, s, d).permute(0, 2, 1, 3).reshape(b, s, hd)


def path_4d(qf, kf, vf, *, heads=H):
    b, s, hd = qf.shape
    q, k, v = (x.view(b, s, heads, hd // heads) for x in (qf, kf, vf))
    return fwd4d(q, k, v, causal=True).view(b, s, hd)


def trace_chain(fn, args, label, k=K) -> dict:
    """utils/xprof's summary of `k` chained calls of fn (each output the
    next first argument), captured with utils/profiling after one warm
    call; the trace is deleted once read."""
    fn(*args)   # warm
    PROFILES.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{label}_", dir=PROFILES)
    try:
        with profiling.profile_region(label, tmp):
            x = args[0]
            for _ in range(k):
                x = fn(x, *args[1:])
            torch.cuda.synchronize()
        return op_summary(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def device_ms(fn, args, k=K):
    """(device ms per call, {category: ms per call}) of fn over a chain of
    `k` calls, from a trace."""
    s = trace_chain(fn, args, "flash_4d", k)
    cats = {c: v["ps"] / 1e9 / k for c, v in s["categories"].items()}
    return s["total_ps"] / 1e9 / k, cats


@torch.no_grad()
def main() -> dict:
    require_card("flash_4d")
    print(f"card: {card_line()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    qf, kf, vf = (torch.randn((B, S, H * D), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    ref = path_fold(qf, kf, vf)
    got = path_4d(qf, kf, vf)
    err = float((ref.float() - got.float()).abs().max())
    print(f"max abs diff 4d vs fold: {err:.2e}", flush=True)
    results = {"err": err}
    for name, fn in (("fold+transpose", path_fold), ("4d-direct", path_4d)):
        ms, cats = device_ms(fn, (qf, kf, vf))
        results[name] = ms
        fmt = ", ".join(f"{c}: {v:.3f}" for c, v in sorted(
            cats.items(), key=lambda kv: -kv[1])[:4])
        print(f"{name:15s}: {ms:7.3f} ms/iter   [{fmt}]", flush=True)
    return results


if __name__ == "__main__":
    main()
