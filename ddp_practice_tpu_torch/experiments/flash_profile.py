"""Trace-based timing of the flash kernels on the card (counterpart of
experiments/flash_profile.py).

    python -m ddp_practice_tpu_torch.experiments.flash_profile

Captures K = 32 chained iterations with utils/profiling and reads the
device time per iteration, and its top ops, back with utils/xprof
(`op_summary`): kernel E forward, E + F + G forward and backward, and the
library's flash attention forward and forward + backward (SDPBackend.
FLASH_ATTENTION, a yardstick the port never calls) at lm_base's attention
shape (b*h = 96, s = 2048, d = 64, causal, bf16). Executed TFLOP/s count
the tiles a causal pass of this repo's kernels visits (E's 128 x 64, F's
and G's 64 x 64): 2 products forward, 7 backward (F recomputes s and dp
for dK, dV; G recomputes them for dQ); the library rows use the same
count.
"""

from __future__ import annotations

import torch

from ddp_practice_tpu_torch.experiments.flash_4d import trace_chain
from ddp_practice_tpu_torch.experiments.flash_ablate import library_flash
from ddp_practice_tpu_torch.experiments.flash_variants import (
    BWD_TILE, E_TILE, card_line, executed_fwd_flops, inputs, require_card,
    v1,
)
from ddp_practice_tpu_torch.utils.flops import chip_peak_flops

K = 32


def fwd_bwd(forward, argnums=(0, 1, 2)):
    """One forward and backward of `forward`'s output sum; the grads of
    `argnums`, summed and clamped to [-1, 1], are the next carry (every
    kernel's result feeds it)."""

    def run(q, k, v):
        xs = [t.detach().requires_grad_(i in argnums)
              for i, t in enumerate((q, k, v))]
        with torch.enable_grad():
            out = forward(*xs)
            grads = torch.autograd.grad(out.sum(), [xs[i] for i in argnums])
        return torch.clamp(sum(g.float() for g in grads), -1.0,
                           1.0).to(q.dtype)

    return run


def device_ms(fn, args, label, k=K):
    """(device ms per iteration, {op name: ms}) of the top 6 ops."""
    s = trace_chain(fn, args, label, k)
    by_op = sorted(s["ops"].items(), key=lambda kv: -kv[1])[:6]
    return (s["total_ps"] / 1e9 / k,
            {nm: ps / 1e9 / k for (_, nm), ps in by_op})


def main() -> dict:
    require_card("flash_profile")
    print(f"card: {card_line()}", flush=True)
    peak = chip_peak_flops(torch.cuda.get_device_name(0)) or float("nan")
    q, k, v = inputs()
    fwd_fl = executed_fwd_flops(E_TILE)
    bwd_fl = 3.5 * executed_fwd_flops(BWD_TILE)   # 7 products, not 2
    results = {}
    for name, fn, fl in [
        ("ours fwd", v1, fwd_fl),
        ("ours fwd+bwd", fwd_bwd(v1), fwd_fl + bwd_fl),
        ("library fwd", library_flash, fwd_fl),
        ("library fwd+bwd", fwd_bwd(library_flash), fwd_fl + bwd_fl),
    ]:
        ms, detail = device_ms(fn, (q, k, v), name.replace(" ", "_")
                               .replace("+", "_"))
        tf = fl / (ms / 1e3) / 1e12
        results[name] = ms
        print(f"{name:16s}: {ms:7.3f} ms/iter  executed {tf:6.1f} TF/s"
              f"  ({100 * tf * 1e12 / peak:.1f}% of bf16 peak)", flush=True)
        for nm, m in detail.items():
            print(f"    {nm[:60]:60s} {m:7.3f} ms", flush=True)
    return results


if __name__ == "__main__":
    main()
