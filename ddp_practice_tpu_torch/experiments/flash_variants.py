"""Flash-forward variant shootout on the card (counterpart of
experiments/flash_variants.py).

    python -m ddp_practice_tpu_torch.experiments.flash_variants

At lm_base's attention shape (b*h = 96, s = 2048, d = 64, causal, bf16):
each variant's max abs diff against v1, then its time a call and executed
TFLOP/s against the card's bf16 peak (utils/flops.chip_peak_flops).

  v1_E        kernel E (ops/flash_attention.py flash_attention_with_lse):
              q*scale rounded to bf16, fp32 softmax state;
  v2_bf16     E's staging with the scale on the fp32 scores;
  v3_sumfold  v2 with the softmax row sum folded into the P.V product
              through a ones column of V;
  v4_2head    v2 with two heads per block (what a block's fixed cost is);
  v5h2, v5h4  2 or 4 heads per block, V padded once outside with the ones
              column, exp2 with log2(e) folded into the scale.

The kernels are the compile-time variants of E in csrc/flash_attention.cu
(`flash_forward_variant`): E's body with one lever changed. They choose
their own tiles whatever block_q/block_k say (`fa.VARIANT_TILES`: E's
128 queries x 64 keys, 64 x 64 for v5h4), so the reference's block-size
rows (v5h2 at block_q 1024 or block_k 2048) are not repeated, and each
row's executed FLOPs count the tiles a causal pass of its own kernel
visits (`executed_fwd_flops`).

Timing (`timed`): chains of K1 = 4 and K2 = 16 calls, each output fed in
as the next q, between CUDA events; the best of 5 of each, and the slope
is the time a call without the chain's fixed cost. The reference fenced
its chains with a scalar readback because its TPU host's
block_until_ready did not fence; CUDA events do here.
"""

from __future__ import annotations

import subprocess

import torch

from ddp_practice_tpu_torch.ops import flash_attention as fa
from ddp_practice_tpu_torch.utils.flops import chip_peak_flops

BH, S, D = 96, 2048, 64        # lm_base: b = 8, h = 12
# (queries, keys) tiles of the kernels at d = 64: E's FwdTile<64>, which
# the one-head variants share, and F's and G's BwdTile<64>
E_TILE = fa.VARIANT_TILES["v2"][1:]
BWD_TILE = (64, 64)


def fwd_call(version, q, k, v, *, causal=True, block_q=512, block_k=1024,
             impl="auto"):
    """Variant v2, v3 or v4 over (bh, s, d): the output only."""
    return fa.flash_forward_variant(q, k, v, variant=version, causal=causal,
                                    block_q=block_q, block_k=block_k,
                                    impl=impl)[0]


def fwd_v5_call(q, k, v, *, causal=True, block_q=512, block_k=1024,
                n_heads=2, impl="auto"):
    """Variant v5 with `n_heads` (2 or 4) heads per block: the output."""
    return fa.flash_forward_variant(q, k, v, variant="v5", causal=causal,
                                    n_heads=n_heads, block_q=block_q,
                                    block_k=block_k, impl=impl)[0]


def visible_fraction(seq_q, seq_k, block_q, block_k, causal):
    """The share of (query block, key block) pairs a causal pass visits."""
    if not causal:
        return 1.0
    nq, nk = seq_q // block_q, seq_k // block_k
    offset = seq_k - seq_q
    vis = sum(
        1
        for qi in range(nq)
        for kj in range(nk)
        if qi * block_q + block_q - 1 + offset >= kj * block_k
    )
    return vis / (nq * nk)


def executed_fwd_flops(tile, causal=True):
    """The forward's dot FLOPs at (BH, S, D), 2 products of 2*s*s*d a
    head, over the (queries, keys) tiles of size `tile` that a pass
    visits."""
    return BH * 2 * 2.0 * S * S * D * visible_fraction(S, S, *tile, causal)


def timed(fn, args, K1=4, K2=16, reps=5):
    """Slope-fit device ms per call of fn(*args) -> tensor like args[0]."""

    def chain(K):
        x = args[0]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(K):
            x = fn(x, *args[1:])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    chain(K1)   # warm
    chain(K2)
    best = [min(chain(K) for _ in range(reps)) for K in (K1, K2)]
    return (best[1] - best[0]) / (K2 - K1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def inputs(shape=(BH, S, D), seed=0):
    """q, k, v: unit normals in bf16 on the card, from `seed`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda")
                 .to(torch.bfloat16) for _ in range(3))


def require_card(name: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: needs a CUDA device (it times kernels)")


def v1(q, k, v):
    return fa.flash_attention_with_lse(q, k, v, causal=True)[0]


@torch.no_grad()
def main() -> dict:
    require_card("flash_variants")
    print(f"card: {card_line()}", flush=True)
    peak = chip_peak_flops(torch.cuda.get_device_name(0))
    q, k, v = inputs()
    tiles = {name: tile[1:] for name, tile in fa.VARIANT_TILES.items()}

    ref = v1(q, k, v).float()
    errors = {}
    for name, fn in (("v2", lambda: fwd_call("v2", q, k, v)),
                     ("v3", lambda: fwd_call("v3", q, k, v)),
                     ("v4", lambda: fwd_call("v4", q, k, v)),
                     ("v5h2", lambda: fwd_v5_call(q, k, v, n_heads=2)),
                     ("v5h4", lambda: fwd_v5_call(q, k, v, n_heads=4))):
        errors[name] = float((fn().float() - ref).abs().max())
        print(f"{name} max abs diff vs v1: {errors[name]:.2e}", flush=True)

    cases = [
        ("v1_E", v1, E_TILE),
        ("v2_bf16", lambda q, k, v: fwd_call("v2", q, k, v), tiles["v2"]),
        ("v3_sumfold", lambda q, k, v: fwd_call("v3", q, k, v),
         tiles["v3"]),
        ("v4_2head", lambda q, k, v: fwd_call("v4", q, k, v), tiles["v4"]),
        ("v5h2", lambda q, k, v: fwd_v5_call(q, k, v, n_heads=2),
         tiles["v5h2"]),
        ("v5h4", lambda q, k, v: fwd_v5_call(q, k, v, n_heads=4),
         tiles["v5h4"]),
    ]
    results = {}
    for name, fn, tile in cases:
        ms = timed(fn, (q, k, v))
        tflops = executed_fwd_flops(tile) / (ms / 1e3) / 1e12
        results[name] = (ms, tflops)
        share = (f"{100 * tflops * 1e12 / peak:.1f}% of bf16 peak"
                 if peak else "peak unknown")
        print(f"fwd {name:14s}: {ms:7.3f} ms  {tflops:6.1f} TFLOP/s "
              f"({share}, executed-dot basis)", flush=True)
    return {"errors": errors, "ms": {n: r[0] for n, r in results.items()}}


if __name__ == "__main__":
    main()
