"""Where does the non-product half of the flash forward go? Ablations on
the card at lm_base's attention shape (b*h = 96, s = 2048, d = 64, bf16;
counterpart of experiments/flash_ablate.py).

    python -m ddp_practice_tpu_torch.experiments.flash_ablate

  causal_v2      variant v2 as it is (mask, max, exp, sum);
  noncausal_v2   no mask and every tile visited: more product FLOPs, no
                 masking work;
  nomax          causal, with the running max removed (`nomax_call`:
                 UNSAFE numerics, p = exp(s) overflows once a score passes
                 ~88 — a cost probe only);
  library_flash  the library's flash attention (F.scaled_dot_product_
                 attention under SDPBackend.FLASH_ATTENTION) at the same
                 shape: the practical ceiling on this card, a yardstick the
                 port never calls.

Each row: ms a call (`flash_variants.timed`), executed TFLOP/s (the tiles
its own kernel visits, `fa.VARIANT_TILES`: 128 queries x 64 keys; the
library's own tiling is not known, so its row shows useful TFLOP/s only)
and useful TFLOP/s (half of s x s under causal masking), each against the
card's bf16 peak.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ddp_practice_tpu_torch.experiments.flash_variants import (
    BH, D, S, card_line, executed_fwd_flops, fwd_call, inputs, require_card,
    timed,
)
from ddp_practice_tpu_torch.ops import flash_attention as fa
from ddp_practice_tpu_torch.utils.flops import chip_peak_flops


def nomax_call(q, k, v, *, block_q=512, block_k=1024, impl="auto"):
    """The causal forward without a running max, over (bh, s, d): the
    output only. A cost probe: scores past ~88 overflow."""
    return fa.flash_forward_variant(q, k, v, variant="nomax", causal=True,
                                    block_q=block_q, block_k=block_k,
                                    impl=impl)[0]


def library_flash(q, k, v, *, heads=12):
    """The library's flash attention on the (bh, s, d) operands seen as
    (bh / heads, heads, s, d): the yardstick, causal."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    bh, s, d = q.shape
    q4, k4, v4 = (t.view(bh // heads, heads, s, d) for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    return out.view(bh, s, d)


@torch.no_grad()
def main() -> dict:
    require_card("flash_ablate")
    print(f"card: {card_line()}", flush=True)
    peak = chip_peak_flops(torch.cuda.get_device_name(0)) or float("nan")
    q, k, v = inputs()
    v2_tile = fa.VARIANT_TILES["v2"][1:]
    cases = [
        ("causal_v2", lambda q, k, v: fwd_call("v2", q, k, v),
         executed_fwd_flops(v2_tile)),
        ("noncausal_v2",
         lambda q, k, v: fwd_call("v2", q, k, v, causal=False),
         executed_fwd_flops(v2_tile, causal=False)),
        ("nomax", nomax_call,
         executed_fwd_flops(fa.VARIANT_TILES["nomax"][1:])),
        ("library_flash", library_flash, None),
    ]
    results = {}
    for name, fn, flops in cases:
        ms = timed(fn, (q, k, v))
        useful = BH * 2 * 2.0 * S * S * D * 0.5 / (ms / 1e3) / 1e12
        if flops is None:
            executed = "executed    n/a        "
        else:
            tflops = flops / (ms / 1e3) / 1e12
            executed = (f"executed {tflops:6.1f} TF/s "
                        f"({100 * tflops * 1e12 / peak:4.1f}%)")
        results[name] = ms
        print(f"fwd {name:22s}: {ms:7.3f} ms  {executed}  useful "
              f"{useful:5.1f} TF/s ({100 * useful * 1e12 / peak:.1f}%)",
              flush=True)
    return results


if __name__ == "__main__":
    main()
