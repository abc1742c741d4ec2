"""The forward variants' own design choices undone one at a time, on the
card (csrc/flash_attention.cu, section "the forward variants (#12)").

    python -m ddp_practice_tpu_torch.experiments.flash_variant_levers

Each entry of `LEVERS` is the shipped source with one choice of the
variants' plan undone (exact text substitutions, each of which must apply
once). All are built side by side with nvcc into build/ and timed in
turns, two rounds in opposite orders, at lm_base's attention shape (b*h
96, s 2048, d 64, bf16, causal; v2 also non-causal): kernel E (folded, the
same operands) and each variant, one launch behind a spin kernel with a
cold L2, median of 20, the mean of the two rounds. Printed per entry:
ptxas's registers and spills of each variant kernel; per row: its time
and its ratio to E's under the same library.
"""

from __future__ import annotations

import torch

from ddp_practice_tpu_torch.experiments.flash_bwd_ablate import device_ms
from ddp_practice_tpu_torch.experiments.flash_fwd_ablate import build
from ddp_practice_tpu_torch.experiments.flash_variants import (
    card_line, inputs, require_card,
)
from ddp_practice_tpu_torch.ops import cuda_build
from ddp_practice_tpu_torch.ops import flash_attention as fa

LEVERS = {
    "shipped": (),
    # one block barrier for every head of a block, not one for each head
    "one block barrier": (
        ("  if constexpr (NH == 1)\n    __syncthreads();",
         "  if constexpr (true)\n    __syncthreads();"),),
    # v5h4's qs fragments held in registers (128 a thread), as E's
    "v5h4 qs in registers": (
        ("QREG = NH == 4 ? false : E::QREG;", "QREG = E::QREG;"),),
}
# (row, variant, heads a block, causal)
ROWS = [("v2", "v2", 1, True), ("v2 non-causal", "v2", 1, False),
        ("v3", "v3", 1, True), ("v4", "v4", 2, True),
        ("v5h2", "v5", 2, True), ("v5h4", "v5", 4, True),
        ("nomax", "nomax", 1, True)]


def lever_source(name: str) -> str:
    source = (cuda_build.CSRC / "flash_attention.cu").read_text()
    for old, new in LEVERS[name]:
        if source.count(old) != 1:
            raise ValueError(f"lever {name!r}: {old!r} is not in the source "
                             f"exactly once")
        source = source.replace(old, new)
    return source


def _is_variant(kernel: str) -> bool:
    return kernel.startswith("flash_fwd_tc_kernel<64, ") and not \
        kernel.endswith(f", {fa.E_KIND}>")


@torch.no_grad()
def main() -> dict:
    require_card("flash_variant_levers")
    print(f"card: {card_line()}", flush=True)
    libs = build({name: lever_source(name) for name in LEVERS},
                 show=_is_variant, where="flash_variant_levers")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    q, k, v = inputs()
    # (row, causal, one call)
    cases = [(f"E{'' if causal else ' non-causal'}", causal,
              lambda causal=causal: fa.flash_attention_with_lse(
                  q, k, v, causal=causal, impl="kernel"))
             for causal in (True, False)]
    cases += [(row, causal,
               lambda variant=variant, n_heads=n_heads, causal=causal:
               fa.flash_forward_variant(q, k, v, variant=variant,
                                        n_heads=n_heads, causal=causal,
                                        impl="kernel"))
              for row, variant, n_heads, causal in ROWS]
    saved = cuda_build._loaded.get("flash_attention")
    times = {}
    try:
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                cuda_build._loaded["flash_attention"] = libs[name]
                for row, _, call in cases:
                    times.setdefault((name, row), []).append(
                        device_ms(call, flush))
    finally:
        if saved is None:
            cuda_build._loaded.pop("flash_attention", None)
        else:
            cuda_build._loaded["flash_attention"] = saved
    result = {}
    for name in libs:
        print(f"{name} (ms, mean of two rounds; ratio to E):")
        for row, causal, _ in cases:
            ms = sum(times[(name, row)]) / 2
            e = sum(times[(name, "E" if causal else "E non-causal")]) / 2
            result[(name, row)] = ms
            print(f"  {row:>14}: {ms:.4f}  {ms / e:.3f}", flush=True)
    return result


if __name__ == "__main__":
    main()
