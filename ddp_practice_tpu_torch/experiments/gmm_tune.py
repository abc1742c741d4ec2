"""Microbenchmark of kernel J (the bf16 grouped matmul, csrc/grouped_matmul.cu)
at the lm_moe sorted-path shape, over the tile configurations J compiles
(counterpart of experiments/gmm_tune.py, which sweeps megablox gmm's
tilings on the TPU).

    python -m ddp_practice_tpu_torch.experiments.gmm_tune

m = 32768 sorted rows, k = 768, n = 3072, E = 8 balanced groups, bf16
operands from a seed. Printed, each as ms a call (CUDA events around one
call queued behind a spin kernel, L2 flushed first, median of 20) and
GFLOP/s over 2*m*k*n: the dense `torch.matmul` of the same flops (one
(m, k) x (k, n) product with an fp32 sum rounded to bf16, the reference's
yardstick), `torch._grouped_mm` on the same groups (the library's grouped
product; the port never calls it), and J at every tile width of
`GMM_BLOCK_N` with bf16 output and with fp32 output (the reference's
`preferred_element_type=float32` leg), each beside its relative error norm
against the plain version. Each J call counts in `LAUNCHES["gmm"]`.
"""

from __future__ import annotations

import torch

from ddp_practice_tpu_torch.experiments.flash_bwd_ablate import device_ms
from ddp_practice_tpu_torch.experiments.flash_variants import (
    card_line, require_card,
)
from ddp_practice_tpu_torch.ops import grouped_matmul as gm

M, K, N, E = 32768, 768, 3072, 8


def main() -> dict:
    require_card("gmm_tune")
    print(f"card: {card_line()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    lhs = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    rhs = (torch.randn((E, K, N), generator=g, device="cuda")
           * K ** -0.5).to(torch.bfloat16)
    sizes = torch.full((E,), M // E, dtype=torch.int32, device="cuda")
    flops = 2 * M * K * N
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    want = gm.gmm_plain(lhs, rhs, sizes, out_dtype=torch.float32)
    result = {}

    def report(name, ms, rel=None):
        result[name] = (ms, rel)
        err = "" if rel is None else f"  relative error norm {rel:.2e}"
        print(f"{name:<32} {ms:7.3f} ms  {flops / ms / 1e6:9.1f} GFLOP/s"
              + err, flush=True)

    report("dense torch.matmul", device_ms(
        lambda: torch.matmul(lhs, rhs[0]), flush))
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    report("torch._grouped_mm", device_ms(
        lambda: torch._grouped_mm(lhs, rhs, offs=offs), flush))
    for block_n in gm.GMM_BLOCK_N:
        for out_dtype in (torch.bfloat16, torch.float32):
            def run():
                return gm._launch_gmm(lhs, rhs, sizes, False,
                                      out_dtype=out_dtype, block_n=block_n)
            got = run().float()
            rel = float((got - want).norm() / want.norm())
            name = (f"J tile 128x{block_n}x64 "
                    f"{'fp32' if out_dtype == torch.float32 else 'bf16'} out")
            report(name, device_ms(run, flush), rel)
    return result


if __name__ == "__main__":
    main()
