"""Time the flash kernels (forward; forward + backward) against the
library's flash attention at lm_base's attention shape by event slope
(counterpart of experiments/flash_time.py).

    python -m ddp_practice_tpu_torch.experiments.flash_time

`flash_variants.timed` over chains of 16 and 64 calls, the best of 5: E
forward, E + F + G (the gradient of q, as the reference takes it), and
the library's flash SDPA forward and forward + backward (a yardstick the
port never calls). Executed TFLOP/s as in flash_profile.
"""

from __future__ import annotations

import torch

from ddp_practice_tpu_torch.experiments.flash_ablate import library_flash
from ddp_practice_tpu_torch.experiments.flash_profile import fwd_bwd
from ddp_practice_tpu_torch.experiments.flash_variants import (
    BWD_TILE, E_TILE, card_line, executed_fwd_flops, inputs, require_card,
    timed, v1,
)
from ddp_practice_tpu_torch.utils.flops import chip_peak_flops


def main() -> dict:
    require_card("flash_time")
    print(f"card: {card_line()}", flush=True)
    peak = chip_peak_flops(torch.cuda.get_device_name(0)) or float("nan")
    q, k, v = inputs()
    fwd_fl = executed_fwd_flops(E_TILE)
    bwd_fl = 3.5 * executed_fwd_flops(BWD_TILE)   # 7 products, not 2
    results = {}
    for name, fn, fl in [
        ("ours fwd", v1, fwd_fl),
        ("library fwd", library_flash, fwd_fl),
        ("ours fwd+bwd", fwd_bwd(v1, argnums=(0,)), fwd_fl + bwd_fl),
        ("library fwd+bwd", fwd_bwd(library_flash, argnums=(0,)),
         fwd_fl + bwd_fl),
    ]:
        ms = timed(fn, (q, k, v), K1=16, K2=64)
        tf = fl / (ms / 1e3) / 1e12
        results[name] = ms
        print(f"{name:16s}: {ms:7.3f} ms   executed {tf:6.1f} TF/s"
              f"  ({100 * tf * 1e12 / peak:.1f}% of bf16 peak)", flush=True)
    return results


if __name__ == "__main__":
    main()
