"""The split plan of decode kernels A and C on the card: each shape's
device time under `_split_plan`'s (splits, chunk, span) and under the
other chunks it weighed, beside the plan's cost model (`_plan_cost`,
bytes an SM streams) and the bytes bound.

    python -m ddp_practice_tpu_torch.experiments.decode_split_tune

Shapes: lm_base's 12 heads of 64, bf16, every position valid: b = 1 over
2048 and 32768 positions, b = 8 over 2048 and 1025, and the serve shape
(b = 8, 321 positions); kernel C over 16-position pages at the same
per-slot capacities. Device time: median of 20 calls, each behind a spin
kernel with a cold L2 (experiments/flash_bwd_ablate.device_ms), beside
the harness's floor (a one-cycle spin timed the same way).
"""

from __future__ import annotations

import torch

from ddp_practice_tpu_torch.experiments.flash_bwd_ablate import device_ms
from ddp_practice_tpu_torch.experiments.flash_variants import (
    card_line, require_card,
)
from ddp_practice_tpu_torch.ops import decode_attention as ops
from ddp_practice_tpu_torch.utils.flops import chip_hbm_bandwidth

H, D, BS = 12, 64, 16
CASES = [(1, 2048), (1, 32768), (8, 2048), (8, 1025), (8, 321)]
CHUNKS = (64, 128, 192, 256, 320, 384, 416)


def _plans(n, b, bs=0):
    """The plan first, then each of CHUNKS with shared memory for the
    chunk alone (a range longer than a chunk always splits) and, where the
    plan's span is larger, for that span."""
    kw = dict(d=D, kv_bytes=2, quant=False, bs=bs)
    plan = ops._split_plan(n, b * H, **kw)
    out = [plan]
    for chunk in CHUNKS:
        for span in (chunk, max(chunk, plan[2])):
            alt = (-(-n // chunk), chunk, span)
            if (chunk < n and alt not in out
                    and ops._smem_bytes(span, **kw) <= ops._SPLIT_SMEM):
                out.append(alt)
    return out


def _flat(b, n, g):
    q = torch.randn((b, 1, H * D), generator=g, device="cuda").bfloat16()
    kc, vc = (torch.randn((b, n, H * D), generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    start = torch.zeros(b, dtype=torch.int32, device="cuda")
    want = ops.decode_attention_plain(q, kc, vc, n - 1, start, n_heads=H)
    return (lambda plan: ops._launch(q, kc, vc, n - 1, start, H, D, None,
                                     None, plan=plan)), want


def _paged(b, n, g):
    mb = -(-n // BS)
    q = torch.randn((b, 1, H * D), generator=g, device="cuda").bfloat16()
    kp, vp = (torch.randn((b * mb + 1, BS, H * D), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    table = (torch.randperm(b * mb, generator=g, device="cuda")
             .view(b, mb).int() + 1)
    lengths = torch.full((b,), n - 1, dtype=torch.int32, device="cuda")
    start = torch.zeros(b, dtype=torch.int32, device="cuda")
    want = ops.paged_decode_attention_plain(q, kp, vp, table, lengths, start,
                                            n_heads=H)
    return (lambda plan: ops._launch_paged(q, kp, vp, table, lengths, start,
                                           H, D, None, None,
                                           plan=plan)), want


def main() -> dict:
    require_card("decode_split_tune")
    print(f"card: {card_line()}", flush=True)
    hbm = chip_hbm_bandwidth(torch.cuda.get_device_name(0))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    floor = device_ms(lambda: torch.cuda._sleep(1), flush)
    print(f"timing floor (torch.cuda._sleep(1)): {floor * 1e3:.2f} us",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for kind, make in (("A", _flat), ("C", _paged)):
        for b, n in CASES:
            run, want = make(b, n, g)
            bound = 2 * b * n * H * D * 2 / hbm * 1e3 if hbm else float("nan")
            bs = BS if kind == "C" else 0
            cap = -(-n // BS) * BS if kind == "C" else n
            for i, plan in enumerate(_plans(cap, b, bs)):
                err = float((run(plan).float() - want.float()).abs().max())
                ms = device_ms(lambda: run(plan), flush)
                cost = ops._plan_cost(cap, b * H, plan[1], plan[2], d=D,
                                      kv_bytes=2, quant=False, bs=bs)
                results[(kind, b, n, plan)] = ms
                print(f"{kind} b={b} positions={n:5d} splits {plan[0]:3d} x "
                      f"{plan[1]:3d} span {plan[2]:3d}"
                      f"{' (plan)' if i == 0 else '':7s}: "
                      f"{ms * 1e3:8.2f} us  model {cost / 1024:7.0f} KB  "
                      f"bound {bound * 1e3:7.3f} us ({bound / ms:.2f})  err "
                      f"{err:.2e}", flush=True)
    return results


if __name__ == "__main__":
    main()
