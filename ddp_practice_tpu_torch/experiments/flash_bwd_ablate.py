"""Ablations of the bf16 flash backward kernels G and F
(csrc/flash_attention.cu, section "kernels F and G, bf16 (Hopper)") on
the card.

    python -m ddp_practice_tpu_torch.experiments.flash_bwd_ablate

Each variant is the shipped source with one design choice undone
(`VARIANTS`: exact text substitutions, each of which must apply once).
All variants are built side by side with nvcc into build/ and timed
against the shipped kernels in turns, two rounds in opposite orders, at
the three bf16 causal shapes of chip_smoke.py's flash phase: lm_base
packed (b=8, h=12, s=2048, d=64), the folded leg (b=8, h=24, d=32) and
b=1, s=8192 packed. Printed per variant: ptxas's registers and spills of
G and F at d = 32 and 64; per shape: G and F launched alone (CUDA events
around one launch queued behind a spin kernel, L2 flushed first, median
of 20; the mean of the two rounds) and the worst relative error norm of
dq, dk and dv against the plain version.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from ddp_practice_tpu_torch.experiments.flash_variants import (
    card_line, require_card,
)
from ddp_practice_tpu_torch.ops import cuda_build
from ddp_practice_tpu_torch.ops import flash_attention as fa

EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'


def _one_copy(kernel: str) -> tuple:
    """The elementwise loop's masked copy for every tile."""
    return (f"    if (full)\n      {kernel}(std::false_type());\n    else\n"
            f"      {kernel}(std::true_type());",
            f"    {kernel}(std::true_type());")


VARIANTS = {
    "shipped": (),
    # p through the accurate exp2f instead of ex2.approx
    "exp2f": ((EX2, "y = exp2f(x);"),),
    # the mask evaluated on every tile, inside one copy of the loop
    "mask every tile": (_one_copy("to_ds"), _one_copy("to_p_ds")),
    # F held to two blocks an SM at every head_dim (233 registers at 64)
    "F 2 blocks/SM": (
        ("F_BLOCKS = D == 32 ? 4 : D == 64 ? 3 : 2;", "F_BLOCKS = 2;"),),
    # G held to three blocks an SM at d <= 64 (164-166 registers)
    "G 3 blocks/SM": (
        ("G_BLOCKS = D <= 64 ? 4 : 1;", "G_BLOCKS = D <= 64 ? 3 : 1;"),),
}
SHAPES = [("lm_base packed", 8, 12, 2048, 64),
          ("folded 24 x 32", 8, 24, 2048, 32),
          ("b=1 s=8192", 1, 12, 8192, 64)]
RUNS = 20


def variant_source(name: str) -> str:
    source = (cuda_build.CSRC / "flash_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} is not in the "
                             f"source exactly once")
        source = source.replace(old, new)
    return source


def build() -> dict:
    """{variant: loaded library}, all nvcc processes at once; prints each
    variant's ptxas lines for the backward kernels at d = 32 and 64."""
    out = cuda_build.BUILD_DIR / "flash_bwd_ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(VARIANTS):
        src, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        src.write_text(variant_source(name))
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{err}")
        for kernel, lines in cuda_build.kernel_resources(err).items():
            if kernel.endswith(("_tc_kernel<32>", "_tc_kernel<64>")) and \
                    kernel.startswith("flash_bwd_"):
                print(f"  {name:>16} {kernel}: " + "; ".join(
                    line.split(":", 1)[-1].strip() for line in lines))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def device_ms(fn, flush) -> float:
    """One call's device time: median of RUNS, each behind a spin kernel
    with a cold L2."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(RUNS):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def setup(b, h, s, d, seed=0):
    """The backward's launch arguments on the forward's own residuals, and
    the plain version's dq, dk, dv."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q4, k4, v4, do4 = (torch.randn((b, s, h, d), generator=g, device="cuda")
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    out4 = torch.empty_like(q4)
    lse = fa._launch_fwd(q4, k4, v4, out4, True)
    want = fa.flash_attention_plain_bwd(q4, k4, v4, out4, do4, lse,
                                        causal=True)
    dq4, dk4, dv4 = (torch.empty_like(t) for t in (q4, k4, v4))
    args = (q4, k4, v4, out4, do4, lse, None, torch.empty_like(lse),
            torch.empty_like(q4, memory_format=torch.contiguous_format),
            dq4, dk4, dv4, True)
    return args, want


def main() -> dict:
    require_card("flash_bwd_ablate")
    print(f"card: {card_line()}", flush=True)
    libs = build()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    saved = cuda_build._loaded.get("flash_attention")
    times = {}
    try:
        cuda_build._loaded["flash_attention"] = libs["shipped"]
        cases = [(label, *setup(b, h, s, d)) for label, b, h, s, d in SHAPES]
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                cuda_build._loaded["flash_attention"] = libs[name]
                for label, args, want in cases:
                    fa._launch_dq(*args)
                    fa._launch_dkdv(*args)
                    torch.cuda.synchronize()
                    rel = max(float((got.float() - ref.float()).norm()
                                    / ref.float().norm())
                              for got, ref in zip(args[9:12], want))
                    ms_g = device_ms(lambda: fa._launch_dq(*args), flush)
                    ms_f = device_ms(lambda: fa._launch_dkdv(*args), flush)
                    times.setdefault((name, label), []).append(
                        (ms_g, ms_f, rel))
    finally:
        if saved is None:
            cuda_build._loaded.pop("flash_attention", None)
        else:
            cuda_build._loaded["flash_attention"] = saved
    result = {}
    for label, *_ in SHAPES:
        print(f"{label} (ms, mean of two rounds):")
        for name in libs:
            runs = times[(name, label)]
            ms_g = sum(r[0] for r in runs) / len(runs)
            ms_f = sum(r[1] for r in runs) / len(runs)
            rel = max(r[2] for r in runs)
            result[(name, label)] = (ms_g, ms_f, rel)
            print(f"  {name:>16}: G {ms_g:.3f}  F {ms_f:.3f}  G+F "
                  f"{ms_g + ms_f:.3f}  worst relative error norm {rel:.2e}")
    return result


if __name__ == "__main__":
    main()
