"""Ablations of the bf16 flash forward kernel E (csrc/flash_attention.cu,
section "kernel E, bf16") on the card.

    python -m ddp_practice_tpu_torch.experiments.flash_fwd_ablate
    python -m ddp_practice_tpu_torch.experiments.flash_fwd_ablate \
        --against OTHER/ddp_practice_tpu_torch/csrc/flash_attention.cu

Each variant is the shipped source with one design choice undone or moved
(`VARIANTS`: exact text substitutions, each of which must apply once). All
variants are built side by side with nvcc into build/ and timed against
the shipped kernel in turns, two rounds in opposite orders, at the three
bf16 causal shapes of chip_smoke.py's flash phase: lm_base packed (b=8,
h=12, s=2048, d=64), the folded leg (b=8, h=24, d=32) and b=1, s=8192
packed. Printed per variant: ptxas's registers and spills of E at every
head_dim; per shape: E launched alone (CUDA events around one launch
queued behind a spin kernel, L2 flushed first, median of 20; the mean of
the two rounds) and the relative error norm of the output against the
plain version.

`--against` builds another tree's source (a parent commit's) in place of
the variants and times its E against the shipped one the same way; then
it holds the two E's out and lse bit for bit at `BIT_SHAPES` (the flash
phase's shapes and strides of chip_smoke.py, and d = 128 and 256), and
fails if any bit differs.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from ddp_practice_tpu_torch.experiments.flash_bwd_ablate import device_ms
from ddp_practice_tpu_torch.experiments.flash_variants import (
    card_line, require_card,
)
from ddp_practice_tpu_torch.ops import cuda_build
from ddp_practice_tpu_torch.ops import flash_attention as fa

VARIANTS = {
    "shipped": (),
    # p and the rescale factor through the accurate expf of s - m
    "expf": (
        ("alpha[r] = exp2_approx((m_r[j][r] - mt[r]) * kLog2e);",
         "alpha[r] = expf(m_r[j][r] - mt[r]);"),
        ("exp2_approx(fmaf(s[j][n][i], kLog2e, -m2[i >> 1]));",
         "expf(s[j][n][i] - mt[i >> 1]);"),),
    # the mask evaluated on every tile, inside one copy of the loop
    "mask every tile": (
        ("    if (full)\n      to_p(std::false_type());\n    else\n"
         "      to_p(std::true_type());",
         "    to_p(std::true_type());"),),
    # one 16-row tile a warp at every head_dim (64-query blocks), four
    # blocks an SM at d <= 64 (a 128-register cap)
    "1 row tile/warp": (
        ("RT = D <= 64 ? 2 : 1;", "RT = 1;"),
        ("BLOCKS = D == 32 ? 3 : 2;", "BLOCKS = D <= 64 ? 4 : 2;")),
    # two blocks an SM at d=32 too (204 registers)
    "2 blocks/SM": (("BLOCKS = D == 32 ? 3 : 2;", "BLOCKS = 2;"),),
    # three blocks an SM at d=64 too (a 168-register cap: it spills)
    "3 blocks/SM": (
        ("BLOCKS = D == 32 ? 3 : 2;", "BLOCKS = D <= 64 ? 3 : 2;"),),
    # eight warps a block: twice the queries, half the K/V tiles streamed
    "8 warps": (("WARPS = 4;         // a block's warps",
                 "WARPS = 8;         // a block's warps"),
                ("BLOCKS = D == 32 ? 3 : 2;", "BLOCKS = 1;")),
}
SHAPES = [("lm_base packed", 8, 12, 2048, 64),
          ("folded 24 x 32", 8, 24, 2048, 32),
          ("b=1 s=8192", 1, 12, 8192, 64)]
# E's instantiations, as ptxas names them
E_KERNELS = [fa.fwd_kernel_name(d) for d in (32, 64, 128, 256)]
# (label, b, h, s, d, layout, dtype): E's bits against another tree's
BIT_SHAPES = [
    ("lm_base fused-qkv", 8, 12, 2048, 64, "qkv", torch.bfloat16),
    ("lm_base packed", 8, 12, 2048, 64, "packed", torch.bfloat16),
    ("b=1 s=8192", 1, 12, 8192, 64, "packed", torch.bfloat16),
    ("folded 24 x 32", 8, 24, 2048, 32, "folded", torch.bfloat16),
    ("d=128", 2, 4, 1000, 128, "packed", torch.bfloat16),
    ("d=256", 2, 4, 1000, 256, "packed", torch.bfloat16),
    ("fp32 fused-qkv s=512", 2, 12, 512, 64, "qkv", torch.float32),
    ("fp32 s=512 h=24 d=32", 2, 24, 512, 32, "folded", torch.float32),
]


def variant_source(name: str) -> str:
    source = (cuda_build.CSRC / "flash_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} is not in the "
                             f"source exactly once")
        source = source.replace(old, new)
    return source


def is_e(kernel: str) -> bool:
    """E at any head_dim, as ptxas names it (a tree from before the
    variants shared E's template names it flash_fwd_tc_kernel<d>)."""
    return kernel in E_KERNELS or bool(
        re.fullmatch(r"flash_fwd_tc_kernel<\d+>", kernel))


def build(sources: dict, show=is_e, where="flash_fwd_ablate") -> dict:
    """{name: loaded library} of {name: source text}, all nvcc processes
    at once into build/.../`where`; prints each one's ptxas lines for the
    kernels `show` picks (E at every head_dim)."""
    out = cuda_build.BUILD_DIR / where
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        src.write_text(text)
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
            if show(kernel):
                print(f"  {name:>16} {kernel}: " + "; ".join(
                    line.split(":", 1)[-1].strip() for line in lines))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def setup(b, h, s, d, seed=0):
    """E's launch arguments on (b, s, h, d) bf16 views, and the plain
    version's output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q4, k4, v4 = (torch.randn((b, s, h, d), generator=g, device="cuda")
                  .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    want, _ = fa.flash_attention_plain(q4, k4, v4, causal=True)
    return (q4, k4, v4, torch.empty_like(q4), True), want


def bit_inputs(b, h, s, d, layout, dtype, seed=1):
    """E's launch arguments at one of `BIT_SHAPES`: (b, h, s, d) views of
    the route's layout (fused-qkv: three column windows of one buffer)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "qkv":
        qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda")
        q4, k4, v4 = fa._operands4("qkv", (qkv.to(dtype),), h)
        out4 = torch.empty((b, s, h, d), dtype=dtype,
                           device="cuda").transpose(1, 2)
    elif layout == "packed":
        q4, k4, v4 = (torch.randn((b, s, h, d), generator=g, device="cuda")
                      .to(dtype).transpose(1, 2) for _ in range(3))
        out4 = torch.empty_like(q4)
    else:
        q4, k4, v4 = (torch.randn((b, h, s, d), generator=g, device="cuda")
                      .to(dtype) for _ in range(3))
        out4 = torch.empty_like(q4)
    return q4, k4, v4, out4, True


def same_bits(libs: dict) -> bool:
    """Each library's E against the first's at `BIT_SHAPES`: out and lse
    bit for bit; prints one line a shape and library."""
    saved = cuda_build._loaded.get("flash_attention")
    same = True
    try:
        for label, *shape in BIT_SHAPES:
            args = bit_inputs(*shape)
            results = {}
            for name, lib in libs.items():
                cuda_build._loaded["flash_attention"] = lib
                lse = fa._launch_fwd(*args)
                torch.cuda.synchronize()
                results[name] = (args[3].clone(), lse)
            (first, (out0, lse0)), *others = results.items()
            for name, (out, lse) in others:
                d_out = float((out.float() - out0.float()).abs().max())
                d_lse = float((lse - lse0).abs().max())
                equal = torch.equal(out, out0) and torch.equal(lse, lse0)
                same = same and equal
                print(f"  bits {label:>22}: {name} vs {first} "
                      + ("identical" if equal else
                         f"DIFFER (max |out| {d_out:.3e}, max |lse| "
                         f"{d_lse:.3e})"), flush=True)
    finally:
        if saved is None:
            cuda_build._loaded.pop("flash_attention", None)
        else:
            cuda_build._loaded["flash_attention"] = saved
    return same


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another tree's csrc/flash_attention.cu: time "
                             "and bit-compare its E instead of the variants")
    opts = parser.parse_args(argv)
    require_card("flash_fwd_ablate")
    print(f"card: {card_line()}", flush=True)
    if opts.against is None:
        sources = {name: variant_source(name) for name in VARIANTS}
    else:
        sources = {"shipped": variant_source("shipped"),
                   "against": opts.against.read_text()}
    libs = build(sources)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    saved = cuda_build._loaded.get("flash_attention")
    times = {}
    try:
        cases = [(label, *setup(b, h, s, d)) for label, b, h, s, d in SHAPES]
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                cuda_build._loaded["flash_attention"] = libs[name]
                for label, args, want in cases:
                    fa._launch_fwd(*args)
                    torch.cuda.synchronize()
                    got = args[3].float()
                    rel = float((got - want.float()).norm()
                                / want.float().norm())
                    ms = device_ms(lambda: fa._launch_fwd(*args), flush)
                    times.setdefault((name, label), []).append((ms, rel))
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
            ms = sum(r[0] for r in runs) / len(runs)
            rel = max(r[1] for r in runs)
            result[(name, label)] = (ms, rel)
            print(f"  {name:>16}: E {ms:.3f}  relative error norm "
                  f"{rel:.2e}")
    if opts.against is not None:
        ratio = (result[("shipped", SHAPES[0][0])][0]
                 / result[("against", SHAPES[0][0])][0])
        print(f"{SHAPES[0][0]}: shipped E / against E {ratio:.4f}")
        if not same_bits(libs):
            raise SystemExit("E's bits differ from the other tree's")
    return result


if __name__ == "__main__":
    main()
