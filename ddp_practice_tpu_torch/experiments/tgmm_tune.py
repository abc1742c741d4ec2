"""Kernel K (the grouped weight-grad product tgmm, csrc/grouped_matmul.cu,
section "kernel K, bf16 (Hopper)") on the card: its work-unit size and
tile width, and ablations of its design.

    python -m ddp_practice_tpu_torch.experiments.tgmm_tune

Shapes: the lm_moe sorted path's two products (m = 32768 sorted rows, E = 8,
(kd, n) = (768, 3072) and (3072, 768)), balanced and skewed (groups of
16384 ... 256 rows), and the fused ViT-Tiny layer's four weight grads (one
group of 65536 tokens, fp32 output). bf16 operands from a seed.

Printed, each as ms a call (CUDA events around one call queued behind a
spin kernel, L2 flushed first, median of 20) with the relative error norm
against the plain version: `torch._grouped_mm` on the same groups (the
library's product; the port never calls it; for the one-group products
`torch.mm` of the transposed view, bf16 out), then K (its launch and its
second pass) at every unit size of `CHUNKS` and compiled tile width, and
then each variant of `VARIANTS` (exact text substitutions on the source,
each of which must apply once; built side by side with nvcc into build/)
at the shipped unit size and width. The two diagnostic variants compute
garbage on purpose: "no wgmma" times the copy ring alone, "no TMA" the
products alone (the ring's barriers still run), so that the kernel's time
can be set beside the time of its memory side and of its tensor-core side.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ddp_practice_tpu_torch.experiments.flash_bwd_ablate import device_ms
from ddp_practice_tpu_torch.experiments.flash_variants import (
    card_line, require_card,
)
from ddp_practice_tpu_torch.ops import cuda_build
from ddp_practice_tpu_torch.ops import grouped_matmul as gm

M, E = 32768, 8
CHUNKS = (2048, 4096, 8192, 16384)
PATTERNS = {"balanced": [M // E] * E,
            "skewed": [16384, 8192, 4096, 2048, 1024, 512, 256, 256]}
# the fused ViT-Tiny layer's weight grads: (name, kd, n) over 65536 tokens
VIT_TOKENS = 65536
VIT = (("dWqkv", 576, 192), ("dWproj", 192, 192), ("dW_in", 768, 192),
       ("dW_out", 192, 768))
_TILE = ("  const int i0 = (tile % k_tiles) * BM, "
         "n0 = (tile / k_tiles) * BN;\n")
VARIANTS = {
    "shipped": (),
    # the n tiles of a unit side by side instead of its kd tiles
    "n tile fastest": ((_TILE, "  const int nt_ = (n + BN - 1) / BN;\n"
                        "  const int i0 = (tile / nt_) * BM, "
                        "n0 = (tile % nt_) * BN;\n"),),
    # diagnostic: the ring runs, no product
    "no wgmma": (("      Wgmma<BN, 1, 1>::run(acc, da, db);\n",
                  "      (void)da; (void)db;\n"),),
    # diagnostic: lhs^T read as a K-major A (the wrong layout: garbage, at
    # the speed of J's A operand)
    "A K-major": (("      Wgmma<BN, 1, 1>::run(acc, da, db);\n",
                   "      Wgmma<BN, 0, 1>::run(acc, da, db);\n"),),
    # diagnostic: the products run on whatever the ring holds, no copy
    "no TMA": (("        mbar_expect_tx(&full[s], W::STAGE_BYTES);\n"
                "        uint8_t* sa = base + s * W::STAGE_BYTES;\n"
                "        uint8_t* sb = sa + W::A_BYTES;\n"
                "        const int r0 = int(lo + (long long)kt * BK);\n",
                "        mbar_arrive(&full[s]);\n"
                "        continue;\n"
                "        uint8_t* sa = base + s * W::STAGE_BYTES;\n"
                "        uint8_t* sb = sa + W::A_BYTES;\n"
                "        const int r0 = int(lo + (long long)kt * BK);\n"),),
}

VARIANTS["no TMA, A K-major"] = VARIANTS["no TMA"] + VARIANTS["A K-major"]


def variant_source(name: str) -> str:
    source = (cuda_build.CSRC / "grouped_matmul.cu").read_text()
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old!r} is not in the "
                             f"source exactly once")
        source = source.replace(old, new)
    return source


def build() -> dict:
    """{variant: loaded library}, all nvcc processes at once; prints each
    variant's ptxas line for K at tile width 256."""
    out = cuda_build.BUILD_DIR / "tgmm_tune"
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
            if kernel == "tgmm_wg_kernel<256, 0>":
                print(f"  {name:>16} {kernel}: " + "; ".join(
                    line.split(":", 1)[-1].strip() for line in lines))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _cases():
    """(label, lhs, g, group sizes, out dtype, library call or None)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    cases = []
    for pattern, sizes in PATTERNS.items():
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        for kd, n in ((768, 3072), (3072, 768)):
            if pattern == "skewed" and kd != 768:
                continue
            lhs, grad = randn(M, kd), randn(M, n)
            cases.append((f"{pattern} {kd}x{n}", lhs, grad, gs, None,
                          lambda a=lhs, b=grad, o=offs:
                          torch._grouped_mm(a.t(), b, offs=o)))
    # one unit: one group of TGMM_CHUNK rows, 72 blocks (< one wave)
    gs = torch.tensor([gm.TGMM_CHUNK], dtype=torch.int32, device="cuda")
    lhs, grad = randn(gm.TGMM_CHUNK, 768), randn(gm.TGMM_CHUNK, 3072)
    cases.append((f"one unit {gm.TGMM_CHUNK} 768x3072", lhs, grad, gs, None,
                  lambda a=lhs, b=grad: torch.mm(a.t(), b)))
    one = torch.full((1,), VIT_TOKENS, dtype=torch.int32, device="cuda")
    for name, kd, n in VIT:
        lhs, grad = randn(VIT_TOKENS, kd), randn(VIT_TOKENS, n)
        cases.append((f"vit {name} {kd}x{n}", lhs, grad, one, torch.float32,
                      lambda a=lhs, b=grad: torch.mm(a.t(), b)))
    return cases


def main() -> dict:
    require_card("tgmm_tune")
    print(f"card: {card_line()}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    result = {}

    def rel(got, want):
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    cases = _cases()
    for label, lhs, grad, gs, out_dtype, library in cases:
        want = gm.tgmm_plain(lhs, grad, gs, out_dtype=out_dtype)
        n = grad.shape[1]
        row = f"{label}: library {device_ms(library, flush):.3f}"
        for bn in gm.TGMM_BLOCK_N:
            if bn == 192 and n % 192:
                continue
            for chunk in (None,) + CHUNKS:
                def run(c=chunk, b=bn):
                    return gm._launch_tgmm(lhs, grad, gs, out_dtype,
                                           chunk=c, block_n=b)
                ms = device_ms(run, flush)
                result[(label, bn, chunk)] = (ms, rel(run(), want))
                row += f" | {bn} {chunk or 'auto'} {ms:.3f}"
        print(row + f"  (rel err <= "
              f"{max(v[1] for k, v in result.items() if k[0] == label):.1e})",
              flush=True)
    libs = build()
    saved = cuda_build._loaded.get("grouped_matmul")
    try:
        for name, lib in libs.items():
            cuda_build._loaded["grouped_matmul"] = lib
            row = f"variant {name:>16}:"
            for label, lhs, grad, gs, out_dtype, _ in cases:
                def run():
                    return gm._launch_tgmm(lhs, grad, gs, out_dtype)
                want = gm.tgmm_plain(lhs, grad, gs, out_dtype=out_dtype)
                ms = device_ms(run, flush)
                result[(label, name)] = (ms, rel(run(), want))
                row += f" | {label} {ms:.3f} ({result[(label, name)][1]:.0e})"
            print(row, flush=True)
    finally:
        if saved is None:
            cuda_build._loaded.pop("grouped_matmul", None)
        else:
            cuda_build._loaded["grouped_matmul"] = saved
    return result


if __name__ == "__main__":
    main()
