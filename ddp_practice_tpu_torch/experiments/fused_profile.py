"""Time kernels H and I (ops/fused_encoder.py) on the card, and show where
their time goes.

    python -m ddp_practice_tpu_torch.experiments.fused_profile
    python -m ddp_practice_tpu_torch.experiments.fused_profile --clocks
    python -m ddp_practice_tpu_torch.experiments.fused_profile --levers

Without flags: each shape's kernels against the plain version (relative
error norms), then the device time of one wrapper call (CUDA events,
median of 10, each call queued behind a spin kernel so the events bracket
device work) beside the host time of the call; kernel I also in its parts:
the per-sequence launch (with its vector-grad reduction) and the four
kernel K launches of its weight grads.

`--levers` measures the Hopper kernel H's design choices one at a time at
the ViT-Tiny and causal LM layers (bf16), each undone alone, timed in turns
on one card (shipped first and last): at run time the general kernel H it
replaced (`general=True`), one sequence a tile (`seqs=1`), two ring stages
(`stages=2`); as text substitutions on the source (`LEVERS`, each of which
must apply once; built side by side with nvcc into build/) 128-column MLP
chunks at every width, LN1's loads a row at a time (not 8 rows at once),
the GELU on tanhf (not 1 - 2 / (exp(2u) + 1) on the fast intrinsics), one
k slice a ring stage for the 64-wide MLP products (not three) and a
producer warp (288 threads, no setmaxnreg) in place of a producer
warpgroup.

`--clocks` stands in for a kernel profiler where none runs: it writes an
instrumented copy of csrc/fused_encoder.cu into build/ (every
`__syncthreads()`, and every named barrier `WG_BAR(...)` of the Hopper
kernel H, becomes a barrier that also adds block 0's `clock64()` delta
since the previous barrier into a `__device__` array indexed by source
line: thread 0's, which in the Hopper kernel is a consumer of the first
64-row group), builds it, runs the ViT-Tiny layer forward (the Hopper
kernel H, then the general kernel H it replaced in bf16) and backward and
prints microseconds per barrier interval: the time of the phase that ends
at that line. A counter starts at kernel entry, so the first interval
holds no gap between calls. The Hopper kernel's waits for a full ring
stage are also summed apart (they lie inside the intervals). Kernel I's
per-sequence launch is read; its kernel K launches carry no clocks. Clock
ticks are converted at 1.755 GHz (the H100 SXM's boost clock: nvidia-smi
reads the running clock).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import time

import torch

from ddp_practice_tpu_torch.ops import cuda_build
from ddp_practice_tpu_torch.ops import fused_encoder as fe

SHAPES = [  # imgs, s, d, heads, mlp, dtype, causal
    (1024, 64, 192, 3, 768, torch.bfloat16, False),
    (1, 64, 192, 3, 768, torch.bfloat16, False),
    (64, 128, 256, 4, 1024, torch.bfloat16, True),
    (1024, 64, 192, 3, 768, torch.float32, False),
]
CLOCK_HZ = 1.755e9
SLOTS = 4096   # source lines the counters cover
_CHUNK = "template <int DN> constexpr int kChunk = DN >= 192 ? 64 : 128;"
_REGS = ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n',
         '  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n')
# the Hopper kernel H's compile-time choices, each undone alone
LEVERS = {
    "MLP chunks of 128": ((_CHUNK, _CHUNK.replace("DN >= 192 ? 64 : 128",
                                                  "128")),),
    "LN1 a row at a time": (("constexpr int kLnRows = 8;",
                             "constexpr int kLnRows = 1;"),),
    "GELU on tanhf": (("constexpr bool kFastTanh = true;",
                       "constexpr bool kFastTanh = false;"),),
    "a slice a stage": (("constexpr bool kPackSlices = true;",
                         "constexpr bool kPackSlices = false;"),),
    "producer warp, 288 threads": (
        ("constexpr int kThreads = 384;", "constexpr int kThreads = 288;"),
        (_REGS[0], ""), (_REGS[1], "")),
}

_TICK = '''
__device__ long long g_ticks[4096];
__device__ int g_counts[4096];
__device__ long long g_last;
__device__ __forceinline__ void tick(int line) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long t = clock64();
    g_ticks[line] += t - g_last;
    g_counts[line] += 1;
    g_last = t;
  }
}
__device__ __forceinline__ void sync_tick(int line) {
  __syncthreads();
  tick(line);
}
__device__ __forceinline__ void wg_bar_tick(int line, int id, int threads) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
  tick(line);
}
// slot 0 (no source line): thread 0's waits for a full ring stage
__device__ __forceinline__ long long wait_start() { return clock64(); }
__device__ __forceinline__ void wait_end(long long t0) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    g_ticks[0] += clock64() - t0;
    g_counts[0] += 1;
  }
}
'''
_EXPORT = '''
extern "C" int fe_ticks(long long* ticks, int* counts, int reset) {
  if (reset) {
    static long long zeros[4096];
    cudaMemcpyToSymbol(g_ticks, zeros, sizeof(zeros));
    cudaMemcpyToSymbol(g_counts, zeros, sizeof(int) * 4096);
    return 0;
  }
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(ticks, g_ticks, sizeof(long long) * 4096);
  cudaMemcpyFromSymbol(counts, g_counts, sizeof(int) * 4096);
  return 0;
}
'''


def inputs(imgs, s, d, mlp, dtype, seed=1):
    """(x, cotangent, the layer's 12 leaves in `PARAM_NAMES` order) on the
    card from `seed`: weights of std 1/sqrt(fan_in), LayerNorm scales
    around one, biases around zero (none at its init value)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    shapes = ((d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
              (mlp, d), (mlp,), (d, mlp), (d,))
    params = [randn(*sh) / sh[1] ** 0.5 if len(sh) == 2
              else (1.0 if i in (0, 6) else 0.0) + 0.1 * randn(*sh)
              for i, sh in enumerate(shapes)]
    return randn(imgs, s, d).to(dtype), randn(imgs, s, d).to(dtype), params


def device_and_host_ms(fn, runs=10):
    fn()
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(runs):
        torch.cuda._sleep(8_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return (statistics.median(a.elapsed_time(b) for a, b in events),
            statistics.median(host) * 1e3)


def time_shapes() -> None:
    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    for imgs, s, d, heads, mlp, dtype, causal in SHAPES:
        x, g, params = inputs(imgs, s, d, mlp, dtype)
        kw = dict(num_heads=heads, compute_dtype=dtype, causal=causal)
        out = fe.fused_encoder_forward(x, params, impl="kernel", **kw)
        dx, grads = fe.fused_encoder_backward(x, g, params, impl="kernel",
                                              **kw)
        want_dx, want = fe.fused_encoder_backward_plain(x, g, params, **kw)
        errs = (rel(out, fe.fused_encoder_plain(x, params, **kw)),
                rel(dx, want_dx),
                max(rel(a, b) for a, b in zip(grads, want)))
        fwd = device_and_host_ms(lambda: fe.fused_encoder_forward(
            x, params, impl="kernel", **kw))
        bwd = device_and_host_ms(lambda: fe.fused_encoder_backward(
            x, g, params, impl="kernel", **kw))
        seq_ms = device_and_host_ms(lambda: fe._bwd_sequences(
            x, g, params, heads, dtype, causal))[0]
        _, _, ops, gt = fe._bwd_sequences(x, g, params, heads, dtype, causal)
        grads_ms = device_and_host_ms(lambda: fe._bwd_weight_grads(ops, gt))
        print(f"{imgs} x {s} x {d} heads {heads} mlp {mlp} "
              f"{str(dtype)[6:]} causal={causal}: relative error norms out "
              f"{errs[0]:.2e} dx {errs[1]:.2e} worst grad {errs[2]:.2e}; H "
              f"{fwd[0]:.3f} ms (host {fwd[1]:.3f}), I {bwd[0]:.3f} ms "
              f"(host {bwd[1]:.3f}): per-sequence launch {seq_ms:.3f}, 4 K "
              f"launches {grads_ms[0]:.3f}", flush=True)


def instrumented_source() -> str:
    src = (cuda_build.CSRC / "fused_encoder.cu").read_text()
    if src.count("\n") >= SLOTS - 200:
        raise ValueError(f"fused_encoder.cu has grown past the {SLOTS} "
                         f"source lines the clock counters cover")
    src = src.replace("namespace {\n", "namespace {\n" + _TICK, 1)
    head, tail = src.split(_TICK, 1)
    tail = tail.replace("__syncthreads();", "sync_tick(__LINE__);")
    tail = re.sub(r"(?<!#define )\bWG_BAR\(", "wg_bar_tick(__LINE__, ", tail)
    wait = "    mbar_wait(&full[s], (it / stages) & 1);\n"
    assert tail.count(wait) == 1
    tail = tail.replace(wait, "    const long long t0_ = wait_start();\n"
                        + wait + "    wait_end(t0_);\n")
    tail = re.sub(r"(  extern __shared__ uint8_t fe_wg_smem\[\];)",
                  r"\1\n  if (blockIdx.x == 0 && threadIdx.x == 0) g_last "
                  r"= clock64();", tail)
    tail = re.sub(r"(const Seq<T(, true)?> q\(p, fe_smem\);)",
                  r"\1\n  if (blockIdx.x == 0 && threadIdx.x == 0) g_last "
                  r"= clock64();", tail)
    return head + _TICK + tail + _EXPORT


def clocks() -> None:
    out_dir = cuda_build.BUILD_DIR / "fused_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = instrumented_source()
    (out_dir / "fused_encoder.cu").write_text(source)
    lines = source.splitlines()
    from ddp_practice_tpu_torch.ops import grouped_matmul as gm
    gm._library()                    # kernel K from the shipped source
    cuda_build.CSRC = out_dir        # this process builds the copy
    lib = fe._library()
    ticks = (ctypes.c_longlong * SLOTS)()
    counts = (ctypes.c_int * SLOTS)()
    imgs, s, d, heads, mlp, dtype, causal = SHAPES[0]
    x, g, params = inputs(imgs, s, d, mlp, dtype)
    kw = dict(num_heads=heads, compute_dtype=dtype, causal=causal)
    calls = 3
    for name, fn in (
            ("H (Hopper)", lambda: fe.fused_encoder_forward(
                x, params, impl="kernel", **kw)),
            ("H (general)", lambda: fe._launch_fwd(x, params, heads, dtype,
                                                   causal, general=True)),
            ("I", lambda: fe._bwd_sequences(x, g, params, heads, dtype,
                                            causal))):
        fn()
        lib.fe_ticks(ticks, counts, 1)
        for _ in range(calls):
            fn()
        lib.fe_ticks(ticks, counts, 0)
        us = [t / calls / CLOCK_HZ * 1e6 for t in ticks]
        print(f"kernel {name}, block 0, {imgs} x {s} x {d}: "
              f"{sum(us[1:]):.1f} us per call between barriers")
        if counts[0]:
            print(f"  of which waits for a full ring stage: {us[0]:.1f} us "
                  f"in {counts[0] // calls} waits")
        for line in range(1, SLOTS):
            if counts[line]:
                n = counts[line] // calls
                print(f"  line {line:4d} {us[line]:8.1f} us in {n:4d} "
                      f"intervals ({us[line] / n:6.2f} us each), ends after: "
                      f"{lines[line - 2].strip()[:60]}", flush=True)


def lever_source(name: str) -> str:
    source = (cuda_build.CSRC / "fused_encoder.cu").read_text()
    for old, new in LEVERS[name]:
        if source.count(old) != 1:
            raise ValueError(f"lever {name!r}: {old!r} is not in the source "
                             f"exactly once")
        source = source.replace(old, new)
    return source


def levers() -> None:
    out = cuda_build.BUILD_DIR / "fused_levers"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(LEVERS):
        src, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        src.write_text(lever_source(name))
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    shipped = fe._library()
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for lever {name!r}:\n{err}")
        for kernel, lines in cuda_build.kernel_resources(err).items():
            if kernel.startswith("fused_encoder_fwd_wg_kernel<"):
                print(f"  {name}: ptxas {kernel}: " + "; ".join(
                    line.split(":", 1)[-1].strip() for line in lines))
        libs[name] = ctypes.CDLL(str(lib))
    for imgs, s, d, heads, mlp, dtype, causal in SHAPES:
        if dtype != torch.bfloat16 or imgs < 64:
            continue
        x, _, params = inputs(imgs, s, d, mlp, dtype)
        want = fe.fused_encoder_plain(x, params, num_heads=heads,
                                      compute_dtype=dtype, causal=causal)

        def run(lib, **over):
            def call():
                cuda_build._loaded["fused_encoder"] = lib
                return fe._launch_fwd(x, params, heads, dtype, causal,
                                      **over)
            return call

        runs = [("shipped", run(shipped)),
                ("general kernel H", run(shipped, general=True)),
                ("one sequence a tile", run(shipped, seqs=1)),
                ("two ring stages", run(shipped, stages=2))]
        runs += [(name, run(lib)) for name, lib in libs.items()]
        runs.append(("shipped", run(shipped)))
        for name, fn in runs:
            got = fn()
            err = float((got.float() - want.float()).norm()
                        / want.float().norm())
            ms = device_and_host_ms(fn)[0]
            print(f"{imgs} x {s} x {d} causal={causal}: {name:>27} "
                  f"{ms:.3f} ms (relative error norm {err:.2e})", flush=True)
    cuda_build._loaded["fused_encoder"] = shipped


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--clocks", action="store_true",
                        help="per-barrier clocks of an instrumented copy")
    parser.add_argument("--levers", action="store_true",
                        help="the Hopper kernel H's choices, each undone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fused_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    if args.clocks:
        clocks()
    elif args.levers:
        levers()
    else:
        time_shapes()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
