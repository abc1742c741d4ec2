"""Time kernels H and I (ops/fused_encoder.py) on the card, and show where
their time goes.

    python -m ddp_practice_tpu_torch.experiments.fused_profile
    python -m ddp_practice_tpu_torch.experiments.fused_profile --clocks

Without flags: each shape's kernels against the plain version (relative
error norms), then the device time of one wrapper call (CUDA events,
median of 10, each call queued behind a spin kernel so the events bracket
device work) beside the host time of the call; kernel I also in its parts:
the per-sequence launch (with its vector-grad reduction) and the four
kernel K launches of its weight grads.

`--clocks` stands in for a kernel profiler where none runs: it writes an
instrumented copy of csrc/fused_encoder.cu into build/ (every
`__syncthreads()` becomes a barrier that also adds block 0's `clock64()`
delta since the previous barrier into a `__device__` array indexed by
source line), builds it, runs the ViT-Tiny layer forward and backward and
prints microseconds per barrier interval: the time of the phase that ends
at that line. A counter starts at kernel entry, so the first interval
holds no gap between calls. Kernel I's per-sequence launch is read; its
kernel K launches carry no clocks. Clock ticks are converted at 1.755 GHz
(the H100 SXM's boost clock: nvidia-smi reads the running clock).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
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
SLOTS = 2048

_TICK = '''
__device__ long long g_ticks[2048];
__device__ int g_counts[2048];
__device__ long long g_last;
__device__ __forceinline__ void sync_tick(int line) {
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long t = clock64();
    g_ticks[line] += t - g_last;
    g_counts[line] += 1;
    g_last = t;
  }
}
'''
_EXPORT = '''
extern "C" int fe_ticks(long long* ticks, int* counts, int reset) {
  if (reset) {
    static long long zeros[2048];
    cudaMemcpyToSymbol(g_ticks, zeros, sizeof(zeros));
    cudaMemcpyToSymbol(g_counts, zeros, sizeof(int) * 2048);
    return 0;
  }
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(ticks, g_ticks, sizeof(long long) * 2048);
  cudaMemcpyFromSymbol(counts, g_counts, sizeof(int) * 2048);
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
    src = src.replace("namespace {\n", "namespace {\n" + _TICK, 1)
    head, tail = src.split(_TICK, 1)
    tail = tail.replace("__syncthreads();", "sync_tick(__LINE__);")
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
            ("H", lambda: fe.fused_encoder_forward(x, params, impl="kernel",
                                                   **kw)),
            ("I", lambda: fe._bwd_sequences(x, g, params, heads, dtype,
                                            causal))):
        fn()
        lib.fe_ticks(ticks, counts, 1)
        for _ in range(calls):
            fn()
        lib.fe_ticks(ticks, counts, 0)
        us = [t / calls / CLOCK_HZ * 1e6 for t in ticks]
        print(f"kernel {name}, block 0, {imgs} x {s} x {d}: {sum(us):.1f} us "
              f"per call between barriers")
        for line in range(SLOTS):
            if counts[line]:
                n = counts[line] // calls
                print(f"  line {line:4d} {us[line]:8.1f} us in {n:4d} "
                      f"intervals ({us[line] / n:6.2f} us each), ends after: "
                      f"{lines[line - 2].strip()[:60]}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--clocks", action="store_true",
                        help="per-barrier clocks of an instrumented copy")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fused_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    clocks() if args.clocks else time_shapes()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
