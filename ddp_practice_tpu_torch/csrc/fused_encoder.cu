// Fused pre-LN transformer encoder layer for sm_90a, forward and backward:
// one launch per direction. Built with nvcc into a shared library with a
// plain C interface (ddp_practice_tpu_torch/ops/cuda_build.py) and launched
// through ctypes by ddp_practice_tpu_torch/ops/fused_encoder.py.
//
// Replaces the Pallas TPU kernels of ddp_practice_tpu/ops/fused_encoder.py:
//   kernel H (fused_encoder_fwd_kernel): _fused_kernel -> _fwd_core, reached
//     from fused_encoder_forward;
//   kernel I (fused_encoder_bwd_kernel, then fused_encoder_reduce_kernel,
//     then kernel K four times for the weight grads): _fused_bwd_kernel,
//     reached from fused_encoder_backward.
//
// What it computes, per sequence x (s, d), with T the compute dtype (every
// weight leaf arrives cast to T, vectors read back as fp32), every product
// taking T operands and accumulating in fp32:
//   y1  = LN(x) * ln1_s + ln1_b                     fp32, eps 1e-6
//   qkv = T(y1 . Wqkv^T + bqkv)
//   per head: sc = (q . k^T) * (1/sqrt(hd)); causal: + -1e30 above the
//     diagonal; p = softmax(sc) (row max subtracted, divided); o = T(p) . v
//   x2  = x + o_all . Wproj^T + bproj
//   y2  = LN(x2) * ln2_s + ln2_b
//   hpre = y2 . Win^T + b_in;  hg = T(0.5 hpre (1 + tanh(c (hpre + a hpre^3))))
//   out = x2 + hg . Wout^T + b_out
// and the backward recomputes all of it for the sequence, then runs the
// transposes by hand (dqkv is rounded to T after its fp32 bias sums, dsc is
// scaled once), giving dx in x's dtype and the 12 parameter grads in fp32.
// Weights keep PyTorch's (out, in) layout: the forward reads them as
// column-major B operands, the backward's input grads as row-major ones, and
// weight grads are written in that layout.
//
// Bound: operations. At the ViT-Tiny shape (1024 sequences of 64, d=192,
// mlp=768) the forward does 61.2 GFLOP against 50 MB of x in and out: 0.062
// ms at the tensor cores' 989.4 TFLOP/s (bf16) against 0.015 ms at 3.35
// TB/s. fp32 runs outside the tensor cores (67 TFLOP/s).
//
// Design. A persistent block of 512 threads takes sequences blockIdx.x,
// blockIdx.x + gridDim.x, ... one at a time. The sequence's operands (LN
// output, a head's q|k|v, probabilities, an fp32 staging tile) live in
// shared memory as far as it reaches; the wrapper's plan sends what does
// not fit to a per-block scratch in global memory, and every buffer is
// reached through a generic pointer, so the code is the same for both. One
// block-wide product primitive serves every product: bf16 through WMMA
// (mma.sync 16x16x16, fp32 accumulation; a warp owns one 16-wide column
// strip of up to 4 row tiles and reuses each B fragment across them), fp32
// as FMAs over 4x4 patches (TF32 would break the fp32 tolerances). Rows are
// padded to a multiple of 16 with zero cotangents and masked keys, so any
// sequence length runs. Kernel H reads weight fragments straight from
// global memory (the layer's weights stay in the L2).
//
// Kernel I (redesigned for Hopper):
//   - Its weight products read the weights from two staging slots in
//     shared memory (the plan's kW), filled by 16-byte cp.async copies that
//     all warps issue and share: a block of hd weight rows (the head's q, k
//     or v rows of wqkv, hd rows of wproj or of w_in's MLP chunk) or of hd
//     weight columns (wproj's head columns, w_out's MLP chunk). The next
//     block is copied while the current one multiplies, in place of each
//     warp's fragment loads from the L2. The MLP backward runs hd columns
//     a chunk, so one chunk's w_in and w_out blocks fill the two slots.
//     Staging the slots costs the plan the fp32 dy buffer, which moves to
//     the per-block scratch.
//   - It adds no weight-grad contribution anywhere. Each sequence writes
//     the compute-dtype operands that its four weight-grad products take
//     (y1, T(dqkv), o_all, T(dx2), hg, dh, y2: rounded at the same points
//     as before) into per-layer (tokens, width) buffers, and the wrapper
//     multiplies them with kernel K (csrc/grouped_matmul.cu), one group
//     over all tokens, fp32 output: dWqkv = dqkv^T y1, dWproj = dx2^T o_all,
//     dW_in = dh^T y2, dW_out = g^T hg. Where a per-block fp32 partial of
//     the 12 grads would be read and written for every 64-row sequence
//     (1.78 MB, 3.5 GB a layer at ViT-Tiny), the operands are written once
//     (0.38 GB) and K reads them once.
//   - The 8 vector grads (LN scales and biases, the four biases: 9d + mlp
//     floats) stay per-block fp32 partials in global memory, zeroed by the
//     block itself, summed by the reduce kernel in block order.
//   - Every sum has a fixed order (K's too), so the grads are the same bits
//     on every run (no atomics).
//   - The recompute stashes each head's q|k|v, P and fp32 p in a per-block
//     buffer (global memory), and the heads' backward copies them back
//     (cp.async) instead of recomputing them a second time.
//   - The MLP backward forms each chunk's hpre and dhg tiles and applies
//     the GELU and its derivative in registers (mlp_gelu_sm). The input
//     grads dy2 = dh . W_in and dy1 = dqkv . Wqkv then run once per
//     sequence over the operands already written out (gemm_kloop: 64-deep
//     blocks of the operand and the weight staged, accumulators in
//     registers over the whole reduction, dy written once) instead of
//     adding into dy chunk by chunk and head by head.
//   - One sequence a block: at ViT-Tiny in bf16 one sequence's buffers and
//     the slots take 227 KB of the 227 KB a block can have, so the
//     reference's several sequences a grid step do not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;
constexpr float kGeluC = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float kGeluA = 0.044715f;
constexpr float kMasked = -1e30f;
constexpr int KU = 4;   // k steps whose B fragments load together

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// one sequence's buffers, in the wrapper's order (ops/fused_encoder.py _plan);
// kW, kernel I's two weight staging slots, is not a per-row buffer: its
// ld is one slot's size in elements
enum Buf {
  kStats = 0, kS, kW, kQKV, kP, kDS, kY, kO, kG, kDY, kXR, kDX2, kBuffers
};
// kernel I's per-layer operands of the weight grads, (tokens, width) in the
// compute dtype: y1 (d), dqkv (3d), o_all (d), T(dx2) (d), hg (mlp), dh
// (mlp), y2 (d)
enum Op { kOpY1 = 0, kOpDQKV, kOpO, kOpDX2, kOpHG, kOpDH, kOpY2, kOps };

struct Params {
  const void* x;        // (imgs, s, d) in x's dtype
  const void* g;        // backward: the cotangent, in x's dtype
  void* out;            // forward: the layer's output; backward: dx
  const void* mats;     // T: wqkv (3d, d) | wproj (d, d) | w_in (mlp, d) |
                        //    w_out (d, mlp)
  const float* vecs;    // ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b_in, b_out
  unsigned char* scratch;
  float* vpart;         // backward: (grid, vsz) fp32 vector-grad partials
  void* ops[kOps];      // backward: the weight grads' operands (Op)
  unsigned char* stash; // backward: per block, the recompute's q|k|v, P and
                        // p of every head (stash_bytes a block)
  long long off[kBuffers];
  int loc[kBuffers];    // 0: shared memory, 1: the block's scratch
  int ld[kBuffers];     // row pitch in elements
  long long scratch_bytes, vsz, stash_bytes;
  int imgs, s, sp, d, h, hd, mlp, causal, x_bf16, chunk;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float load_x(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_x(void* p, long long i, int bf,
                                        float v) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// every weight copy issued so far has landed and every thread is past the
// previous step (a macro, so that experiments/fused_profile.py --clocks
// charges the barrier to the line that uses it)
#define STAGE_SYNC()     \
  do {                   \
    cp_async_wait_all(); \
    __syncthreads();     \
  } while (0)

// rows x cols (cols x sizeof(T) a multiple of 16) of a row-major weight
// (row stride ld) into a staging slot at row pitch `pitch`: 16-byte
// cp.async copies spread over the block when the slot lies in shared
// memory, plain 16-byte copies when the plan put it in global scratch.
// Lands by the next STAGE_SYNC().
template <typename T>
__device__ __forceinline__ void stage_w(T* dst, int pitch, const T* src,
                                        int ld, int rows, int cols,
                                        bool smem) {
  constexpr int V = 16 / int(sizeof(T));
  const int per = cols / V;
  for (int e = threadIdx.x; e < rows * per; e += kThreads) {
    const int r = e / per, c = (e % per) * V;
    const T* from = src + static_cast<long long>(r) * ld + c;
    if (smem)
      cp_async16(dst + r * pitch + c, from);
    else
      *reinterpret_cast<uint4*>(dst + r * pitch + c) =
          *reinterpret_cast<const uint4*>(from);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// rows x bytes (a multiple of 16) from a row pitch of src_ld bytes to one of
// dst_ld bytes: cp.async when dst lies in shared memory (lands by the next
// STAGE_SYNC()), plain 16-byte copies otherwise
__device__ __forceinline__ void copy_rows(void* dst, long long dst_ld,
                                          const void* src, long long src_ld,
                                          int rows, int bytes) {
  const int per = bytes / 16;
  const bool smem = __isShared(dst);
  for (int e = threadIdx.x; e < rows * per; e += kThreads) {
    const int r = e / per, c = (e % per) * 16;
    unsigned char* to = static_cast<unsigned char*>(dst) + r * dst_ld + c;
    const unsigned char* from =
        static_cast<const unsigned char*>(src) + r * src_ld + c;
    if (smem)
      cp_async16(to, from);
    else
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ------------------------------------------------------------- products
// Several products of one shape in one call: segment j reads A + j * a and
// B + j * b and writes C + j * c (elements).
struct Segments {
  int n;
  long long a, b, c;
};
constexpr Segments kOne = {1, 0, 0, 0};

// C (M, N) fp32 (+)= A (M, K) . B (K, N), block-wide; M, N, K multiples of
// 16. A(m, k) is A[m * lda + k], or A[k * lda + m] when ACOL; B(k, n) is
// B[k * ldb + n], or B[n * ldb + k] when BCOL. The pointers may be shared
// or global memory. A task is one 16-wide column strip of MG row tiles (each
// B fragment is loaded once for the MG tiles); task t goes to warp
// (t + shift) % kWarps, so two calls with different shifts run side by
// side. The same (shape, MG, shift) maps a tile to the same warp in every
// call: calls that accumulate into one C need no block barrier between
// them. Returns unsynchronised.
template <bool ACOL, bool BCOL, bool ACC, int MG>
__device__ __noinline__ void gemm_tc(float* C, int ldc, const bf16* A,
                                     int lda, const bf16* B, int ldb, int M,
                                     int N, int K, int shift, Segments seg) {
  using LA = typename std::conditional<ACOL, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<BCOL, wmma::col_major,
                                       wmma::row_major>::type;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  __syncwarp();   // this warp's earlier stores to C are visible to its lanes
  const int warp = ((threadIdx.x >> 5) + kWarps - shift % kWarps) % kWarps;
  const int mt = M / 16, nt = N / 16, kt = K / 16;
  const int per = ((mt + MG - 1) / MG) * nt;
  for (int task = warp; task < seg.n * per; task += kWarps) {
    const int sg = task / per, t = task % per;
    const int tn = t % nt, tm0 = (t / nt) * MG;
    const int cnt = min(MG, mt - tm0);
    float* Cs = C + sg * seg.c;
    const bf16* As = A + sg * seg.a;
    const bf16* Bs = B + sg * seg.b;
    FragC acc[MG];
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (ACC && i < cnt)
        wmma::load_matrix_sync(acc[i], Cs + (tm0 + i) * 16 * ldc + tn * 16,
                               ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[i], 0.f);
    }
    auto load_b = [&](FragB& fb, int kk) {
      wmma::load_matrix_sync(fb,
                             BCOL ? Bs + tn * 16 * ldb + kk * 16
                                  : Bs + kk * 16 * ldb + tn * 16,
                             ldb);
    };
    auto step = [&](const FragB& fb, int kk) {
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        if (i < cnt) {
          FragA fa;
          wmma::load_matrix_sync(fa,
                                 ACOL ? As + kk * 16 * lda + (tm0 + i) * 16
                                      : As + (tm0 + i) * 16 * lda + kk * 16,
                                 lda);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    };
    // KU B fragments are loaded before their products, so the loads'
    // latency (global memory for the weights) overlaps the tensor cores
    int kk = 0;
    for (; kk + KU <= kt; kk += KU) {
      FragB fb[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u) load_b(fb[u], kk + u);
#pragma unroll
      for (int u = 0; u < KU; ++u) step(fb[u], kk + u);
    }
    for (; kk < kt; ++kk) {
      FragB fb;
      load_b(fb, kk);
      step(fb, kk);
    }
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (i < cnt)
        wmma::store_matrix_sync(Cs + (tm0 + i) * 16 * ldc + tn * 16, acc[i],
                                ldc, wmma::mem_row_major);
    }
  }
}

template <bool ACOL, bool BCOL, bool ACC>
__device__ __noinline__ void gemm_fma(float* C, int ldc, const float* A,
                                      int lda, const float* B, int ldb, int M,
                                      int N, int K, Segments seg) {
  const int nq = N / 4, per = (M / 4) * nq;
  for (int e = threadIdx.x; e < seg.n * per; e += kThreads) {
    const int sg = e / per, t = e % per;
    const int m0 = (t / nq) * 4, n0 = (t % nq) * 4;
    float* Cs = C + sg * seg.c;
    const float* As = A + sg * seg.a;
    const float* Bs = B + sg * seg.b;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = ACC ? Cs[(m0 + i) * ldc + n0 + j] : 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ACOL ? As[k * lda + m0 + i] : As[(m0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = BCOL ? Bs[(n0 + j) * ldb + k] : Bs[k * ldb + n0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(m0 + i) * ldc + n0 + j] = acc[i][j];
  }
}

// `strip`: B is a weight in global memory, so a warp takes whole column
// strips (4 row tiles per B fragment: each weight is read from the L2 once
// per sequence, not once per row tile); otherwise the widest row group that
// still gives every warp a task.
template <typename T, bool ACOL, bool BCOL, bool ACC>
__device__ __forceinline__ void gemm(float* C, int ldc, const T* A, int lda,
                                     const T* B, int ldb, int M, int N, int K,
                                     bool strip = false, int shift = 0,
                                     Segments seg = kOne) {
  if constexpr (std::is_same<T, float>::value) {
    gemm_fma<ACOL, BCOL, ACC>(C, ldc, A, lda, B, ldb, M, N, K, seg);
  } else {
    const int mt = M / 16, nt = seg.n * (N / 16);
    if (strip || nt * ((mt + 3) / 4) >= kWarps)
      gemm_tc<ACOL, BCOL, ACC, 4>(C, ldc, A, lda, B, ldb, M, N, K, shift,
                                  seg);
    else if (nt * ((mt + 1) / 2) >= kWarps)
      gemm_tc<ACOL, BCOL, ACC, 2>(C, ldc, A, lda, B, ldb, M, N, K, shift,
                                  seg);
    else
      gemm_tc<ACOL, BCOL, ACC, 1>(C, ldc, A, lda, B, ldb, M, N, K, shift,
                                  seg);
  }
}

// ---------------------------------------- products from shared memory (I)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 x 16, rows r0, depth k0) and NT B fragment pairs
// (16 x 8 twice, columns n0 + 16 j) of one k16 step, by ldmatrix: .trans
// for a col-major A (A(m, k) = A[k * lda + m]) and for a row-major B
// (B(k, n) = B[k * ldb + n]).
template <bool ACOL, bool BCOL, int NT>
__device__ __forceinline__ void sm_frags(uint32_t (&fa)[4],
                                         uint32_t (&fb)[NT][4],
                                         const bf16* A, int lda,
                                         const bf16* B, int ldb, int r0,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31;
  if (ACOL)
    ldsm_x4_t(fa, A + (k0 + 8 * (lane >> 4) + (lane & 7)) * lda + r0 +
                      8 * ((lane >> 3) & 1));
  else
    ldsm_x4(fa, A + (r0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (BCOL)
      ldsm_x4(fb[j], B + (n0 + 16 * j + (lane & 7) + ((lane >> 4) << 3)) *
                             ldb + k0 + ((lane >> 3) & 1) * 8);
    else
      ldsm_x4_t(fb[j],
                B + (k0 + (lane & 15)) * ldb + n0 + 16 * j + (lane >> 4) * 8);
  }
}

template <int NT>
__device__ __forceinline__ void sm_mma(float (&acc)[2 * NT][4],
                                       const uint32_t (&fa)[4],
                                       const uint32_t (&fb)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_bf16(acc[2 * j], fa, fb[j][0], fb[j][1]);
    mma_bf16(acc[2 * j + 1], fa, fb[j][2], fb[j][3]);
  }
}

// C (M, N) fp32 (+)= A (M, K) . B (K, N), block-wide, with A and B bf16 in
// shared memory (row pitches multiples of 16 bytes): mma.sync m16n8k16
// fed by ldmatrix, fp32 accumulators in registers, the next k16 step's
// fragments loaded while this one's products run. A task is one 16 x 16NT
// tile of C (which may lie in global memory: with ACC its old values are
// loaded before the products and added after them, so the load's latency
// hides behind them); task t goes to warp (t + shift) % kWarps, so calls
// with the same shape and shift map each tile to the same warp (calls that
// accumulate into one C need no block barrier between them). Returns
// unsynchronised.
template <bool ACOL, bool BCOL, bool ACC, int NT>
__device__ __noinline__ void gemm_sm(float* C, int ldc, const bf16* A,
                                     int lda, const bf16* B, int ldb, int M,
                                     int N, int K, int shift) {
  __syncwarp();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = ((threadIdx.x >> 5) + kWarps - shift % kWarps) % kWarps;
  const int nt = N / (16 * NT), tasks = (M / 16) * nt;
  for (int task = warp; task < tasks; task += kWarps) {
    const int r0 = (task / nt) * 16, n0 = (task % nt) * 16 * NT;
    float acc[2 * NT][4], old[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const float* c = C + (r0 + g) * ldc + n0 + 8 * j + 2 * t4;
      if (ACC) {
        const float2 lo = *reinterpret_cast<const float2*>(c);
        const float2 hi = *reinterpret_cast<const float2*>(c + 8 * ldc);
        old[j][0] = lo.x;
        old[j][1] = lo.y;
        old[j][2] = hi.x;
        old[j][3] = hi.y;
      }
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    uint32_t fa0[4], fa1[4], fb0[NT][4], fb1[NT][4];
    sm_frags<ACOL, BCOL, NT>(fa0, fb0, A, lda, B, ldb, r0, n0, 0);
    int k0 = 0;
    for (; k0 + 32 <= K; k0 += 32) {
      sm_frags<ACOL, BCOL, NT>(fa1, fb1, A, lda, B, ldb, r0, n0, k0 + 16);
      sm_mma<NT>(acc, fa0, fb0);
      if (k0 + 32 < K)
        sm_frags<ACOL, BCOL, NT>(fa0, fb0, A, lda, B, ldb, r0, n0, k0 + 32);
      sm_mma<NT>(acc, fa1, fb1);
    }
    if (k0 < K) sm_mma<NT>(acc, fa0, fb0);   // an odd count of k16 steps
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (ACC)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += old[j][i];
      float* c = C + (r0 + g) * ldc + n0 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(c) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(c + 8 * ldc) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// two floats as two neighbouring elements of T
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Kernel I's MLP chunk products and GELU in one pass: a warp takes a 16 x
// 16 tile of the chunk, forms hpre = Y . Win^T (Win's block column-major)
// and dhg = G . Wout (row-major) on mma.sync from shared memory, and in
// registers hg = T(gelu(hpre + b_in)) and dh = dhg gelu'(hpre + b_in), as
// the separate GELU pass computed them: T(dh) into DH (row pitch ldh; none
// when null), dh in fp32 into dh32 (row pitch ldd, for the b_in sums), and
// rows below s into the per-layer operands hg_out, dh_out (row stride
// ld_out). M = sp rows, N = n columns. Returns unsynchronised.
__device__ __noinline__ void mlp_gelu_sm(
    const bf16* Y, int ldy, const bf16* Win, int ldwi, const bf16* G, int ldg,
    const bf16* Wout, int ldwo, const float* b_in, int M, int N, int K,
    bf16* DH, int ldh, float* dh32, int ldd, int s, bf16* hg_out,
    bf16* dh_out, long long ld_out) {
  __syncwarp();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int nt = N / 16;
  for (int task = threadIdx.x >> 5; task < (M / 16) * nt; task += kWarps) {
    const int r0 = (task / nt) * 16, n0 = (task % nt) * 16;
    float ah[2][4] = {}, ag[2][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t fa[4], fb[1][4], fc[4], fd[1][4];
      sm_frags<false, true, 1>(fa, fb, Y, ldy, Win, ldwi, r0, n0, k0);
      sm_frags<false, false, 1>(fc, fd, G, ldg, Wout, ldwo, r0, n0, k0);
      sm_mma<1>(ah, fa, fb);
      sm_mma<1>(ag, fc, fd);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h, c = n0 + 8 * j + 2 * t4;
        float hg[2], dh[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float hp = ah[j][2 * h + i] + b_in[c + i];
          const float th = tanhf(kGeluC * (hp + kGeluA * hp * hp * hp));
          const float grad =
              0.5f * (1.f + th) + 0.5f * hp * (1.f - th * th) * kGeluC *
                                      (1.f + 3.f * kGeluA * hp * hp);
          hg[i] = 0.5f * hp * (1.f + th);
          dh[i] = ag[j][2 * h + i] * grad;
        }
        if (DH != nullptr) store_pair(DH + r * ldh + c, dh[0], dh[1]);
        *reinterpret_cast<float2*>(dh32 + r * ldd + c) =
            make_float2(dh[0], dh[1]);
        if (r < s) {
          store_pair(hg_out + r * ld_out + c, hg[0], hg[1]);
          store_pair(dh_out + r * ld_out + c, dh[0], dh[1]);
        }
      }
  }
}

// Kernel I's input grads over the whole reduction: C (sp x N) = A (sp x K)
// . B (K x N), A the rows of a per-layer operand in global memory (row
// stride lda; rows s.. read as zero), B a weight (row stride ldb). K runs
// in 64-deep blocks staged in shared memory, A's into one of two slots of
// `abuf` (row pitch 72), B's into w0 / w1 (row pitch pw); block kb + 1 is
// copied while kb multiplies. A warp owns TPW 16 x 16 tiles of C (tile t
// of warp w is w + 16 t) with fp32 accumulators in registers over all of
// K, and C (row pitch ldc) is written once. Ends with a block barrier.
template <int TPW>
__device__ __noinline__ void gemm_kloop(float* C, int ldc, const bf16* A,
                                        long long lda, int s, const bf16* B,
                                        int ldb, int sp, int N, int K,
                                        bf16* abuf, bf16* w0, bf16* w1,
                                        int pw) {
  constexpr int KB = 64, LDA = KB + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5, nt = N / 16, tiles = (sp / 16) * nt;
  const int nkb = (K + KB - 1) / KB;
  auto issue = [&](int kb) {
    const int k0 = kb * KB, depth = min(KB, K - k0);
    bf16* as = abuf + (kb & 1) * sp * LDA;
    const int per = depth / 8;   // 16-byte chunks a row
    for (int e = threadIdx.x; e < sp * per; e += kThreads) {
      const int r = e / per, c = (e % per) * 8;
      if (r < s)
        cp_async16(as + r * LDA + c, A + r * lda + k0 + c);
      else
        *reinterpret_cast<uint4*>(as + r * LDA + c) = make_uint4(0, 0, 0, 0);
    }
    stage_w((kb & 1) ? w1 : w0, pw, B + static_cast<long long>(k0) * ldb,
            ldb, depth, N, true);   // commits A's copies too
  };
  float acc[TPW][2][4] = {};
  issue(0);
  for (int kb = 0; kb < nkb; ++kb) {
    STAGE_SYNC();
    if (kb + 1 < nkb) issue(kb + 1);
    const bf16* as = abuf + (kb & 1) * sp * LDA;
    const bf16* bs = (kb & 1) ? w1 : w0;
    const int steps = min(KB, K - kb * KB) / 16;
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      const int task = warp + kWarps * t;
      if (task >= tiles) continue;
      const int r0 = (task / nt) * 16, n0 = (task % nt) * 16;
      for (int kk = 0; kk < steps; ++kk) {
        uint32_t fa[4], fb[1][4];
        sm_frags<false, false, 1>(fa, fb, as, LDA, bs, pw, r0, n0, kk * 16);
        sm_mma<1>(acc[t], fa, fb);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < TPW; ++t) {
    const int task = warp + kWarps * t;
    if (task >= tiles) continue;
    const int r0 = (task / nt) * 16, n0 = (task % nt) * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* c = C + (r0 + g) * ldc + n0 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(c) = make_float2(acc[t][j][0], acc[t][j][1]);
      *reinterpret_cast<float2*>(c + 8 * ldc) =
          make_float2(acc[t][j][2], acc[t][j][3]);
    }
  }
  __syncthreads();
}

// gemm_kloop at the tiles a warp the shape needs (up to 4)
__device__ __forceinline__ void gemm_kloop_any(float* C, int ldc,
                                               const bf16* A, long long lda,
                                               int s, const bf16* B, int ldb,
                                               int sp, int N, int K,
                                               bf16* abuf, bf16* w0, bf16* w1,
                                               int pw) {
  switch (((sp / 16) * (N / 16) + kWarps - 1) / kWarps) {
    case 1: gemm_kloop<1>(C, ldc, A, lda, s, B, ldb, sp, N, K, abuf, w0, w1,
                          pw); break;
    case 2: gemm_kloop<2>(C, ldc, A, lda, s, B, ldb, sp, N, K, abuf, w0, w1,
                          pw); break;
    case 3: gemm_kloop<3>(C, ldc, A, lda, s, B, ldb, sp, N, K, abuf, w0, w1,
                          pw); break;
    default: gemm_kloop<4>(C, ldc, A, lda, s, B, ldb, sp, N, K, abuf, w0,
                           w1, pw); break;
  }
}

// gemm_sm at 16 x 32 tasks when they split evenly over the warps, else
// 16 x 16
template <bool ACOL, bool BCOL, bool ACC>
__device__ __forceinline__ void gemm_shared(float* C, int ldc, const bf16* A,
                                            int lda, const bf16* B, int ldb,
                                            int M, int N, int K, int shift) {
  if (N % 32 == 0 && (M / 16) * (N / 32) % kWarps == 0)
    gemm_sm<ACOL, BCOL, ACC, 2>(C, ldc, A, lda, B, ldb, M, N, K, shift);
  else
    gemm_sm<ACOL, BCOL, ACC, 1>(C, ldc, A, lda, B, ldb, M, N, K, shift);
}

// f(r, c) over a (rows, cols) tile: a warp's lanes walk the columns, the
// warps the rows, so neighbouring lanes touch neighbouring addresses and a
// thread's iterations are independent of one another
template <typename F>
__device__ __forceinline__ void tile_each(int rows, int cols, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = lane; c < cols; c += 32)
#pragma unroll 4
    for (int r = warp; r < rows; r += kWarps) f(r, c);
}
// the same with a per-column value (a bias) loaded once: f(r, c, col(c))
template <typename G, typename F>
__device__ __forceinline__ void tile_cols(int rows, int cols, G col, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = lane; c < cols; c += 32) {
    const float v = col(c);
#pragma unroll 4
    for (int r = warp; r < rows; r += kWarps) f(r, c, v);
  }
}

// *at(c) += sum over rows of f(r, c): G neighbouring lanes share a column
// (G = 8, 4, 2 or 1, as many as the block has threads for), each sums every
// G-th row, and a shuffle tree adds them up in a fixed order
template <typename F, typename At>
__device__ __forceinline__ void colsum_add_at(int n, int rows, F f, At at) {
  int G = 8;
  while (G > 1 && n * G > kThreads) G >>= 1;
  const int sub = threadIdx.x % G;
  for (int base = 0; base < n; base += kThreads / G) {
    const int c = base + threadIdx.x / G;
    float a = 0.f;
    if (c < n) {
#pragma unroll 4
      for (int r = sub; r < rows; r += G) a += f(r, c);
    }
    for (int o = G >> 1; o > 0; o >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    if (c < n && sub == 0) *at(c) += a;
  }
}
template <typename F>
__device__ __forceinline__ void colsum_add(float* dst, int n, int rows, F f) {
  colsum_add_at(n, rows, f, [&](int c) { return dst + c; });
}


// ------------------------------------------------ kernel I's row passes
// A warp per row; each lane holds the row's columns lane + 32 j (j < CPL =
// d / 32, d <= 256) in registers, its loads issued together, so a pass
// costs one round trip to the L2 per row instead of one per column step.
// Each pass is instantiated at the exact CPL of the layer's width.

// calls f(std::integral_constant<int, d / 32>()), d a multiple of 64 up to
// 256
template <typename F>
__device__ __forceinline__ void with_cpl(int d, F f) {
  switch (d / 32) {
    case 2: f(std::integral_constant<int, 2>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    default: f(std::integral_constant<int, 8>()); break;
  }
}

// v[j] = f(lane + 32 j)
template <int CPL, typename F>
__device__ __forceinline__ void row_load(float (&v)[CPL], F f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < CPL; ++j) v[j] = f(lane + 32 * j);
}

// LayerNorm statistics of one row (mean, 1/std), summed as layer_norm does
template <int CPL>
__device__ __forceinline__ void row_stats(const float (&v)[CPL], float& m,
                                          float& r1) {
  constexpr float d = 32.f * CPL;
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) a += v[j];
  m = warp_sum(a) / d;
  a = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) a += (v[j] - m) * (v[j] - m);
  r1 = 1.f / sqrtf(warp_sum(a) / d + kLnEps);
}

// ln_backward_row's two means: m1 = mean(dya scale), m2 = mean(dya scale
// yhat), yhat = (xin - mu) rs
template <int CPL>
__device__ __forceinline__ void row_ln_means(const float (&dya)[CPL],
                                             const float (&xin)[CPL],
                                             float mu, float rs,
                                             const float* scale, float& m1,
                                             float& m2) {
  const int lane = threadIdx.x & 31;
  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const float dxh = dya[j] * scale[lane + 32 * j];
    a1 += dxh;
    a2 += dxh * ((xin[j] - mu) * rs);
  }
  m1 = warp_sum(a1) / (32.f * CPL);
  m2 = warp_sum(a2) / (32.f * CPL);
}

// dst[q][c] += the sum over the block's warps, in warp order, of their
// per-lane column partials part[q][j] (c = lane + 32 j), through `red`
// (NQ * kWarps * d floats of scratch). Call after a block barrier; ends
// with one.
template <int NQ, int CPL>
__device__ __forceinline__ void colsum_parts(const float (&part)[NQ][CPL],
                                             float* red,
                                             float* const (&dst)[NQ]) {
  constexpr int d = 32 * CPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      red[(q * kWarps + warp) * d + lane + 32 * j] = part[q][j];
  __syncthreads();
  for (int e = threadIdx.x; e < NQ * d; e += kThreads) {
    const int q = e / d, c = e % d;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += red[(q * kWarps + w) * d + c];
    dst[q][c] += a;
  }
  __syncthreads();
}

// ---------------------------------------------------------- one sequence
// FAST (kernel I): products whose operands both lie in shared memory run
// through gemm_shared in bf16; kernel H keeps gemm for every product.
template <typename T, bool FAST = false> struct Seq {
  const Params& p;
  float* stats;   // mu1, r1, mu2, r2: (4, sp)
  float* S;
  T* QKV;
  T* P;
  T* DS;
  T* Y;
  T* O;
  T* G;
  float* DY;
  float* XR;
  float* DX2;
  const T* wqkv;
  const T* wproj;
  const T* w_in;
  const T* w_out;
  const float *ln1_s, *ln1_b, *bqkv, *bproj, *ln2_s, *ln2_b, *b_in, *b_out;
  // kernel I's weight staging slots (null in kernel H: its products read
  // the weights from global memory), whether they lie in shared memory, and
  // the row pitches of a staged (hd, d) and (d, hd) weight block
  T* W0;
  T* W1;
  bool w_smem;
  int pw_row, pw_col;
  // kernel I's stash of the recompute's per-head q|k|v (rows of QKV's
  // pitch), P (P's pitch) and fp32 p (sp wide), for the heads' backward
  unsigned char* stash;

  template <typename U> __device__ U* buf(unsigned char* smem, int b) const {
    unsigned char* base =
        p.loc[b] ? p.scratch + blockIdx.x * p.scratch_bytes : smem;
    return reinterpret_cast<U*>(base + p.off[b]);
  }

  __device__ Seq(const Params& pp, unsigned char* smem) : p(pp) {
    stats = buf<float>(smem, kStats);
    S = buf<float>(smem, kS);
    QKV = buf<T>(smem, kQKV);
    P = buf<T>(smem, kP);
    DS = buf<T>(smem, kDS);
    Y = buf<T>(smem, kY);
    O = buf<T>(smem, kO);
    G = buf<T>(smem, kG);
    DY = buf<float>(smem, kDY);
    XR = buf<float>(smem, kXR);
    DX2 = buf<float>(smem, kDX2);
    const int d = p.d, mlp = p.mlp;
    wqkv = static_cast<const T*>(p.mats);
    wproj = wqkv + 3 * d * d;
    w_in = wproj + d * d;
    w_out = w_in + mlp * d;
    ln1_s = p.vecs;
    ln1_b = ln1_s + d;
    bqkv = ln1_b + d;
    bproj = bqkv + 3 * d;
    ln2_s = bproj + d;
    ln2_b = ln2_s + d;
    b_in = ln2_b + d;
    b_out = b_in + mlp;
    constexpr int pad = 16 / int(sizeof(T));
    W0 = p.ld[kW] > 0 ? buf<T>(smem, kW) : nullptr;
    W1 = W0 == nullptr ? nullptr : W0 + p.ld[kW];
    w_smem = p.loc[kW] == 0;
    pw_row = d + pad;
    pw_col = p.hd + pad;
    stash = FAST && p.stash != nullptr
                ? p.stash + static_cast<long long>(blockIdx.x) * p.stash_bytes
                : nullptr;
  }

  // head hi's stashed q|k|v, P and fp32 p
  __device__ T* stash_qkv(int hi) const {
    return reinterpret_cast<T*>(stash + hi * stash_head());
  }
  __device__ T* stash_P(int hi) const {
    return stash_qkv(hi) + static_cast<long long>(p.sp) * p.ld[kQKV];
  }
  __device__ float* stash_p(int hi) const {
    return reinterpret_cast<float*>(stash_P(hi) +
                                    static_cast<long long>(p.sp) * p.ld[kP]);
  }
  __device__ long long stash_head() const {
    return static_cast<long long>(p.sp) * (p.ld[kQKV] + p.ld[kP]) *
               sizeof(T) +
           static_cast<long long>(p.sp) * p.sp * sizeof(float);
  }

  template <bool ACOL, bool BCOL, bool ACC>
  __device__ void mm(float* C, int ldc, const T* A, int lda, const T* B,
                     int ldb, int M, int N, int K, bool strip = false,
                     int shift = 0) const {
    if constexpr (FAST && std::is_same<T, bf16>::value) {
      if (__isShared(A) && __isShared(B)) {
        gemm_shared<ACOL, BCOL, ACC>(C, ldc, A, lda, B, ldb, M, N, K, shift);
        return;
      }
    }
    gemm<T, ACOL, BCOL, ACC>(C, ldc, A, lda, B, ldb, M, N, K, strip, shift);
  }

  // C[:, 0 : nb * hd] (+)= A . (wqkv-like rows)^T, staged: block j is the
  // weight's rows row0(j) .. + hd (all d columns), multiplied as a
  // column-major B; block j + 1 is copied while block j multiplies. Ends
  // with every product done.
  template <bool ACC, typename R>
  __device__ void staged_rows(float* C, int ldc, const T* A, int lda,
                              const T* w, int nb, R row0) const {
    const int d = p.d, hd = p.hd;
    stage_w(W0, pw_row, w + static_cast<long long>(row0(0)) * d, d, hd, d,
            w_smem);
    for (int j = 0; j < nb; ++j) {
      STAGE_SYNC();
      if (j + 1 < nb)
        stage_w((j + 1) & 1 ? W1 : W0, pw_row,
                w + static_cast<long long>(row0(j + 1)) * d, d, hd, d,
                w_smem);
      mm<false, true, ACC>(C + j * hd, ldc, A, lda, j & 1 ? W1 : W0, pw_row,
                           p.sp, hd, d);
    }
    __syncthreads();
  }

  // kernel I's row passes apply: d fits the lanes' registers and S holds
  // the column sums' scratch
  __device__ bool rows_fast() const {
    return FAST && p.d <= 256 &&
           static_cast<long long>(p.sp) * p.ld[kS] >= 3LL * kWarps * p.d;
  }

  // kernel I's fused load_rows + layer_norm(ln1): XR = x (+ bproj, which
  // the projection then adds to), Y = T(LN1(x)) and, when given, its
  // statistics and a copy of its rows into y_out (row stride d). Rows past
  // s: XR = bproj or 0, Y = 0.
  __device__ void ln1_rows(int img, bool add_bias, float* mu, float* rs,
                           T* y_out) const {
    with_cpl(p.d, [&](auto cpl) {
      ln1_rows_at<decltype(cpl)::value>(img, add_bias, mu, rs, y_out);
    });
  }
  template <int CPL>
  __device__ __forceinline__ void ln1_rows_at(int img, bool add_bias,
                                              float* mu, float* rs,
                                              T* y_out) const {
    constexpr int d = 32 * CPL;
    const int ldx = p.ld[kXR], ldy = p.ld[kY];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long base = static_cast<long long>(img) * p.s * d;
    for (int r = warp; r < p.sp; r += kWarps) {
      float* xr = XR + r * ldx;
      T* yr = Y + r * ldy;
      if (r >= p.s) {
        for (int c = lane; c < d; c += 32) {
          xr[c] = add_bias ? bproj[c] : 0.f;
          yr[c] = from_f<T>(0.f);
        }
        if (lane == 0 && mu != nullptr) mu[r] = rs[r] = 0.f;
        continue;
      }
      float v[CPL], m, r1;
      row_load(v, [&](int c) {
        return load_x(p.x, base + static_cast<long long>(r) * d + c,
                      p.x_bf16);
      });
      row_stats(v, m, r1);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        xr[c] = add_bias ? v[j] + bproj[c] : v[j];
        const T y = from_f<T>((v[j] - m) * r1 * ln1_s[c] + ln1_b[c]);
        yr[c] = y;
        if (y_out != nullptr) y_out[static_cast<long long>(r) * d + c] = y;
      }
      if (lane == 0 && mu != nullptr) {
        mu[r] = m;
        rs[r] = r1;
      }
    }
  }

  // kernel I's LN2 after the recompute: Y = T(LN2(x2)) with its statistics
  // (also into y2_out), G = T(g) (zero past s), the b_out column sums
  template <int CPL>
  __device__ __forceinline__ void ln2_rows_at(long long base, float* mu2,
                                              float* rs2, T* y2_out,
                                              float* g_b_out) const {
    constexpr int d = 32 * CPL;
    const int ldx = p.ld[kXR], ldy = p.ld[kY], ldg = p.ld[kG];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float part[1][CPL] = {};
    for (int r = warp; r < p.sp; r += kWarps) {
      T* yr = Y + r * ldy;
      T* gr = G + r * ldg;
      if (r >= p.s) {
        for (int c = lane; c < d; c += 32) yr[c] = gr[c] = from_f<T>(0.f);
        if (lane == 0) mu2[r] = rs2[r] = 0.f;
        continue;
      }
      float xv[CPL], gv[CPL], m, r1;
      row_load(xv, [&](int c) { return XR[r * ldx + c]; });
      row_load(gv, [&](int c) {
        return load_x(p.g, base + static_cast<long long>(r) * d + c,
                      p.x_bf16);
      });
      row_stats(xv, m, r1);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        const T y = from_f<T>((xv[j] - m) * r1 * ln2_s[c] + ln2_b[c]);
        yr[c] = y;
        y2_out[static_cast<long long>(r) * d + c] = y;
        gr[c] = from_f<T>(gv[j]);
        part[0][j] += gv[j];
      }
      if (lane == 0) {
        mu2[r] = m;
        rs2[r] = r1;
      }
    }
    float* const dst[1] = {g_b_out};
    colsum_parts(part, S, dst);
  }

  // kernel I's LN2 backward: dx2 = g + LN2'(dy2) into DX2, G = T(dx2) (also
  // into dx2_out), zero past s; the ln2_s, ln2_b and bproj column sums
  template <int CPL>
  __device__ __forceinline__ void ln2_back_rows_at(
      long long base, const float* mu2, const float* rs2, T* dx2_out,
      float* const (&grads)[3]) const {
    constexpr int d = 32 * CPL;
    const int ldx = p.ld[kXR], ldg = p.ld[kG], lddy = p.ld[kDY];
    const int ld2 = p.ld[kDX2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float part[3][CPL] = {};
    for (int r = warp; r < p.sp; r += kWarps) {
      if (r >= p.s) {
        for (int c = lane; c < d; c += 32) {
          G[r * ldg + c] = from_f<T>(0.f);
          DX2[r * ld2 + c] = 0.f;
        }
        continue;
      }
      float dy[CPL], xv[CPL], gv[CPL], m1, m2;
      row_load(dy, [&](int c) { return DY[r * lddy + c]; });
      row_load(xv, [&](int c) { return XR[r * ldx + c]; });
      row_load(gv, [&](int c) {
        return load_x(p.g, base + static_cast<long long>(r) * d + c,
                      p.x_bf16);
      });
      const float mu = mu2[r], rs = rs2[r];
      row_ln_means(dy, xv, mu, rs, ln2_s, m1, m2);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        const float yh = (xv[j] - mu) * rs;
        const float dx2 = gv[j] + rs * (dy[j] * ln2_s[c] - m1 - yh * m2);
        const T t = from_f<T>(dx2);
        DX2[r * ld2 + c] = dx2;
        G[r * ldg + c] = t;
        dx2_out[static_cast<long long>(r) * d + c] = t;
        part[0][j] += dy[j] * yh;
        part[1][j] += dy[j];
        part[2][j] += dx2;
      }
    }
    colsum_parts(part, S, grads);
  }

  // kernel I's LN1 backward: dx = dx2 + LN1'(dy1) into out; the ln1_s and
  // ln1_b column sums
  template <int CPL>
  __device__ __forceinline__ void ln1_back_rows_at(
      long long base, const float* mu1, const float* rs1,
      float* const (&grads)[2]) const {
    constexpr int d = 32 * CPL;
    const int ldx = p.ld[kXR], lddy = p.ld[kDY], ld2 = p.ld[kDX2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float part[2][CPL] = {};
    for (int r = warp; r < p.s; r += kWarps) {
      float dy[CPL], xv[CPL], d2[CPL], m1, m2;
      row_load(dy, [&](int c) { return DY[r * lddy + c]; });
      row_load(xv, [&](int c) { return XR[r * ldx + c]; });
      row_load(d2, [&](int c) { return DX2[r * ld2 + c]; });
      const float mu = mu1[r], rs = rs1[r];
      row_ln_means(dy, xv, mu, rs, ln1_s, m1, m2);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        const float yh = (xv[j] - mu) * rs;
        store_x(p.out, base + static_cast<long long>(r) * d + c, p.x_bf16,
                d2[j] + rs * (dy[j] * ln1_s[c] - m1 - yh * m2));
        part[0][j] += dy[j] * yh;
        part[1][j] += dy[j];
      }
    }
    colsum_parts(part, S, grads);
  }

  // XR = x's rows as fp32, zero past s
  __device__ void load_rows(int img) const {
    const int d = p.d, ldx = p.ld[kXR];
    const long long base = static_cast<long long>(img) * p.s * d;
    tile_each(p.sp, d, [&](int r, int c) {
      XR[r * ldx + c] =
          r < p.s ? load_x(p.x, base + static_cast<long long>(r) * d + c,
                           p.x_bf16)
                  : 0.f;
    });
  }

  // Y = T(LN(XR) * scale + bias), a warp per row; rows past s are zero.
  // Keeps (mean, 1/std) per row in `mu`, `rs` when given.
  __device__ void layer_norm(const float* scale, const float* bias, float* mu,
                             float* rs) const {
    const int d = p.d, ldx = p.ld[kXR], ldy = p.ld[kY];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < p.sp; r += kWarps) {
      const float* xr = XR + r * ldx;
      T* yr = Y + r * ldy;
      if (r >= p.s) {
        for (int c = lane; c < d; c += 32) yr[c] = from_f<T>(0.f);
        if (lane == 0 && mu != nullptr) mu[r] = rs[r] = 0.f;
        continue;
      }
      float a = 0.f;
      for (int c = lane; c < d; c += 32) a += xr[c];
      const float m = warp_sum(a) / d;
      a = 0.f;
      for (int c = lane; c < d; c += 32) a += (xr[c] - m) * (xr[c] - m);
      const float r1 = 1.f / sqrtf(warp_sum(a) / d + kLnEps);
      for (int c = lane; c < d; c += 32)
        yr[c] = from_f<T>((xr[c] - m) * r1 * scale[c] + bias[c]);
      if (lane == 0 && mu != nullptr) {
        mu[r] = m;
        rs[r] = r1;
      }
    }
  }

  // QKV = T(Y . Wqkv[head rows]^T + bqkv[head]) as [q | k | v], (sp, 3 hd)
  __device__ void qkv_head(int hi) const {
    const int d = p.d, hd = p.hd, lds = p.ld[kS], ldq = p.ld[kQKV];
    if (W0 != nullptr) {
      // three staged blocks: the head's q, k and v rows of wqkv
      staged_rows<false>(S, lds, Y, p.ld[kY], wqkv, 3,
                         [&](int j) { return j * d + hi * hd; });
    } else {
      // three segments: the head's q, k and v rows of wqkv, d * d apart
      gemm<T, false, true, false>(S, lds, Y, p.ld[kY], wqkv + hi * hd * d, d,
                                  p.sp, hd, d, true, 0,
                                  Segments{3, 0, 1LL * d * d, hd});
      __syncthreads();
    }
    tile_cols(
        p.sp, 3 * hd,
        [&](int c) { return bqkv[(c / hd) * d + hi * hd + c % hd]; },
        [&](int r, int c, float b) {
          const T v = from_f<T>(S[r * lds + c] + b);
          QKV[r * ldq + c] = v;
          if constexpr (FAST) {
            if (stash != nullptr) stash_qkv(hi)[r * ldq + c] = v;
          }
        });
    __syncthreads();
  }

  // S[:, :sp] = softmax((q . k^T) * scale [+ causal penalty]) in fp32 and
  // P = T(it); key columns past s get no mass. Kernel I also stashes both
  // (head hi).
  __device__ void probabilities(int hi) const {
    const int hd = p.hd, sp = p.sp, lds = p.ld[kS], ldq = p.ld[kQKV];
    const int ldp = p.ld[kP];
    mm<false, true, false>(S, lds, QKV, ldq, QKV + hd, ldq, sp, sp, hd);
    __syncthreads();
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < sp; r += kWarps) {
      float* sr = S + r * lds;
      float m = -INFINITY;
      for (int c = lane; c < sp; c += 32) {
        float v = sr[c] * scale;
        if (p.causal && c > r) v += kMasked;
        if (c >= p.s) v = -INFINITY;
        sr[c] = v;
        m = fmaxf(m, v);
      }
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < sp; c += 32) {
        const float e = expf(sr[c] - m);
        sr[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < sp; c += 32) {
        const float pr = sr[c] / sum;
        sr[c] = pr;
        P[r * ldp + c] = from_f<T>(pr);
        if constexpr (FAST) {
          if (stash != nullptr) {
            stash_p(hi)[r * sp + c] = pr;
            stash_P(hi)[r * ldp + c] = from_f<T>(pr);
          }
        }
      }
    }
    __syncthreads();
  }

  // the forward up to x2: Y = y1, O = the heads' outputs, XR = x2
  __device__ void attention_forward(int img, float* mu1, float* rs1) const {
    const int d = p.d, hd = p.hd, sp = p.sp, lds = p.ld[kS];
    const int ldq = p.ld[kQKV], ldo = p.ld[kO], ldx = p.ld[kXR];
    bool fast = false;   // kernel I's row passes: bproj goes in up front
    if constexpr (FAST) {
      fast = rows_fast();
      if (fast) ln1_rows(img, true, mu1, rs1, nullptr);
    }
    if (!fast) {
      load_rows(img);
      __syncthreads();
      layer_norm(ln1_s, ln1_b, mu1, rs1);
    }
    __syncthreads();
    for (int hi = 0; hi < p.h; ++hi) {
      qkv_head(hi);
      probabilities(hi);
      mm<false, false, false>(S, lds, P, p.ld[kP], QKV + 2 * hd, ldq, sp,
                              hd, sp);
      __syncthreads();
      tile_each(sp, hd, [&](int r, int c) {
        O[r * ldo + hi * hd + c] = from_f<T>(S[r * lds + c]);
      });
      __syncthreads();
    }
    if (W0 != nullptr) {
      // x2 += o_all . wproj^T in d / hd staged blocks of wproj's rows
      staged_rows<true>(XR, ldx, O, ldo, wproj, d / hd,
                        [&](int j) { return j * hd; });
    } else {
      gemm<T, false, true, true>(XR, ldx, O, ldo, wproj, d, sp, d, d, true);
      __syncthreads();
    }
    if (!fast) {
      tile_cols(
          sp, d, [&](int c) { return bproj[c]; },
          [&](int r, int c, float b) { XR[r * ldx + c] += b; });
      __syncthreads();
    }
  }
};

// q.mm, spelled without the `template` keyword a dependent call needs
template <bool ACOL, bool BCOL, bool ACC, typename Q, typename T>
__device__ __forceinline__ void smm(const Q& q, float* C, int ldc, const T* A,
                                    int lda, const T* B, int ldb, int M,
                                    int N, int K, bool strip = false,
                                    int shift = 0) {
  q.template mm<ACOL, BCOL, ACC>(C, ldc, A, lda, B, ldb, M, N, K, strip,
                                 shift);
}

// ------------------------------------------------------------ kernel H
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_encoder_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char fe_smem[];
  const Seq<T> q(p, fe_smem);
  const int d = p.d, sp = p.sp, lds = p.ld[kS], ldq = p.ld[kQKV];
  const int ldx = p.ld[kXR], ldy = p.ld[kY];
  for (int img = blockIdx.x; img < p.imgs; img += gridDim.x) {
    q.attention_forward(img, nullptr, nullptr);
    q.layer_norm(q.ln2_s, q.ln2_b, nullptr, nullptr);
    __syncthreads();
    for (int c0 = 0; c0 < p.mlp; c0 += p.chunk) {
      const int n = min(p.chunk, p.mlp - c0);
      gemm<T, false, true, false>(q.S, lds, q.Y, ldy, q.w_in + c0 * d, d, sp,
                                  n, d, true);
      __syncthreads();
      tile_cols(
          sp, n, [&](int c) { return q.b_in[c0 + c]; },
          [&](int r, int c, float b) {
            const float hp = q.S[r * lds + c] + b;
            const float th = tanhf(kGeluC * (hp + kGeluA * hp * hp * hp));
            q.QKV[r * ldq + c] = from_f<T>(0.5f * hp * (1.f + th));
          });
      __syncthreads();
      gemm<T, false, true, true>(q.XR, ldx, q.QKV, ldq, q.w_out + c0, p.mlp,
                                 sp, d, n, true);
      __syncthreads();
    }
    const long long base = static_cast<long long>(img) * p.s * d;
    tile_cols(
        p.s, d, [&](int c) { return q.b_out[c]; },
        [&](int r, int c, float b) {
          store_x(p.out, base + static_cast<long long>(r) * d + c, p.x_bf16,
                  q.XR[r * ldx + c] + b);
        });
    __syncthreads();
  }
}

// ------------------------------------------------------------ kernel I
// d(LN input) for one row given d(LN affine output) `dya`, the LN input
// `xin`, its statistics and the scale; a warp per row, result through
// `emit(c, value)`.
template <typename Emit>
__device__ __forceinline__ void ln_backward_row(const float* dya,
                                                const float* xin, float mu,
                                                float rs, const float* scale,
                                                int d, int lane, Emit emit) {
  float a1 = 0.f, a2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dxh = dya[c] * scale[c];
    a1 += dxh;
    a2 += dxh * ((xin[c] - mu) * rs);
  }
  const float m1 = warp_sum(a1) / d, m2 = warp_sum(a2) / d;
  for (int c = lane; c < d; c += 32) {
    const float yh = (xin[c] - mu) * rs;
    emit(c, rs * (dya[c] * scale[c] - m1 - yh * m2));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_encoder_bwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char fe_smem[];
  const Seq<T, true> q(p, fe_smem);
  const int d = p.d, hd = p.hd, sp = p.sp, s = p.s, mlp = p.mlp, ch = p.chunk;
  const int lds = p.ld[kS], ldq = p.ld[kQKV], ldx = p.ld[kXR];
  const int ldy = p.ld[kY], ldo = p.ld[kO], ldg = p.ld[kG], lddy = p.ld[kDY];
  const int ldp = p.ld[kP], ldds = p.ld[kDS], ld2 = p.ld[kDX2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool fast = q.rows_fast();
  // the MLP chunk's products and GELU in one pass (mlp_gelu_sm): bf16 with
  // Y, G and the weight slots in shared memory; then dy2 and dy1 as whole
  // reductions over the stored operands (gemm_kloop) where QKV (its A
  // slots) lies in shared memory and a warp's tiles fit its registers
  const bool mlp_fused = std::is_same<T, bf16>::value && q.w_smem &&
                         !p.loc[kY] && !p.loc[kG];
  const bool kloop = mlp_fused && !p.loc[kQKV] &&
                     (sp / 16) * (d / 16) <= 4 * kWarps;
  float* mu1 = q.stats;
  float* rs1 = mu1 + sp;
  float* mu2 = rs1 + sp;
  float* rs2 = mu2 + sp;
  // this block's partial of the 8 vector grads, in the wrapper's order,
  // zeroed here; the weight grads leave through the operands below
  float* vp = p.vpart + blockIdx.x * p.vsz;
  for (int i = threadIdx.x; i < p.vsz; i += kThreads) vp[i] = 0.f;
  float* g_ln1_s = vp;
  float* g_ln1_b = g_ln1_s + d;
  float* g_bqkv = g_ln1_b + d;
  float* g_bproj = g_bqkv + 3 * d;
  float* g_ln2_s = g_bproj + d;
  float* g_ln2_b = g_ln2_s + d;
  float* g_b_in = g_ln2_b + d;
  float* g_b_out = g_b_in + mlp;
  T* op_y1 = static_cast<T*>(p.ops[kOpY1]);
  T* op_dqkv = static_cast<T*>(p.ops[kOpDQKV]);
  T* op_o = static_cast<T*>(p.ops[kOpO]);
  T* op_dx2 = static_cast<T*>(p.ops[kOpDX2]);
  T* op_hg = static_cast<T*>(p.ops[kOpHG]);
  T* op_dh = static_cast<T*>(p.ops[kOpDH]);
  T* op_y2 = static_cast<T*>(p.ops[kOpY2]);
  __syncthreads();

  for (int img = blockIdx.x; img < p.imgs; img += gridDim.x) {
    const long long base = static_cast<long long>(img) * s * d;
    const long long tok = static_cast<long long>(img) * s;   // first token
    // ---- recompute: Y = y1, O = o_all, XR = x2, then Y = y2
    q.attention_forward(img, mu1, rs1);
    // Y = y2 with its statistics (also into its operand), G = T(g) (zero
    // past s), the b_out column sums
    if (fast) {
      with_cpl(d, [&](auto cpl) {
        q.template ln2_rows_at<decltype(cpl)::value>(base, mu2, rs2,
                                                     op_y2 + tok * d,
                                                     g_b_out);
      });
    } else {
      q.layer_norm(q.ln2_s, q.ln2_b, mu2, rs2);
      tile_each(sp, d, [&](int r, int c) {
        q.G[r * ldg + c] = from_f<T>(
            r < s ? load_x(p.g, base + static_cast<long long>(r) * d + c,
                           p.x_bf16)
                  : 0.f);
      });
      colsum_add(g_b_out, d, s, [&](int r, int c) {
        return load_x(p.g, base + static_cast<long long>(r) * d + c,
                      p.x_bf16);
      });
      __syncthreads();
      tile_each(s, d, [&](int r, int c) {
        op_y2[(tok + r) * d + c] = q.Y[r * ldy + c];
      });
    }
    // the weight grads' operand o_all
    tile_each(s, d, [&](int r, int c) {
      op_o[(tok + r) * d + c] = q.O[r * ldo + c];
    });

    // ---- MLP branch, `ch` columns at a time. kloop: W0 = w_in[c0:c0+n, :]
    // and W1 = w_out[:, c0:c0+n] for the chunk's products and GELU, the
    // next chunk's blocks copied while this one's b_in sums run; then dy2
    // = dh . w_in over all mlp columns (gemm_kloop)
    if constexpr (std::is_same<T, bf16>::value) {
      if (kloop) {
        stage_w(q.W1, q.pw_col, q.w_out, mlp, d, min(ch, mlp), q.w_smem);
        stage_w(q.W0, q.pw_row, q.w_in, d, min(ch, mlp), d, q.w_smem);
        for (int c0 = 0; c0 < mlp; c0 += ch) {
          const int n = min(ch, mlp - c0);
          STAGE_SYNC();
          mlp_gelu_sm(q.Y, ldy, q.W0, q.pw_row, q.G, ldg, q.W1, q.pw_col,
                      q.b_in + c0, sp, n, d, nullptr, 0, q.S + ch, lds, s,
                      op_hg + tok * mlp + c0, op_dh + tok * mlp + c0, mlp);
          __syncthreads();
          if (c0 + ch < mlp) {
            const int nn = min(ch, mlp - c0 - ch);
            stage_w(q.W0, q.pw_row,
                    q.w_in + static_cast<long long>(c0 + ch) * d, d, nn, d,
                    q.w_smem);
            stage_w(q.W1, q.pw_col, q.w_out + c0 + ch, mlp, d, nn, q.w_smem);
          }
          colsum_add(g_b_in + c0, n, sp,
                     [&](int r, int c) { return q.S[r * lds + ch + c]; });
        }
        gemm_kloop_any(q.DY, lddy, op_dh + tok * mlp, mlp, s, q.w_in, d, sp,
                       d, mlp, q.QKV, q.W0, q.W1, q.pw_row);
      }
    }
    if (!kloop) {
      // S = [hpre | dhg] (or the fused pass), the GELU pass, then
      // dy2 (+)= dh . w_in[c0:, :] a chunk at a time. W0 holds
      // w_in[c0:c0+n, :], W1 w_out[:, c0:c0+n] (the next chunk's is copied
      // while this chunk's GELU pass and dy2 product run)
      stage_w(q.W1, q.pw_col, q.w_out, mlp, d, min(ch, mlp), q.w_smem);
      for (int c0 = 0; c0 < mlp; c0 += ch) {
        const int n = min(ch, mlp - c0);
        T* DH = q.QKV + ch;
        stage_w(q.W0, q.pw_row, q.w_in + static_cast<long long>(c0) * d, d,
                n, d, q.w_smem);
        STAGE_SYNC();
        if constexpr (std::is_same<T, bf16>::value) {
          if (mlp_fused)
            mlp_gelu_sm(q.Y, ldy, q.W0, q.pw_row, q.G, ldg, q.W1, q.pw_col,
                        q.b_in + c0, sp, n, d, DH, ldq, q.S + ch, lds, s,
                        op_hg + tok * mlp + c0, op_dh + tok * mlp + c0, mlp);
        }
        if (!mlp_fused) {
          smm<false, true, false>(q, q.S, lds, q.Y, ldy, q.W0, q.pw_row, sp,
                                  n, d);
          smm<false, false, false>(q, q.S + ch, lds, q.G, ldg, q.W1,
                                   q.pw_col, sp, n, d);
        }
        __syncthreads();
        if (c0 + ch < mlp)   // dhg is done with W1
          stage_w(q.W1, q.pw_col, q.w_out + c0 + ch, mlp, d,
                  min(ch, mlp - c0 - ch), q.w_smem);
        if (!mlp_fused) {
          // hg = T(gelu(hpre)), dh = dhg gelu'(hpre): two neighbouring
          // columns a lane (lanes walk column pairs, warps the rows)
          for (int c = 2 * lane; c < n; c += 64) {
            const float b0 = q.b_in[c0 + c], b1 = q.b_in[c0 + c + 1];
#pragma unroll 4
            for (int r = warp; r < sp; r += kWarps) {
              float* sr = q.S + r * lds;
              const float2 hp2 = *reinterpret_cast<const float2*>(sr + c);
              const float2 dg2 =
                  *reinterpret_cast<const float2*>(sr + ch + c);
              float hg[2], dh[2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float hp = (i ? hp2.y : hp2.x) + (i ? b1 : b0);
                const float th =
                    tanhf(kGeluC * (hp + kGeluA * hp * hp * hp));
                const float grad = 0.5f * (1.f + th) +
                                   0.5f * hp * (1.f - th * th) * kGeluC *
                                       (1.f + 3.f * kGeluA * hp * hp);
                hg[i] = 0.5f * hp * (1.f + th);
                dh[i] = (i ? dg2.y : dg2.x) * grad;
              }
              store_pair(DH + r * ldq + c, dh[0], dh[1]);
              *reinterpret_cast<float2*>(sr + ch + c) =
                  make_float2(dh[0], dh[1]);
              if (r < s) {
                store_pair(op_hg + (tok + r) * mlp + c0 + c, hg[0], hg[1]);
                store_pair(op_dh + (tok + r) * mlp + c0 + c, dh[0], dh[1]);
              }
            }
          }
          __syncthreads();
        }
        colsum_add(g_b_in + c0, n, sp,
                   [&](int r, int c) { return q.S[r * lds + ch + c]; });
        // dy2 (+)= dh . w_in[c0:, :] (the first chunk's product writes DY)
        if (c0 == 0)
          smm<false, false, false>(q, q.DY, lddy, DH, ldq, q.W0, q.pw_row, sp,
                                   d, n);
        else
          smm<false, false, true>(q, q.DY, lddy, DH, ldq, q.W0, q.pw_row, sp,
                                  d, n);
        __syncthreads();
      }
    }

    // ---- LN2 backward: dx2 = g + LN'(dy2); G = T(dx2), DX2 = dx2; then
    // XR = x again and Y = y1 again (also into its operand)
    if (fast) {
      float* const grads[3] = {g_ln2_s, g_ln2_b, g_bproj};
      with_cpl(d, [&](auto cpl) {
        q.template ln2_back_rows_at<decltype(cpl)::value>(
            base, mu2, rs2, op_dx2 + tok * d, grads);
      });
      q.ln1_rows(img, false, nullptr, nullptr, op_y1 + tok * d);
      __syncthreads();
    } else {
      colsum_add(g_ln2_s, d, s, [&](int r, int c) {
        return q.DY[r * lddy + c] * ((q.XR[r * ldx + c] - mu2[r]) * rs2[r]);
      });
      colsum_add(g_ln2_b, d, s,
                 [&](int r, int c) { return q.DY[r * lddy + c]; });
      for (int r = warp; r < sp; r += kWarps) {
        if (r >= s) {
          for (int c = lane; c < d; c += 32) {
            q.G[r * ldg + c] = from_f<T>(0.f);
            q.DX2[r * ld2 + c] = 0.f;
          }
          continue;
        }
        ln_backward_row(
            q.DY + r * lddy, q.XR + r * ldx, mu2[r], rs2[r], q.ln2_s, d, lane,
            [&](int c, float v) {
              const float dx2 =
                  load_x(p.g, base + static_cast<long long>(r) * d + c,
                         p.x_bf16) +
                  v;
              const T t = from_f<T>(dx2);
              q.DX2[r * ld2 + c] = dx2;
              q.G[r * ldg + c] = t;
              op_dx2[(tok + r) * d + c] = t;
            });
      }
      __syncthreads();
      colsum_add(g_bproj, d, s,
                 [&](int r, int c) { return q.DX2[r * ld2 + c]; });
      q.load_rows(img);
      __syncthreads();
      q.layer_norm(q.ln1_s, q.ln1_b, nullptr, nullptr);
      __syncthreads();
      tile_each(s, d, [&](int r, int c) {
        op_y1[(tok + r) * d + c] = q.Y[r * ldy + c];
      });
    }

    // ---- attention branch: x2 = x + o_all . Wproj^T + bproj
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    for (int hi = 0; hi < p.h; ++hi) {
      // the recompute's q|k|v and P of this head back from the stash, in
      // flight with dO's weight block
      copy_rows(q.QKV, ldq * sizeof(T), q.stash_qkv(hi), ldq * sizeof(T), sp,
                3 * hd * sizeof(T));
      copy_rows(q.P, ldp * sizeof(T), q.stash_P(hi), ldp * sizeof(T), sp,
                sp * sizeof(T));
      // O[:, head] = T(do) = T(dx2 . Wproj[:, head])
      stage_w(q.W0, q.pw_col, q.wproj + hi * hd, d, d, hd, q.w_smem);
      STAGE_SYNC();
      smm<false, false, false>(q, q.S, lds, q.G, ldg, q.W0, q.pw_col, sp, hd,
                               d);
      __syncthreads();
      T* DO = q.O + hi * hd;
      tile_each(sp, hd, [&](int r, int c) {
        DO[r * ldo + c] = from_f<T>(q.S[r * lds + c]);
      });
      __syncthreads();
      // S[:, :sp] = p, after DO's pass read S
      copy_rows(q.S, lds * sizeof(float), q.stash_p(hi), sp * sizeof(float),
                sp, sp * sizeof(float));
      STAGE_SYNC();
      const T* Q = q.QKV;
      const T* K = q.QKV + hd;
      const T* V = q.QKV + 2 * hd;
      // dp = do . v^T into S[:, sp:2sp]
      smm<false, true, false>(q, q.S + sp, lds, DO, ldo, V, ldq, sp, sp, hd);
      __syncthreads();
      // dsc = p (dp - sum(dp p)) * scale; DS = T(dsc)
      for (int r = warp; r < sp; r += kWarps) {
        const float* pr = q.S + r * lds;
        const float* dp = pr + sp;
        float a = 0.f;
        for (int c = lane; c < sp; c += 32) a += dp[c] * pr[c];
        a = warp_sum(a);
        for (int c = lane; c < sp; c += 32)
          q.DS[r * ldds + c] = from_f<T>(pr[c] * (dp[c] - a) * scale);
      }
      __syncthreads();
      // S = [dq | dk | dv] = [dsc . k | dsc^T . q | p^T . do]
      smm<false, false, false>(q, q.S, lds, q.DS, ldds, K, ldq, sp, hd, sp);
      smm<true, false, false>(q, q.S + hd, lds, q.DS, ldds, Q, ldq, sp, hd,
                              sp);
      smm<true, false, false>(q, q.S + 2 * hd, lds, q.P, ldp, DO, ldo, sp, hd,
                              sp);
      __syncthreads();
      // bias grads from the fp32 pieces (the head's q, k and v columns of
      // bqkv), then T(dqkv) into the (tokens, 3d) operand (and into QKV for
      // the per-head dy1 products unless kloop)
      colsum_add_at(
          3 * hd, sp, [&](int r, int c) { return q.S[r * lds + c]; },
          [&](int c) { return g_bqkv + (c / hd) * d + hi * hd + c % hd; });
      tile_each(sp, 3 * hd, [&](int r, int c) {
        const T t = from_f<T>(q.S[r * lds + c]);
        if (!kloop) q.QKV[r * ldq + c] = t;
        if (r < s)
          op_dqkv[(tok + r) * 3 * d + (c / hd) * d + hi * hd + c % hd] = t;
      });
      __syncthreads();
      // dy1 (+)= dqkv . wqkv[rows] (the first head's first product writes
      // DY): the three products map each tile of DY to the same warp (or
      // thread), so none needs a block barrier before the next (the copy
      // pipeline's barriers are there anyway). kloop: after the heads.
      if (!kloop)
        stage_w(q.W0, q.pw_row, q.wqkv + static_cast<long long>(hi * hd) * d,
                d, hd, d, q.w_smem);
      for (int j = 0; j < 3 && !kloop; ++j) {
        const T* w = q.wqkv + static_cast<long long>(j * d + hi * hd) * d;
        STAGE_SYNC();
        if (j < 2)
          stage_w((j + 1) & 1 ? q.W1 : q.W0, q.pw_row, w + 1LL * d * d, d, hd,
                  d, q.w_smem);
        w = j & 1 ? q.W1 : q.W0;
        if (hi == 0 && j == 0)
          smm<false, false, false>(q, q.DY, lddy, q.QKV, ldq, w, q.pw_row, sp,
                                   d, hd);
        else
          smm<false, false, true>(q, q.DY, lddy, q.QKV + j * hd, ldq, w,
                                  q.pw_row, sp, d, hd);
      }
      if (!kloop) __syncthreads();
    }
    if constexpr (std::is_same<T, bf16>::value) {
      if (kloop)   // dy1 = dqkv . wqkv over all 3d columns
        gemm_kloop_any(q.DY, lddy, op_dqkv + tok * 3 * d, 3 * d, s, q.wqkv,
                       d, sp, d, 3 * d, q.QKV, q.W0, q.W1, q.pw_row);
    }

    // ---- LN1 backward and dx = dx2 + LN'(dy1)
    if (fast) {
      float* const grads[2] = {g_ln1_s, g_ln1_b};
      with_cpl(d, [&](auto cpl) {
        q.template ln1_back_rows_at<decltype(cpl)::value>(base, mu1, rs1,
                                                          grads);
      });
    } else {
      colsum_add(g_ln1_s, d, s, [&](int r, int c) {
        return q.DY[r * lddy + c] * ((q.XR[r * ldx + c] - mu1[r]) * rs1[r]);
      });
      colsum_add(g_ln1_b, d, s,
                 [&](int r, int c) { return q.DY[r * lddy + c]; });
      for (int r = warp; r < s; r += kWarps)
        ln_backward_row(q.DY + r * lddy, q.XR + r * ldx, mu1[r], rs1[r],
                        q.ln1_s, d, lane, [&](int c, float v) {
                          store_x(p.out,
                                  base + static_cast<long long>(r) * d + c,
                                  p.x_bf16, q.DX2[r * ld2 + c] + v);
                        });
      __syncthreads();
    }
  }
}

// out[i] = sum over blocks, in block order, of partial[b][i] (kernel I's
// vector-grad partials)
__global__ void fused_encoder_reduce_kernel(const float* partial, float* out,
                                            long long n, int blocks) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int b = 0; b < blocks; ++b) a += partial[b * n + i];
  out[i] = a;
}

Params make_params(const void* x, const void* g, void* out, const void* mats,
                   const void* vecs, void* scratch, void* vpart,
                   void* const* ops, const long long* table, int imgs, int s,
                   int d, int h, int mlp, int causal, int x_dtype,
                   long long scratch_bytes, int chunk) {
  Params p;
  p.x = x;
  p.g = g;
  p.out = out;
  p.mats = mats;
  p.vecs = static_cast<const float*>(vecs);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.vpart = static_cast<float*>(vpart);
  p.stash = nullptr;
  p.stash_bytes = 0;
  for (int i = 0; i < kOps; ++i) p.ops[i] = ops == nullptr ? nullptr : ops[i];
  for (int b = 0; b < kBuffers; ++b) {
    p.off[b] = table[b];
    p.loc[b] = static_cast<int>(table[kBuffers + b]);
    p.ld[b] = static_cast<int>(table[2 * kBuffers + b]);
  }
  p.scratch_bytes = scratch_bytes;
  p.vsz = 9LL * d + mlp;
  p.imgs = imgs;
  p.s = s;
  p.sp = (s + 15) / 16 * 16;
  p.d = d;
  p.h = h;
  p.hd = d / h;
  p.mlp = mlp;
  p.causal = causal;
  p.x_bf16 = x_dtype;
  p.chunk = chunk;
  return p;
}

template <typename K>
int launch(K kernel, const Params& p, int grid, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtypes: 0 float32, 1 bfloat16. `table` is the plan: kBuffers offsets, then
// kBuffers locations, then kBuffers row pitches. Returns a cudaError_t.
extern "C" int fused_encoder_fwd(const void* x, void* out, const void* mats,
                                 const void* vecs, void* scratch,
                                 const long long* table, int imgs, int s,
                                 int d, int h, int mlp, int causal,
                                 int x_dtype, int compute_dtype, int grid,
                                 int smem_bytes, long long scratch_bytes,
                                 int chunk, void* stream) {
  const Params p =
      make_params(x, nullptr, out, mats, vecs, scratch, nullptr, nullptr,
                  table, imgs, s, d, h, mlp, causal, x_dtype, scratch_bytes,
                  chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (compute_dtype == 1)
    return launch(fused_encoder_fwd_kernel<bf16>, p, grid, smem_bytes, st);
  return launch(fused_encoder_fwd_kernel<float>, p, grid, smem_bytes, st);
}

// Kernel I's per-sequence pass and the reduction of its vector grads: dx,
// vec_grads (9d + mlp fp32: ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b_in,
// b_out), and the weight grads' operands into ops (kOps pointers, each
// (imgs * s, width) in the compute dtype; ops/fused_encoder.py multiplies
// them with kernel K). vpart: (grid, 9d + mlp) fp32, any contents; stash:
// stash_bytes a block, h x (sp rows of QKV's and P's pitches in the compute
// dtype, sp x sp fp32), any contents.
extern "C" int fused_encoder_bwd(const void* x, const void* g, void* dx,
                                 const void* mats, const void* vecs,
                                 void* scratch, void* vpart, void* vec_grads,
                                 void* const* ops, void* stash,
                                 long long stash_bytes, const long long* table,
                                 int imgs, int s, int d, int h, int mlp,
                                 int causal, int x_dtype, int compute_dtype,
                                 int grid, int smem_bytes,
                                 long long scratch_bytes, int chunk,
                                 void* stream) {
  Params p =
      make_params(x, g, dx, mats, vecs, scratch, vpart, ops, table, imgs, s,
                  d, h, mlp, causal, x_dtype, scratch_bytes, chunk);
  p.stash = static_cast<unsigned char*>(stash);
  p.stash_bytes = stash_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      compute_dtype == 1
          ? launch(fused_encoder_bwd_kernel<bf16>, p, grid, smem_bytes, st)
          : launch(fused_encoder_bwd_kernel<float>, p, grid, smem_bytes, st);
  if (rc != 0) return rc;
  const int threads = 256;
  const int blocks = static_cast<int>((p.vsz + threads - 1) / threads);
  fused_encoder_reduce_kernel<<<blocks, threads, 0, st>>>(
      p.vpart, static_cast<float*>(vec_grads), p.vsz, grid);
  return static_cast<int>(cudaGetLastError());
}
