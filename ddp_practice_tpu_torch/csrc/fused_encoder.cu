// Fused pre-LN transformer encoder layer for sm_90a, forward and backward:
// one launch per direction. Built with nvcc into a shared library with a
// plain C interface (ddp_practice_tpu_torch/ops/cuda_build.py) and launched
// through ctypes by ddp_practice_tpu_torch/ops/fused_encoder.py.
//
// Replaces the Pallas TPU kernels of ddp_practice_tpu/ops/fused_encoder.py:
//   kernel H (fused_encoder_fwd_kernel): _fused_kernel -> _fwd_core, reached
//     from fused_encoder_forward;
//   kernel I (fused_encoder_bwd_kernel, then fused_encoder_reduce_kernel):
//     _fused_bwd_kernel, reached from fused_encoder_backward.
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
// Design (a simple first kernel). A persistent block of 512 threads takes
// sequences blockIdx.x, blockIdx.x + gridDim.x, ... one at a time. The
// sequence's operands (LN output, a head's q|k|v, probabilities, an fp32
// staging tile) live in shared memory as far as it reaches; the wrapper's
// plan sends what does not fit to a per-block scratch in global memory, and
// every buffer is reached through a generic pointer, so the code is the same
// for both. Weight tiles are read straight from global memory (the layer's
// weights stay in the L2). One block-wide product primitive serves all of
// them: bf16 through WMMA (mma.sync 16x16x16, fp32 accumulation; a warp owns
// one 16-wide column strip of up to 4 row tiles and reuses each B fragment
// across them), fp32 as FMAs over 4x4 patches (TF32 would break the fp32
// tolerances). Rows are padded to a multiple of 16 with zero cotangents and
// masked keys, so any sequence length runs. No wgmma, TMA or async copies
// yet.
//
// Weight grads: each block adds its sequences' contributions into its own
// fp32 partial (all 12 grads, one flat vector) in global memory, and the
// reduce kernel sums the partials in block order, so the grads are the same
// bits on every run (no atomics).

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

// one sequence's buffers, in the wrapper's order (ops/fused_encoder.py _plan)
enum Buf {
  kStats = 0, kS, kQKV, kP, kDS, kY, kO, kG, kDY, kXR, kDX2, kBuffers
};

struct Params {
  const void* x;        // (imgs, s, d) in x's dtype
  const void* g;        // backward: the cotangent, in x's dtype
  void* out;            // forward: the layer's output; backward: dx
  const void* mats;     // T: wqkv (3d, d) | wproj (d, d) | w_in (mlp, d) |
                        //    w_out (d, mlp)
  const float* vecs;    // ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b_in, b_out
  unsigned char* scratch;
  float* partial;       // backward: (grid, psz) fp32
  long long off[kBuffers];
  int loc[kBuffers];    // 0: shared memory, 1: the block's scratch
  int ld[kBuffers];     // row pitch in elements
  long long scratch_bytes, psz;
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

// dst[c] += sum over rows of f(r, c): G neighbouring lanes share a column
// (G = 8, 4, 2 or 1, as many as the block has threads for), each sums every
// G-th row, and a shuffle tree adds them up in a fixed order
template <typename F>
__device__ __forceinline__ void colsum_add(float* dst, int n, int rows, F f) {
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
    if (c < n && sub == 0) dst[c] += a;
  }
}

// ---------------------------------------------------------- one sequence
template <typename T> struct Seq {
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
    // three segments: the head's q, k and v rows of wqkv, d * d apart
    gemm<T, false, true, false>(S, lds, Y, p.ld[kY], wqkv + hi * hd * d, d,
                                p.sp, hd, d, true, 0,
                                Segments{3, 0, 1LL * d * d, hd});
    __syncthreads();
    tile_cols(
        p.sp, 3 * hd,
        [&](int c) { return bqkv[(c / hd) * d + hi * hd + c % hd]; },
        [&](int r, int c, float b) {
          QKV[r * ldq + c] = from_f<T>(S[r * lds + c] + b);
        });
    __syncthreads();
  }

  // S[:, :sp] = softmax((q . k^T) * scale [+ causal penalty]) in fp32 and
  // P = T(it); key columns past s get no mass
  __device__ void probabilities() const {
    const int hd = p.hd, sp = p.sp, lds = p.ld[kS], ldq = p.ld[kQKV];
    const int ldp = p.ld[kP];
    gemm<T, false, true, false>(S, lds, QKV, ldq, QKV + hd, ldq, sp, sp, hd);
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
      }
    }
    __syncthreads();
  }

  // the forward up to x2: Y = y1, O = the heads' outputs, XR = x2
  __device__ void attention_forward(int img, float* mu1, float* rs1) const {
    const int d = p.d, hd = p.hd, sp = p.sp, lds = p.ld[kS];
    const int ldq = p.ld[kQKV], ldo = p.ld[kO], ldx = p.ld[kXR];
    load_rows(img);
    __syncthreads();
    layer_norm(ln1_s, ln1_b, mu1, rs1);
    __syncthreads();
    for (int hi = 0; hi < p.h; ++hi) {
      qkv_head(hi);
      probabilities();
      gemm<T, false, false, false>(S, lds, P, p.ld[kP], QKV + 2 * hd, ldq, sp,
                                   hd, sp);
      __syncthreads();
      tile_each(sp, hd, [&](int r, int c) {
        O[r * ldo + hi * hd + c] = from_f<T>(S[r * lds + c]);
      });
      __syncthreads();
    }
    gemm<T, false, true, true>(XR, ldx, O, ldo, wproj, d, sp, d, d, true);
    __syncthreads();
    tile_cols(
        sp, d, [&](int c) { return bproj[c]; },
        [&](int r, int c, float b) { XR[r * ldx + c] += b; });
    __syncthreads();
  }
};

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
  const Seq<T> q(p, fe_smem);
  const int d = p.d, hd = p.hd, sp = p.sp, s = p.s, mlp = p.mlp, ch = p.chunk;
  const int lds = p.ld[kS], ldq = p.ld[kQKV], ldx = p.ld[kXR];
  const int ldy = p.ld[kY], ldo = p.ld[kO], ldg = p.ld[kG], lddy = p.ld[kDY];
  const int ldp = p.ld[kP], ldds = p.ld[kDS], ld2 = p.ld[kDX2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mu1 = q.stats;
  float* rs1 = mu1 + sp;
  float* mu2 = rs1 + sp;
  float* rs2 = mu2 + sp;
  // this block's partial of the 12 grads, in the wrapper's order (the
  // wrapper hands it over zeroed)
  float* part = p.partial + blockIdx.x * p.psz;
  float* g_ln1_s = part;
  float* g_ln1_b = g_ln1_s + d;
  float* g_wqkv = g_ln1_b + d;
  float* g_bqkv = g_wqkv + 3 * d * d;
  float* g_wproj = g_bqkv + 3 * d;
  float* g_bproj = g_wproj + d * d;
  float* g_ln2_s = g_bproj + d;
  float* g_ln2_b = g_ln2_s + d;
  float* g_w_in = g_ln2_b + d;
  float* g_b_in = g_w_in + mlp * d;
  float* g_w_out = g_b_in + mlp;
  float* g_b_out = g_w_out + d * mlp;

  for (int img = blockIdx.x; img < p.imgs; img += gridDim.x) {
    const long long base = static_cast<long long>(img) * s * d;
    // ---- recompute: Y = y1, O = o_all, XR = x2, then Y = y2
    q.attention_forward(img, mu1, rs1);
    q.layer_norm(q.ln2_s, q.ln2_b, mu2, rs2);
    // G = T(g), zero past s; DY = 0
    tile_each(sp, d, [&](int r, int c) {
      const float gv =
          r < s ? load_x(p.g, base + static_cast<long long>(r) * d + c,
                         p.x_bf16)
                : 0.f;
      q.G[r * ldg + c] = from_f<T>(gv);
      q.DY[r * lddy + c] = 0.f;
    });
    colsum_add(g_b_out, d, s, [&](int r, int c) {
      return load_x(p.g, base + static_cast<long long>(r) * d + c, p.x_bf16);
    });
    __syncthreads();

    // ---- MLP branch, `ch` columns at a time: S = [hpre | dhg]
    for (int c0 = 0; c0 < mlp; c0 += ch) {
      const int n = min(ch, mlp - c0);
      T* HG = q.QKV;
      T* DH = q.QKV + ch;
      // side by side: the second call's strips go to the warps the first
      // leaves idle
      gemm<T, false, true, false>(q.S, lds, q.Y, ldy, q.w_in + c0 * d, d, sp,
                                  n, d, true);
      gemm<T, false, false, false>(q.S + ch, lds, q.G, ldg, q.w_out + c0, mlp,
                                   sp, n, d, true, n / 16);
      __syncthreads();
      tile_cols(
          sp, n, [&](int c) { return q.b_in[c0 + c]; },
          [&](int r, int c, float b) {
            const float hp = q.S[r * lds + c] + b;
            const float th = tanhf(kGeluC * (hp + kGeluA * hp * hp * hp));
            const float grad =
                0.5f * (1.f + th) + 0.5f * hp * (1.f - th * th) * kGeluC *
                                        (1.f + 3.f * kGeluA * hp * hp);
            const float dh = q.S[r * lds + ch + c] * grad;
            HG[r * ldq + c] = from_f<T>(0.5f * hp * (1.f + th));
            DH[r * ldq + c] = from_f<T>(dh);
            q.S[r * lds + ch + c] = dh;
          });
      __syncthreads();
      colsum_add(g_b_in + c0, n, sp,
                 [&](int r, int c) { return q.S[r * lds + ch + c]; });
      // strips of the first two products (4 row tiles each): the shifts
      // start each product on the warp after the previous one's last
      const int t_out = (n / 16) * ((d / 16 + 3) / 4);
      const int t_in = (d / 16) * ((n / 16 + 3) / 4);
      // dw_out[:, c0:] += g^T . hg;  dw_in[c0:, :] += dh^T . y2
      gemm<T, true, false, true>(g_w_out + c0, mlp, q.G, ldg, HG, ldq, d, n,
                                 sp);
      gemm<T, true, false, true>(g_w_in + c0 * d, d, DH, ldq, q.Y, ldy, n, d,
                                 sp, false, t_out);
      // dy2 += dh . w_in[c0:, :]
      gemm<T, false, false, true>(q.DY, lddy, DH, ldq, q.w_in + c0 * d, d, sp,
                                  d, n, true, t_out + t_in);
      __syncthreads();
    }

    // ---- LN2 backward: dx2 = g + LN'(dy2); G = T(dx2), DX2 = dx2
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
            q.DX2[r * ld2 + c] = dx2;
            q.G[r * ldg + c] = from_f<T>(dx2);
          });
    }
    __syncthreads();

    // ---- attention branch: x2 = x + o_all . Wproj^T + bproj
    colsum_add(g_bproj, d, s,
               [&](int r, int c) { return q.DX2[r * ld2 + c]; });
    gemm<T, true, false, true>(g_wproj, d, q.G, ldg, q.O, ldo, d, d, sp);
    // XR = x again, Y = y1 again, DY = 0 for dy1
    q.load_rows(img);
    tile_each(sp, d, [&](int r, int c) { q.DY[r * lddy + c] = 0.f; });
    __syncthreads();
    q.layer_norm(q.ln1_s, q.ln1_b, nullptr, nullptr);
    __syncthreads();
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    for (int hi = 0; hi < p.h; ++hi) {
      // O[:, head] = T(do) = T(dx2 . Wproj[:, head])
      gemm<T, false, false, false>(q.S, lds, q.G, ldg, q.wproj + hi * hd, d,
                                   sp, hd, d, true);
      __syncthreads();
      T* DO = q.O + hi * hd;
      tile_each(sp, hd, [&](int r, int c) {
        DO[r * ldo + c] = from_f<T>(q.S[r * lds + c]);
      });
      __syncthreads();
      q.qkv_head(hi);
      q.probabilities();                 // S[:, :sp] = p, P = T(p)
      const T* Q = q.QKV;
      const T* K = q.QKV + hd;
      const T* V = q.QKV + 2 * hd;
      // dp = do . v^T into S[:, sp:2sp]
      gemm<T, false, true, false>(q.S + sp, lds, DO, ldo, V, ldq, sp, sp, hd);
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
      gemm<T, false, false, false>(q.S, lds, q.DS, ldds, K, ldq, sp, hd, sp);
      gemm<T, true, false, false>(q.S + hd, lds, q.DS, ldds, Q, ldq, sp, hd,
                                  sp);
      gemm<T, true, false, false>(q.S + 2 * hd, lds, q.P, ldp, DO, ldo, sp,
                                  hd, sp);
      __syncthreads();
      // bias grads from the fp32 pieces, then QKV = T(dqkv)
      for (int j = 0; j < 3; ++j)
        colsum_add(g_bqkv + j * d + hi * hd, hd, sp, [&](int r, int c) {
          return q.S[r * lds + j * hd + c];
        });
      tile_each(sp, 3 * hd, [&](int r, int c) {
        q.QKV[r * ldq + c] = from_f<T>(q.S[r * lds + c]);
      });
      __syncthreads();
      // dwqkv[q, k, v rows of the head] += dqkv^T . y1, three segments
      gemm<T, true, false, true>(g_wqkv + hi * hd * d, d, q.QKV, ldq, q.Y,
                                 ldy, hd, d, sp, false, 0,
                                 Segments{3, hd, 0, 1LL * d * d});
      // dy1 += dqkv . wqkv[rows]: the three calls map each tile of DY to
      // the same warp (or thread), so no block barrier between them
      for (int j = 0; j < 3; ++j)
        gemm<T, false, false, true>(q.DY, lddy, q.QKV + j * hd, ldq,
                                    q.wqkv + (j * d + hi * hd) * d, d, sp, d,
                                    hd, true);
      __syncthreads();
    }

    // ---- LN1 backward and dx = dx2 + LN'(dy1)
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

// out[i] = sum over blocks, in block order, of partial[b][i]
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
                   const void* vecs, void* scratch, void* partial,
                   const long long* table, int imgs, int s, int d, int h,
                   int mlp, int causal, int x_dtype, long long scratch_bytes,
                   int chunk) {
  Params p;
  p.x = x;
  p.g = g;
  p.out = out;
  p.mats = mats;
  p.vecs = static_cast<const float*>(vecs);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.partial = static_cast<float*>(partial);
  for (int b = 0; b < kBuffers; ++b) {
    p.off[b] = table[b];
    p.loc[b] = static_cast<int>(table[kBuffers + b]);
    p.ld[b] = static_cast<int>(table[2 * kBuffers + b]);
  }
  p.scratch_bytes = scratch_bytes;
  p.psz = 9LL * d + 4LL * d * d + 2LL * mlp * d + mlp;
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
      make_params(x, nullptr, out, mats, vecs, scratch, nullptr, table, imgs,
                  s, d, h, mlp, causal, x_dtype, scratch_bytes, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (compute_dtype == 1)
    return launch(fused_encoder_fwd_kernel<bf16>, p, grid, smem_bytes, st);
  return launch(fused_encoder_fwd_kernel<float>, p, grid, smem_bytes, st);
}

extern "C" int fused_encoder_bwd(const void* x, const void* g, void* dx,
                                 const void* mats, const void* vecs,
                                 void* scratch, void* partial, void* grads,
                                 const long long* table, int imgs, int s,
                                 int d, int h, int mlp, int causal,
                                 int x_dtype, int compute_dtype, int grid,
                                 int smem_bytes, long long scratch_bytes,
                                 int chunk, void* stream) {
  const Params p =
      make_params(x, g, dx, mats, vecs, scratch, partial, table, imgs, s, d,
                  h, mlp, causal, x_dtype, scratch_bytes, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      compute_dtype == 1
          ? launch(fused_encoder_bwd_kernel<bf16>, p, grid, smem_bytes, st)
          : launch(fused_encoder_bwd_kernel<float>, p, grid, smem_bytes, st);
  if (rc != 0) return rc;
  const int threads = 256;
  const int blocks = static_cast<int>((p.psz + threads - 1) / threads);
  fused_encoder_reduce_kernel<<<blocks, threads, 0, st>>>(
      p.partial, static_cast<float*>(grads), p.psz, grid);
  return static_cast<int>(cudaGetLastError());
}
