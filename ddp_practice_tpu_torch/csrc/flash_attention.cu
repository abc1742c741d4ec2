// Streaming (flash) attention for sm_90a, forward and backward, over
// strided (batch, head, position, head_dim) operands. Built with nvcc into a
// shared library with a plain C interface
// (ddp_practice_tpu_torch/ops/cuda_build.py) and launched through ctypes by
// ddp_practice_tpu_torch/ops/flash_attention.py.
//
// Replaces the Pallas TPU kernels of ddp_practice_tpu/ops/flash_attention.py:
//   kernel E (flash_fwd_kernel, flash_fwd_tc_kernel): _fwd_kernel (called by
//     _flash_fwd, folded (b*h, s, d) operands) and _fwd_kernel_packed
//     (_flash_fwd_packed, flat (b, s, h*d) operands or one fused
//     (b, s, 3*h*d) projection);
//   kernel F (flash_bwd_dkdv_kernel, _tc_): _dkdv_kernel and
//     _dkdv_kernel_packed;
//   kernel G (flash_bwd_dq_kernel, _tc_): _dq_kernel and _dq_kernel_packed;
// and the reference's ablations of kernel E in experiments/
// (flash_fwd_tc_kernel<64, NH, KIND>, entry flash_fwd_variant: _fwd_v2,
// _fwd_v3, _fwd_v4, _fwd_v5 and _fwd_nomax; E's kernel with one lever
// changed, see "the forward variants" below).
// E, F and G each come in two variants: fp32 operands run the FMA kernels, bf16
// operands the tensor-core (_tc_) kernels; the arithmetic is the same.
// Every operand comes with element strides for (batch, head, position) and a
// unit head_dim stride, so the folded, packed and fused-QKV layouts are one
// kernel each: the fused layout is three column windows (offsets 0, h*d,
// 2*h*d) of one buffer, and F and G write dq, dk and dv straight into the
// windows of one (b, s, 3*h*d) gradient.
//
// What it computes, per (batch, head), with Tq the operands' dtype, scale =
// 1/sqrt(d) rounded to Tq (the reference multiplies a Tq tile by a weakly
// typed Python float) and offset = s_k - s_q under causal masking (key j is
// visible to query i iff j <= i + offset, bottom-right aligned), else 0:
//   qs    = round_Tq(q * scale)
//   s_ij  = <qs_i, k_j>                       fp32 sums; -1e30 where masked
//   forward, online over key tiles of 64 (fp32 at d=256: 32):
//     m' = max(m, rowmax s);  p = exp(s - m');  l' = exp(m - m') l + rowsum p
//     acc' = exp(m - m') acc + round_Tq(p) . v
//     out = round_Tq(acc / l);  lse = m + log(max(l, 1e-30))   (fp32)
//   backward, from the saved lse:
//     p_ij  = exp(s_ij - lse_i);  dp_ij = <do_i, v_j>
//     delta_i = sum_d do_id o_id - g_lse_i       (g_lse optional)
//     ds_ij = p_ij (dp_ij - delta_i)
//     dv_j = sum_i round_Tq(p_ij) do_i;  dk_j = sum_i round_Tq(ds_ij) qs_i
//     dq_i = round_Tq((sum_j round_Tq(ds_ij) k_j) * (1/sqrt(d)))
// These are the reference kernels' rounding points. They keep the
// accumulator normalised every step (no final divide); here it is divided
// once at the end, so an fp32 run agrees with them to summation order.
//
// Bound: at the lm_base training shape (b=8, h=12, s=2048, d=64, bf16,
// causal) operations. The forward does 4*b*h*s_q*s_k*d flops (two products),
// the backward 10*b*h*s_q*s_k*d (qk^T recomputed, p^T.do, do.v^T, ds^T.q,
// ds.k), both halved under causal masking because tiles above the diagonal
// are skipped; the bytes are each operand read once and each result written
// once (~12 MB forward, ~25 MB backward per layer), under a millisecond's
// worth of the card's 3.35 TB/s next to ~52 GFLOP forward. The peak is the
// tensor cores' 989 TFLOP/s (bf16); fp32 runs outside them at 67 TFLOP/s.
//
// Design of the fp32 E, F and G (a simple first kernel). A block of 256
// threads owns one (batch*head, 64-row tile) and streams the other
// operand's tiles through shared memory; each thread owns a 4x4 patch of
// the score tile (16 row groups x 16 column groups, so a row's reductions
// stay inside one half warp), where the mask, the online softmax and the
// rounding happen. E skips key tiles wholly above the diagonal; F (one
// block per key tile) starts its query loop at the first query tile that
// sees the key tile; G (one block per query tile) stops at its last
// visible key tile. The fp32 F and G each recompute delta per query tile
// from do and o, as _dq_kernel_packed does; nothing is read back to the
// host. The products are FMAs on the CUDA cores (TF32 would break the
// reference's fp32 tolerances), over tiles staged as fp32 with rows
// padded by one to keep the banks apart; each thread keeps its rows of the
// output accumulator in registers.
// The bf16 E, F and G are designed for Hopper (their own sections below):
// scores and accumulators in registers, mma.sync m16n8k16 fed by
// ldmatrix, a two-stage cp.async ring, ex2.approx, an unmasked loop for
// interior tiles; the backward runs G first (it writes delta once per
// query row), then F.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;          // 16 row groups x 16 column groups
constexpr float kMasked = -1e30f;      // the reference's causal penalty

// error codes below zero are this library's own; >0 are cudaError_t
constexpr int kErrHeadDim = -1;
constexpr int kErrDType = -3;

enum DType { kF32 = 0, kBF16 = 1 };
enum Operand { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kOperands };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;          // forward: unused; backward: the saved output
  const void* dout;       // backward: the output's cotangent
  void* out;              // forward result, strides st[kO]
  void* dq;
  void* dk;
  void* dv;
  float* lse;             // (b, h, s_q) fp32: forward writes, backward reads
  const float* glse;      // (b, h, s_q) fp32 lse cotangent, or nullptr
  float* delta;           // (b, h, s_q) fp32: bf16 G writes, bf16 F reads
  void* qs;               // (b, h, s_q, d) contiguous round_T(q * scale):
                          // bf16 G writes, bf16 F reads
  long long st[kOperands][3];  // element strides (batch, head, position)
  int h, sq, sk, causal, offset;
  float q_scale;          // 1/sqrt(d) rounded to the operands' dtype
  float dq_scale;         // 1/sqrt(d) in fp32
  float score_scale;      // E's variants: the fp32 multiplier of q.k^T
};

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round-to-nearest-even into T and back: the reference's `.astype(T)`
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// reductions over the 16 lanes of one row group (a half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Tile sizes: 64 rows, 32 at d=256 (the register and shared-memory budget).
template <int D> struct Tile {
  static constexpr int ROWS = D == 256 ? 32 : 64;
  static constexpr int LD = D + 1;           // padded row of a (ROWS, D) tile
  static constexpr int LS = ROWS + 1;        // padded row of a (ROWS, ROWS)
  static constexpr int RT = ROWS / 16;       // rows per thread
  static constexpr int CT = ROWS / 16;       // score columns per thread
  static constexpr int DT = D / 16;          // head_dim columns per thread
  static constexpr size_t kFwdSmem =
      (3 * ROWS * LD + ROWS * LS) * sizeof(float);
  static constexpr size_t kBwdSmem =
      (4 * ROWS * LD + 2 * ROWS * LS + 2 * ROWS) * sizeof(float);
};

// Stage rows [row0, row0 + n) of one head into a (ROWS, D+1) fp32 tile,
// zero past n. `scale` > 0 makes it the reference's round_T(x * scale).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int row0, int n,
                                          float scale) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (r < n) {
      x = to_float<T>(src[(row0 + r) * ss + c]);
      if (scale > 0.f) x = round_to<T>(x * scale);
    }
    dst[r * (D + 1) + c] = x;
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const long long* st, int b,
                                             int hh) {
  return static_cast<const T*>(base) + b * st[0] + hh * st[1];
}
template <typename T>
__device__ __forceinline__ T* head_ptr_mut(void* base, const long long* st,
                                           int b, int hh) {
  return static_cast<T*>(base) + b * st[0] + hh * st[1];
}

// ------------------------------------------------------------ kernel E
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int ROWS = TL::ROWS, LD = TL::LD, LS = TL::LS;
  constexpr int RT = TL::RT, CT = TL::CT, DT = TL::DT;
  extern __shared__ float smem[];
  float* sQ = smem;                  // (ROWS, LD) scaled, rounded queries
  float* sK = sQ + ROWS * LD;        // (ROWS, LD)
  float* sV = sK + ROWS * LD;        // (ROWS, LD)
  float* sP = sV + ROWS * LD;        // (ROWS, LS) round_T(p)

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.y, b = bh / p.h, hh = bh - b * p.h;
  const int q0 = blockIdx.x * ROWS;
  const int nq = min(ROWS, p.sq - q0);
  const T* qp = head_ptr<T>(p.q, p.st[kQ], b, hh);
  const T* kp = head_ptr<T>(p.k, p.st[kK], b, hh);
  const T* vp = head_ptr<T>(p.v, p.st[kV], b, hh);
  T* op = head_ptr_mut<T>(p.out, p.st[kO], b, hh);

  load_tile<T, D, ROWS>(sQ, qp, p.st[kQ][2], q0, nq, p.q_scale);

  float m[RT], l[RT], acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }
  // key tiles wholly above the diagonal contribute nothing: stop before
  const int k_end =
      p.causal ? min(p.sk, q0 + nq - 1 + p.offset + 1) : p.sk;
  for (int k0 = 0; k0 < k_end; k0 += ROWS) {
    const int nk = min(ROWS, p.sk - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, ROWS>(sK, kp, p.st[kK][2], k0, nk, 0.f);
    load_tile<T, D, ROWS>(sV, vp, p.st[kV][2], k0, nk, 0.f);
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int x = 0; x < D; ++x) {
      float a[RT], c[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = sQ[(rg * RT + i) * LD + x];
#pragma unroll
      for (int j = 0; j < CT; ++j) c[j] = sK[(cg + 16 * j) * LD + x];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qi = q0 + rg * RT + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int kj = k0 + cg + 16 * j;
        if (kj >= p.sk)
          s[i][j] = -INFINITY;            // past the end: no mass at all
        else if (p.causal && kj > qi + p.offset)
          s[i][j] = kMasked;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - m_new);   // 0 on the first tile
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float pr = expf(s[i][j] - m_new);
        ps += pr;
        sP[(rg * RT + i) * LS + cg + 16 * j] = round_to<T>(pr);
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int x = 0; x < ROWS; ++x) {
      float a[RT], c[DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = sP[(rg * RT + i) * LS + x];
#pragma unroll
      for (int j = 0; j < DT; ++j) c[j] = sV[x * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg * RT + i;
    if (r >= nq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* row = op + (q0 + r) * p.st[kO][2];
#pragma unroll
    for (int j = 0; j < DT; ++j) row[cg + 16 * j] = from_float<T>(acc[i][j] * inv);
    if (cg == 0)
      p.lse[static_cast<long long>(bh) * p.sq + q0 + r] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// Backward helpers: stage one query tile (scaled queries, do, lse) and its
// delta = rowsum(do * o) - g_lse. Ends with the block synchronised.
template <typename T, int D>
__device__ __forceinline__ void stage_queries(const Params& p, int b, int hh,
                                              int q0, int nq, float* sQ,
                                              float* sdO, float* sLse,
                                              float* sDelta) {
  using TL = Tile<D>;
  constexpr int ROWS = TL::ROWS, LD = TL::LD, RT = TL::RT;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const long long stat = static_cast<long long>(b * p.h + hh) * p.sq + q0;
  load_tile<T, D, ROWS>(sQ, head_ptr<T>(p.q, p.st[kQ], b, hh), p.st[kQ][2],
                        q0, nq, p.q_scale);
  load_tile<T, D, ROWS>(sdO, head_ptr<T>(p.dout, p.st[kDO], b, hh),
                        p.st[kDO][2], q0, nq, 0.f);
  for (int r = tid; r < ROWS; r += kThreads)
    sLse[r] = r < nq ? p.lse[stat + r] : 0.f;
  __syncthreads();
  const T* op = head_ptr<T>(p.o, p.st[kO], b, hh);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg * RT + i;
    float acc = 0.f;
    if (r < nq) {
      const T* orow = op + (q0 + r) * p.st[kO][2];
      for (int c = cg; c < D; c += 16)
        acc = fmaf(sdO[r * LD + c], to_float<T>(orow[c]), acc);
    }
    acc = row_sum(acc);
    if (cg == 0) {
      const float g = (p.glse != nullptr && r < nq) ? p.glse[stat + r] : 0.f;
      sDelta[r] = acc - g;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ kernel F
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int ROWS = TL::ROWS, LD = TL::LD, LS = TL::LS;
  constexpr int RT = TL::RT, CT = TL::CT, DT = TL::DT;
  extern __shared__ float smem[];
  float* sK = smem;                  // (ROWS, LD) this block's keys
  float* sV = sK + ROWS * LD;
  float* sQ = sV + ROWS * LD;        // (ROWS, LD) scaled, rounded queries
  float* sdO = sQ + ROWS * LD;
  float* sP = sdO + ROWS * LD;       // (ROWS, LS) round_T(p^T): [key][query]
  float* sdS = sP + ROWS * LS;       // (ROWS, LS) round_T(ds^T)
  float* sLse = sdS + ROWS * LS;     // (ROWS)
  float* sDelta = sLse + ROWS;       // (ROWS)

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.y, b = bh / p.h, hh = bh - b * p.h;
  const int k0 = blockIdx.x * ROWS;
  const int nk = min(ROWS, p.sk - k0);
  load_tile<T, D, ROWS>(sK, head_ptr<T>(p.k, p.st[kK], b, hh), p.st[kK][2],
                        k0, nk, 0.f);
  load_tile<T, D, ROWS>(sV, head_ptr<T>(p.v, p.st[kV], b, hh), p.st[kV][2],
                        k0, nk, 0.f);

  float dk[RT][DT], dv[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) dk[i][j] = dv[i][j] = 0.f;

  // the first query tile that sees key k0 under causal masking
  int q_begin = 0;
  if (p.causal) q_begin = max(0, k0 - p.offset) / ROWS * ROWS;
  for (int q0 = q_begin; q0 < p.sq; q0 += ROWS) {
    const int nq = min(ROWS, p.sq - q0);
    __syncthreads();   // the previous tile's readers are done
    stage_queries<T, D>(p, b, hh, q0, nq, sQ, sdO, sLse, sDelta);

    // s^T and dp^T: rows are this block's keys, columns the tile's queries
    float s[RT][CT], dp[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int x = 0; x < D; ++x) {
      float ak[RT], av[RT], cq[CT], cd[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ak[i] = sK[(rg * RT + i) * LD + x];
        av[i] = sV[(rg * RT + i) * LD + x];
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        cq[j] = sQ[(cg + 16 * j) * LD + x];
        cd[j] = sdO[(cg + 16 * j) * LD + x];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          s[i][j] = fmaf(ak[i], cq[j], s[i][j]);
          dp[i][j] = fmaf(av[i], cd[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int kk = k0 + rg * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = cg + 16 * j;
        const bool valid = kk < p.sk && c < nq &&
                           (!p.causal || kk <= q0 + c + p.offset);
        const float pr = valid ? expf(s[i][j] - sLse[c]) : 0.f;
        const float ds = pr * (dp[i][j] - sDelta[c]);
        sP[(rg * RT + i) * LS + c] = round_to<T>(pr);
        sdS[(rg * RT + i) * LS + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dv += p^T . do;  dk += ds^T . qs  (contracting over the tile's queries)
#pragma unroll 4
    for (int x = 0; x < ROWS; ++x) {
      float ap[RT], as[RT], cd[DT], cq[DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ap[i] = sP[(rg * RT + i) * LS + x];
        as[i] = sdS[(rg * RT + i) * LS + x];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        cd[j] = sdO[x * LD + cg + 16 * j];
        cq[j] = sQ[x * LD + cg + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          dv[i][j] = fmaf(ap[i], cd[j], dv[i][j]);
          dk[i][j] = fmaf(as[i], cq[j], dk[i][j]);
        }
    }
  }

  T* dkp = head_ptr_mut<T>(p.dk, p.st[kDK], b, hh);
  T* dvp = head_ptr_mut<T>(p.dv, p.st[kDV], b, hh);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg * RT + i;
    if (r >= nk) continue;
    T* krow = dkp + (k0 + r) * p.st[kDK][2];
    T* vrow = dvp + (k0 + r) * p.st[kDV][2];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      krow[cg + 16 * j] = from_float<T>(dk[i][j]);
      vrow[cg + 16 * j] = from_float<T>(dv[i][j]);
    }
  }
}

// ------------------------------------------------------------ kernel G
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int ROWS = TL::ROWS, LD = TL::LD, LS = TL::LS;
  constexpr int RT = TL::RT, CT = TL::CT, DT = TL::DT;
  extern __shared__ float smem[];
  float* sQ = smem;                  // (ROWS, LD) scaled, rounded queries
  float* sdO = sQ + ROWS * LD;
  float* sK = sdO + ROWS * LD;
  float* sV = sK + ROWS * LD;
  float* sdS = sV + ROWS * LD;       // (ROWS, LS) round_T(ds): [query][key]
  float* sLse = sdS + ROWS * LS;
  float* sDelta = sLse + ROWS;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.y, b = bh / p.h, hh = bh - b * p.h;
  const int q0 = blockIdx.x * ROWS;
  const int nq = min(ROWS, p.sq - q0);
  stage_queries<T, D>(p, b, hh, q0, nq, sQ, sdO, sLse, sDelta);
  const T* kp = head_ptr<T>(p.k, p.st[kK], b, hh);
  const T* vp = head_ptr<T>(p.v, p.st[kV], b, hh);

  float dq[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) dq[i][j] = 0.f;

  const int k_end =
      p.causal ? min(p.sk, q0 + nq - 1 + p.offset + 1) : p.sk;
  for (int k0 = 0; k0 < k_end; k0 += ROWS) {
    const int nk = min(ROWS, p.sk - k0);
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, D, ROWS>(sK, kp, p.st[kK][2], k0, nk, 0.f);
    load_tile<T, D, ROWS>(sV, vp, p.st[kV][2], k0, nk, 0.f);
    __syncthreads();

    float s[RT][CT], dp[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int x = 0; x < D; ++x) {
      float aq[RT], ad[RT], ck[CT], cv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        aq[i] = sQ[(rg * RT + i) * LD + x];
        ad[i] = sdO[(rg * RT + i) * LD + x];
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        ck[j] = sK[(cg + 16 * j) * LD + x];
        cv[j] = sV[(cg + 16 * j) * LD + x];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          s[i][j] = fmaf(aq[i], ck[j], s[i][j]);
          dp[i][j] = fmaf(ad[i], cv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int kj = k0 + cg + 16 * j;
        const bool valid = r < nq && kj < p.sk &&
                           (!p.causal || kj <= q0 + r + p.offset);
        const float pr = valid ? expf(s[i][j] - sLse[r]) : 0.f;
        sdS[r * LS + cg + 16 * j] = round_to<T>(pr * (dp[i][j] - sDelta[r]));
      }
    }
    __syncthreads();

    // dq += ds . k  (contracting over the tile's keys)
#pragma unroll 8
    for (int x = 0; x < ROWS; ++x) {
      float a[RT], c[DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = sdS[(rg * RT + i) * LS + x];
#pragma unroll
      for (int j = 0; j < DT; ++j) c[j] = sK[x * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) dq[i][j] = fmaf(a[i], c[j], dq[i][j]);
    }
  }

  T* dqp = head_ptr_mut<T>(p.dq, p.st[kDQ], b, hh);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg * RT + i;
    if (r >= nq) continue;
    T* row = dqp + (q0 + r) * p.st[kDQ][2];
#pragma unroll
    for (int j = 0; j < DT; ++j)
      row[cg + 16 * j] = from_float<T>(dq[i][j] * p.dq_scale);
  }
}

using bf16 = __nv_bfloat16;

// ------------------------------------------ kernels F and G, bf16 (Hopper)
// Replace the reference's _dkdv_kernel_packed / _dkdv_kernel (F: dK, dV)
// and _dq_kernel_packed / _dq_kernel (G: dQ) of
// ddp_practice_tpu/ops/flash_attention.py for bf16 operands; the
// arithmetic and rounding points are the header's.
// Bound: operations. The backward needs 10*b*h*pairs*d flops (pairs: the
// visible (query, key) pairs; s_q*s_k, causal about half) over the tensor
// cores' 989.4 TFLOP/s: 0.130 ms at the lm_base shape, whose ~25 MB of
// operands and results would take 0.008 ms at 3.35 TB/s. Atomic-free, F
// and G recompute s and dp each, so they execute 14 of those 10 flops.
// Design:
//   - G runs first. A block owns 64 queries (4 warps x 16 rows) and walks
//     the visible key tiles; F runs next, a block owning a key tile (64
//     rows; 32 at d=256) and walking the query tiles that see it. Every
//     sum has one owner and a fixed order: no atomics, the same bits on
//     every run.
//   - delta = rowsum(do * o) - g_lse is computed once per query row, by
//     the G block that stages the row; G writes it to a (b*h, s_q) fp32
//     scratch that F, launched after it on the same stream, streams
//     beside lse. The same G block rounds its queries to
//     qs = round_bf16(q * scale) once and writes them to a (b*h, s_q, d)
//     scratch that F streams in place of q, so no F block rescales a
//     query tile.
//   - Scores stay in registers. Each warp's products run on mma.sync
//     m16n8k16 (bf16 in, fp32 accumulators), fed by ldmatrix (.trans for
//     the operands whose rows are the contraction): F computes
//     s^T = K.qs^T and dp^T = V.do^T into fp32 fragments, turns them into
//     p^T and ds^T in place, and packs them as bf16 straight into the
//     A operand of dV += p^T.do and dK += ds^T.qs (an m16n8 accumulator
//     pair is an m16k16 A fragment); G does the same for s, dp, ds and
//     dQ += ds.k. dK, dV and dQ stay in registers across the whole loop;
//     lse and delta come from per-tile vectors (F) or per-row registers
//     (G). At d=256 F's warps split dK and dV by columns in pairs (each
//     warp of a pair recomputes its rows' s and dp), so no thread holds
//     more than 128 accumulators; F streams 32 queries a tile at d >= 128
//     and G 32 keys, for the same reason. The blocks an SM each kernel is
//     compiled for (BwdTile) come from the card's occupancy and spill
//     readings.
//   - The streamed operands (F: qs, do, lse, delta; G: k, v) come through
//     a ring of two shared-memory stages filled by cp.async: tile i+1's
//     copy is in flight while tile i's products run, and one barrier a
//     tile separates the two. Rows past the end are zero-filled
//     (src-size 0). F's K, V and G's q, do are loaded once; each G thread
//     rounds the query chunks it copied in place once they land, before
//     the barrier that publishes them. An operand whose head base or row
//     stride is not 16-byte aligned is staged with plain loads at the same
//     point of the schedule (a layout branch).
//   - Tiles sit in shared memory as bf16 rows padded by 8 elements, so
//     the eight 16-byte rows an ldmatrix reads fall in distinct banks.
//   - p = 2^(s log2(e) - lse log2(e)) on the special-function unit
//     (ex2.approx, about 2 ulp of fp32). Tiles wholly inside the visible
//     triangle run a copy of the elementwise loop without the mask.
//   - dK, dV and dQ leave through shared memory (bf16) as 16-byte row
//     chunks where the output's base and row stride allow it, which
//     includes the windows of the fused (b, s, 3*h*d) gradient.
//   - mma.sync and not wgmma: mma.sync's fragments are a fixed per-warp
//     register layout, so the score fragments become the next product's
//     A operand with no shared-memory layout in between, and every
//     operand tile is a plain padded row-major tile. wgmma (64-row
//     warpgroup products, B through swizzled shared-memory descriptors)
//     keeps the same register reuse and is the next step.

// PTX wrappers (sm_80 instructions, present on sm_90a)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// two 8x8 b16 matrices, transposed; lanes 8i..8i+7 give matrix i's rows
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
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
// 2^x, ~2 ulp; results below 2^-126 flush to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// end of the PTX wrappers

// two floats as one bf16x2 register, lo in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D> struct BwdTile {
  static constexpr int WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int LD = D + 8;        // padded bf16 row
  static constexpr int STAGES = 2;        // the copy ring
  // F: warp w owns key rows 16 (w / F_SPLIT) and dK/dV columns
  // F_DC (w % F_SPLIT) of the block's tile
  static constexpr int F_SPLIT = D == 256 ? 2 : 1;
  static constexpr int F_DC = D / F_SPLIT;
  static constexpr int F_KEYS = 16 * WARPS / F_SPLIT;
  static constexpr int F_QUERIES = D >= 128 ? 32 : 64;
  // G: warp w owns query rows 16 w
  static constexpr int G_QUERIES = 16 * WARPS;
  static constexpr int G_KEYS = D >= 128 ? 32 : 64;
  // blocks an SM the kernels are compiled for (a register cap of 65536 /
  // (128 x blocks)): F 4 / 3 / 2 at d = 32 / 64 / larger, G 4 at d <= 64.
  // Unbounded, F took 192 and 233 registers at d = 32 and 64 and G
  // 164-166 (two and three blocks an SM); bounded, F takes 128 and 168
  // with a few dozen bytes spilled and G 128 with none, and both run
  // faster (experiments/flash_bwd_ablate.py)
  static constexpr int F_BLOCKS = D == 32 ? 4 : D == 64 ? 3 : 2;
  static constexpr int G_BLOCKS = D <= 64 ? 4 : 1;
  static constexpr size_t F_KV = size_t(F_KEYS) * LD * 2;     // one tile
  static constexpr size_t F_QT = size_t(F_QUERIES) * LD * 2;
  static constexpr size_t F_STAGE = 2 * F_QT + 2 * F_QUERIES * 4;
  static constexpr size_t kFSmem = 2 * F_KV + STAGES * F_STAGE;
  static constexpr size_t G_QT = size_t(G_QUERIES) * LD * 2;
  static constexpr size_t G_KV = size_t(G_KEYS) * LD * 2;
  static constexpr size_t kGSmem = 2 * G_QT + STAGES * 2 * G_KV;
  static_assert(F_QUERIES % 16 == 0 && G_KEYS % 16 == 0 && F_DC % 16 == 0,
                "whole k16 steps and n-tile pairs");
};

__device__ __forceinline__ bool aligned16(const void* base, long long ss) {
  return ((reinterpret_cast<uintptr_t>(base) | (ss * 2)) & 15) == 0;
}

// Copy columns [0, COLS) of rows [row0, row0 + n) of one head into a
// (ROWS, LD) bf16 tile, zeros past n, by NT threads of which this is
// thread `tid`: 16-byte cp.async chunks when `vec`, else plain loads, where
// `scale` > 0 stores round_bf16(x * scale) at once.
template <int COLS, int LD, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          long long ss, int row0, int n,
                                          bool vec, float scale, int tid) {
  constexpr int V = COLS / 8;
  if (vec) {
    for (int e = tid; e < ROWS * V; e += NT) {
      const int r = e / V, c = (e % V) * 8;
      const bool in = r < n;
      cp_async16(dst + r * LD + c, in ? src + (row0 + r) * ss + c : src, in);
    }
    return;
  }
  for (int e = tid; e < ROWS * COLS; e += NT) {
    const int r = e / COLS, c = e % COLS;
    float x = 0.f;
    if (r < n) {
      x = __bfloat162float(src[(row0 + r) * ss + c]);
      if (scale > 0.f) x *= scale;
    }
    dst[r * LD + c] = __float2bfloat16_rn(x);
  }
}

// copy_rows of a whole (ROWS, D + 8) tile by the block's NT threads
template <int D, int ROWS, int NT>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          long long ss, int row0, int n,
                                          bool vec, float scale) {
  copy_rows<D, D + 8, ROWS, NT>(dst, src, ss, row0, n, vec, scale,
                                threadIdx.x);
}

// round_bf16(x * scale) in place over the chunks this thread copied with
// copy_tile's vec path (the same assignment), once they have landed
template <int D, int ROWS, int NT>
__device__ __forceinline__ void scale_tile(bf16* dst, float scale) {
  constexpr int LD = D + 8, V = D / 8;
  for (int e = threadIdx.x; e < ROWS * V; e += NT) {
    const int r = e / V, c = (e % V) * 8;
    uint4 x = *reinterpret_cast<uint4*>(dst + r * LD + c);
    bf16* h = reinterpret_cast<bf16*>(&x);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = __float2bfloat16_rn(__bfloat162float(h[i]) * scale);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

// ROWS fp32 values from src (a (b*h, s_q) row), zeros past n
template <int ROWS, int NT>
__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int n) {
  for (int r = threadIdx.x; r < ROWS; r += NT)
    cp_async4(dst + r, r < n ? src + r : src, r < n);
}

// Write the first n rows of a (ROWS, D + 8) bf16 tile to one head's rows
// [row0, row0 + n): 16-byte chunks when the destination allows them.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void store_tile(bf16* dst, long long ss,
                                           const bf16* src, int row0,
                                           int n) {
  constexpr int LD = D + 8, V = D / 8;
  if (aligned16(dst, ss)) {
    for (int e = threadIdx.x; e < n * V; e += NT) {
      const int r = e / V, c = (e % V) * 8;
      *reinterpret_cast<uint4*>(dst + (row0 + r) * ss + c) =
          *reinterpret_cast<const uint4*>(src + r * LD + c);
    }
    return;
  }
  for (int e = threadIdx.x; e < n * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[(row0 + r) * ss + c] = src[r * LD + c];
  }
}

// acc[n] (16 x 8N fp32, this warp's rows) += A (16 rows of a bf16 tile,
// rows r0) . B^T, B = rows [0, 8N) of another tile, over head_dim D.
// Both tiles row-major with D + 8 columns; two accumulators run at once
// (s and dp share their loop).
template <int D, int N>
__device__ __forceinline__ void mma_rows_abt2(float (&acc0)[N][4],
                                              float (&acc1)[N][4],
                                              const bf16* a0, const bf16* a1,
                                              const bf16* b0, const bf16* b1,
                                              int r0) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
  const int arow = r0 + (lane & 15), acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa0[4], fa1[4];
    ldsm_x4(fa0, a0 + arow * LD + kk * 16 + acol);
    ldsm_x4(fa1, a1 + arow * LD + kk * 16 + acol);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t fb0[4], fb1[4];
      ldsm_x4(fb0, b0 + (np * 16 + brow) * LD + kk * 16 + bcol);
      ldsm_x4(fb1, b1 + (np * 16 + brow) * LD + kk * 16 + bcol);
      mma_bf16(acc0[2 * np], fa0, fb0[0], fb0[1]);
      mma_bf16(acc0[2 * np + 1], fa0, fb0[2], fb0[3]);
      mma_bf16(acc1[2 * np], fa1, fb1[0], fb1[1]);
      mma_bf16(acc1[2 * np + 1], fa1, fb1[2], fb1[3]);
    }
  }
}

// acc[n] (16 x 8M fp32, columns c0..c0+8M of a width-D tile) += P . X,
// P = this warp's 16 x 8K fp32 fragments `p` rounded to bf16 (the m16n8
// accumulator pair 2j, 2j+1 is the m16k16 A fragment of step j), X = rows
// [0, 8K) of a bf16 tile (row-major, D + 8 columns), read transposed.
template <int D, int K, int M>
__device__ __forceinline__ void mma_frag_x(float (&acc)[M][4],
                                           const float (&p)[K][4],
                                           const bf16* x, int c0) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
  const int xrow = lane & 15, xcol = c0 + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < K / 2; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < M / 2; ++dp) {
      uint32_t fb[4];
      ldsm_x4_t(fb, x + (j * 16 + xrow) * LD + xcol + dp * 16);
      mma_bf16(acc[2 * dp], a, fb[0], fb[1]);
      mma_bf16(acc[2 * dp + 1], a, fb[2], fb[3]);
    }
  }
}

// This warp's 16 x 8M fp32 fragments (rows r0, columns c0) times `scale`
// as bf16 into a (ROWS, D + 8) tile.
template <int D, int M>
__device__ __forceinline__ void frag_to_tile(bf16* dst,
                                             const float (&acc)[M][4],
                                             int r0, int c0, float scale) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < M; ++n) {
    const int c = c0 + n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + (r0 + g) * LD + c) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8) * LD + c) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------- kernel G, bf16
// One block per (64-query tile, batch*head); launched before F.
template <int D>
__global__ void __launch_bounds__(BwdTile<D>::THREADS, BwdTile<D>::G_BLOCKS)
    flash_bwd_dq_tc_kernel(const Params p) {
  using TL = BwdTile<D>;
  constexpr int LD = TL::LD, NT = TL::THREADS, BQ = TL::G_QUERIES;
  constexpr int BK = TL::G_KEYS, NK8 = BK / 8, ND8 = D / 8;
  extern __shared__ float smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);              // (BQ, LD) qs
  bf16* sdO = sQ + BQ * LD;                              // (BQ, LD)
  bf16* ring = sdO + BQ * LD;                            // STAGES x (K, V)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  // the heaviest tiles (the last under causal masking) start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.h, hh = bh - b * p.h;
  const int q0 = qt * BQ, nq = min(BQ, p.sq - q0);
  const long long stat = static_cast<long long>(bh) * p.sq + q0;
  const bf16* qp = head_ptr<bf16>(p.q, p.st[kQ], b, hh);
  const bf16* dop = head_ptr<bf16>(p.dout, p.st[kDO], b, hh);
  const bf16* kp = head_ptr<bf16>(p.k, p.st[kK], b, hh);
  const bf16* vp = head_ptr<bf16>(p.v, p.st[kV], b, hh);
  const long long sq_ = p.st[kQ][2], sdo = p.st[kDO][2];
  const long long sk_ = p.st[kK][2], sv = p.st[kV][2];
  const bool vq = aligned16(qp, sq_), vdo = aligned16(dop, sdo);
  const bool vk = aligned16(kp, sk_), vv = aligned16(vp, sv);

  const int k_end =
      p.causal ? min(p.sk, q0 + nq - 1 + p.offset + 1) : p.sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  copy_tile<D, BQ, NT>(sQ, qp, sq_, q0, nq, vq, p.q_scale);
  copy_tile<D, BQ, NT>(sdO, dop, sdo, q0, nq, vdo, 0.f);
  copy_tile<D, BK, NT>(ring, kp, sk_, 0, min(BK, p.sk), vk, 0.f);
  copy_tile<D, BK, NT>(ring + BK * LD, vp, sv, 0, min(BK, p.sk), vv, 0.f);
  cp_async_commit();
  cp_async_wait_all();
  if (vq) scale_tile<D, BQ, NT>(sQ, p.q_scale);
  __syncthreads();
  // qs once per query row, for F
  store_tile<D, BQ, NT>(static_cast<bf16*>(p.qs) + stat * D, D, sQ, 0, nq);

  // delta for this warp's 16 rows: lanes 2i, 2i+1 split row i's columns
  float delta_r[2], lse_r[2];
  {
    const int r = r0 + (lane >> 1), c0 = (lane & 1) * (D / 2);
    float acc = 0.f;
    if (r < nq) {
      const bf16* orow = head_ptr<bf16>(p.o, p.st[kO], b, hh) +
                         (q0 + r) * p.st[kO][2] + c0;
      const bf16* drow = sdO + r * LD + c0;
      if (aligned16(orow, 0)) {
#pragma unroll
        for (int c = 0; c < D / 2; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
          const bf16* oh = reinterpret_cast<const bf16*>(&ov);
          const bf16* dh = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc = fmaf(__bfloat162float(dh[i]), __bfloat162float(oh[i]), acc);
        }
      } else {
        for (int c = 0; c < D / 2; ++c)
          acc = fmaf(__bfloat162float(drow[c]), __bfloat162float(orow[c]),
                     acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (r < nq) {
      if (p.glse != nullptr) acc -= p.glse[stat + r];
      if ((lane & 1) == 0) p.delta[stat + r] = acc;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = g + 8 * i;        // row held by lanes 2rr, 2rr+1
      delta_r[i] = __shfl_sync(0xffffffffu, acc, 2 * rr);
      lse_r[i] = r0 + rr < nq ? p.lse[stat + r0 + rr] * kLog2e : 0.f;
    }
  }

  float dq[ND8][4];
#pragma unroll
  for (int n = 0; n < ND8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    bf16* sK = ring + (it & 1) * 2 * BK * LD;
    bf16* sV = sK + BK * LD;
    if (it > 0) {
      cp_async_wait_all();
      __syncthreads();   // tile `it` landed; tile it-1's readers are done
    }
    if (it + 1 < n_tiles) {   // the next tile's copy overlaps this tile
      const int k1 = k0 + BK, n1 = min(BK, p.sk - k1);
      bf16* nK = ring + ((it + 1) & 1) * 2 * BK * LD;
      copy_tile<D, BK, NT>(nK, kp, sk_, k1, n1, vk, 0.f);
      copy_tile<D, BK, NT>(nK + BK * LD, vp, sv, k1, n1, vv, 0.f);
      cp_async_commit();
    }
    // s = qs . k^T and dp = do . v^T for this warp's 16 rows
    float s[NK8][4], dp[NK8][4];
#pragma unroll
    for (int n = 0; n < NK8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    mma_rows_abt2<D, NK8>(s, dp, sQ, sdO, sK, sV, r0);
    const bool full = q0 + BQ <= p.sq && k0 + BK <= p.sk &&
                      (!p.causal || k0 + BK - 1 <= q0 + p.offset);
    auto to_ds = [&](auto masked) {   // one copy of the loop per case
#pragma unroll
      for (int n = 0; n < NK8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool valid = true;
          if constexpr (decltype(masked)::value) {
            const int row = q0 + r0 + g + 8 * (i >> 1);
            const int key = k0 + n * 8 + 2 * t + (i & 1);
            valid = row < p.sq && key < p.sk &&
                    (!p.causal || key <= row + p.offset);
          }
          const float pr =
              valid ? exp2_approx(fmaf(s[n][i], kLog2e, -lse_r[i >> 1]))
                    : 0.f;
          s[n][i] = pr * (dp[n][i] - delta_r[i >> 1]);   // ds
        }
    };
    if (full)
      to_ds(std::false_type());
    else
      to_ds(std::true_type());
    mma_frag_x<D, NK8, ND8>(dq, s, sK, 0);               // dq += ds . k
  }

  __syncthreads();   // every warp is done with sQ: it stages dq
  frag_to_tile<D, ND8>(sQ, dq, r0, 0, p.dq_scale);
  __syncthreads();
  store_tile<D, BQ, NT>(head_ptr_mut<bf16>(p.dq, p.st[kDQ], b, hh),
                        p.st[kDQ][2], sQ, q0, nq);
}

// ---------------------------------------------------- kernel F, bf16
// One block per (key tile, batch*head); reads G's delta.
template <int D>
__global__ void __launch_bounds__(BwdTile<D>::THREADS, BwdTile<D>::F_BLOCKS)
    flash_bwd_dkdv_tc_kernel(const Params p) {
  using TL = BwdTile<D>;
  constexpr int LD = TL::LD, NT = TL::THREADS, BK = TL::F_KEYS;
  constexpr int BQ = TL::F_QUERIES, NQ8 = BQ / 8, NC8 = TL::F_DC / 8;
  extern __shared__ float smem[];
  char* base = reinterpret_cast<char*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(base);                   // (BK, LD)
  bf16* sV = reinterpret_cast<bf16*>(base + TL::F_KV);
  char* ring = base + 2 * TL::F_KV;     // STAGES x (qs, do, lse, delta)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp / TL::F_SPLIT);
  const int c0 = TL::F_DC * (warp % TL::F_SPLIT);
  const int bh = blockIdx.y, b = bh / p.h, hh = bh - b * p.h;
  const int k0 = blockIdx.x * BK, nk = min(BK, p.sk - k0);
  // qs: G's (b, h, s_q, d) scratch, rows of D
  const bf16* qp = static_cast<const bf16*>(p.qs) +
                   static_cast<long long>(bh) * p.sq * D;
  const bf16* dop = head_ptr<bf16>(p.dout, p.st[kDO], b, hh);
  const bf16* kp = head_ptr<bf16>(p.k, p.st[kK], b, hh);
  const bf16* vp = head_ptr<bf16>(p.v, p.st[kV], b, hh);
  const long long sdo = p.st[kDO][2];
  const bool vq = aligned16(qp, D), vdo = aligned16(dop, sdo);
  const float* lse_h = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta_h = p.delta + static_cast<long long>(bh) * p.sq;

  // the first query tile that sees key k0 under causal masking
  const int q_begin = p.causal ? max(0, k0 - p.offset) / BQ * BQ : 0;
  const int n_tiles = (p.sq - q_begin + BQ - 1) / BQ;
  auto stage = [&](int it) {   // query tile `it` into ring slot it % 2
    const int q0 = q_begin + it * BQ, n = min(BQ, p.sq - q0);
    char* slot = ring + (it & 1) * TL::F_STAGE;
    bf16* tq = reinterpret_cast<bf16*>(slot);
    float* tl = reinterpret_cast<float*>(slot + 2 * TL::F_QT);
    copy_tile<D, BQ, NT>(tq, qp, D, q0, n, vq, 0.f);
    copy_tile<D, BQ, NT>(tq + BQ * LD, dop, sdo, q0, n, vdo, 0.f);
    copy_vec<BQ, NT>(tl, lse_h + q0, n);
    copy_vec<BQ, NT>(tl + BQ, delta_h + q0, n);
  };
  copy_tile<D, BK, NT>(sK, kp, p.st[kK][2], k0, nk,
                       aligned16(kp, p.st[kK][2]), 0.f);
  copy_tile<D, BK, NT>(sV, vp, p.st[kV][2], k0, nk,
                       aligned16(vp, p.st[kV][2]), 0.f);
  stage(0);
  cp_async_commit();

  float dk[NC8][4], dv[NC8][4];
#pragma unroll
  for (int n = 0; n < NC8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ;
    char* slot = ring + (it & 1) * TL::F_STAGE;
    bf16* sQ = reinterpret_cast<bf16*>(slot);
    bf16* sdO = sQ + BQ * LD;
    const float* sLse = reinterpret_cast<const float*>(slot + 2 * TL::F_QT);
    const float* sDelta = sLse + BQ;
    cp_async_wait_all();
    __syncthreads();   // tile `it` is in place; tile it-1's readers are done
    if (it + 1 < n_tiles) {   // the next tile's copy overlaps this tile
      stage(it + 1);
      cp_async_commit();
    }
    // s^T = K . qs^T and dp^T = V . do^T: this warp's 16 keys x BQ queries
    float s[NQ8][4], dp[NQ8][4];
#pragma unroll
    for (int n = 0; n < NQ8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    mma_rows_abt2<D, NQ8>(s, dp, sK, sV, sQ, sdO, r0);
    const bool full = q0 + BQ <= p.sq && k0 + BK <= p.sk &&
                      (!p.causal || k0 + BK - 1 <= q0 + p.offset);
    auto to_p_ds = [&](auto masked) {   // one copy of the loop per case
#pragma unroll
      for (int n = 0; n < NQ8; ++n) {
        const int c = n * 8 + 2 * t;
        float2 ls = *reinterpret_cast<const float2*>(sLse + c);
        ls.x *= kLog2e;
        ls.y *= kLog2e;
        const float2 dl = *reinterpret_cast<const float2*>(sDelta + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool valid = true;
          if constexpr (decltype(masked)::value) {
            const int key = k0 + r0 + g + 8 * (i >> 1);
            const int query = q0 + c + (i & 1);
            valid = key < p.sk && query < p.sq &&
                    (!p.causal || key <= query + p.offset);
          }
          const float l2 = (i & 1) ? ls.y : ls.x;
          const float de = (i & 1) ? dl.y : dl.x;
          const float pr =
              valid ? exp2_approx(fmaf(s[n][i], kLog2e, -l2)) : 0.f;
          s[n][i] = pr;                            // p^T
          dp[n][i] = pr * (dp[n][i] - de);         // ds^T
        }
      }
    };
    if (full)
      to_p_ds(std::false_type());
    else
      to_p_ds(std::true_type());
    mma_frag_x<D, NQ8, NC8>(dv, s, sdO, c0);     // dv += p^T . do
    mma_frag_x<D, NQ8, NC8>(dk, dp, sQ, c0);     // dk += ds^T . qs
  }

  __syncthreads();   // every warp is done with K and V: they stage dk, dv
  frag_to_tile<D, NC8>(sK, dk, r0, c0, 1.f);
  frag_to_tile<D, NC8>(sV, dv, r0, c0, 1.f);
  __syncthreads();
  store_tile<D, BK, NT>(head_ptr_mut<bf16>(p.dk, p.st[kDK], b, hh),
                        p.st[kDK][2], sK, k0, nk);
  store_tile<D, BK, NT>(head_ptr_mut<bf16>(p.dv, p.st[kDV], b, hh),
                        p.st[kDV][2], sV, k0, nk);
}

// ---------------------------------------------------- kernel E, bf16
// Replaces the reference's _fwd_kernel_packed / _fwd_kernel (called by
// _flash_fwd_packed and _flash_fwd) of ddp_practice_tpu/ops/flash_attention.py
// for bf16 operands; the arithmetic and rounding points are the header's.
// Bound: operations. The forward needs 4*b*h*pairs*d flops (pairs: the
// visible (query, key) pairs) over the tensor cores' 989.4 TFLOP/s: 0.052
// ms at the lm_base shape, whose ~12 MB of operands and results take
// 0.004 ms at 3.35 TB/s.
// Design (the pieces of F and G above, carried over to the forward):
//   - A block of four warps owns a tile of queries, 16 RT rows a warp (RT
//     16-row tiles: 2 at d <= 64, so each K and V fragment a warp loads
//     feeds two row tiles, else 1), and walks the key tiles up to the last
//     one its rows see (causal: bottom-right offset s_k - s_q), the
//     heaviest query tiles first. Each warp's qs =
//     round_bf16(q * scale) rows are rounded once in shared memory and
//     loaded once as mma.sync A fragments (ldmatrix), which stay in
//     registers for the whole key loop (at d=256 they are read from shared
//     memory per key tile: 128 accumulators a thread leave no room).
//   - Scores and the output accumulator live in registers: S = qs.K^T on
//     mma.sync m16n8k16 into fp32 fragments; the row max and the rescale
//     factor from quad shuffles; p = 2^(s log2(e) - m log2(e)) on
//     ex2.approx; l sums the unrounded p (per thread, reduced over the
//     quad once at the end); p packed as bf16 straight into the A operand
//     of acc += P.V, with V read through ldmatrix .trans. No fp32 score or
//     accumulator tile touches shared memory.
//   - K and V stream through a ring of two shared-memory stages filled by
//     cp.async: tile i+1's copy is in flight while tile i multiplies, one
//     barrier a tile; rows past s_k are zero-filled (src-size 0). An
//     operand whose head base or row stride is not 16-byte aligned is
//     staged with plain loads at the same point of the schedule.
//   - Tiles wholly inside the visible triangle (and inside both lengths)
//     run a copy of the elementwise loop without the mask.
//   - The output, acc / l rounded to bf16, leaves through this warp's rows
//     of the query tile as 16-byte row chunks where the output's base and
//     row stride allow it (the packed and fused-QKV layouts do); lse =
//     m + log(max(l, 1e-30)) is written once per row.
//   - Launch bounds per head_dim (FwdTile::BLOCKS) from the card's ptxas
//     and occupancy readings.
template <int D> struct FwdTile {
  static constexpr int WARPS = 4;         // a block's warps
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 8;        // padded bf16 row
  static constexpr int STAGES = 2;        // the copy ring
  // 16-row tiles a warp: two at d <= 64 share every K and V fragment a
  // warp loads (and give the scheduler two independent chains)
  static constexpr int RT = D <= 64 ? 2 : 1;
  static constexpr int QUERIES = 16 * RT * WARPS;
  static constexpr int KEYS = D == 256 ? 32 : 64;
  static constexpr bool QREG = D <= 128;  // qs fragments in registers
  // blocks an SM the kernel is compiled for (a register cap of 65536 /
  // (128 x blocks)): unbounded, E takes 204 and 236 registers at d = 32
  // and 64; held to 168 at d = 32 (three blocks) it spills nothing and
  // runs faster, at d = 64 it spills and runs slower
  // (experiments/flash_fwd_ablate.py)
  static constexpr int BLOCKS = D == 32 ? 3 : 2;
  static constexpr size_t QT = size_t(QUERIES) * LD * 2;
  static constexpr size_t KV = size_t(KEYS) * LD * 2;
  static constexpr size_t kSmem = QT + STAGES * 2 * KV;
  static_assert(KEYS % 16 == 0 && D % 16 == 0, "whole k16 steps");
};

// ------------------------------------------- the forward variants (#12)
// Compile-time variants of the bf16 forward for the reference's ablations
// of kernel E, over folded (b*h, s, d) operands with d = 64 (their C entry
// hands them to the kernel as b*h batches of one head):
//   kVarV2    experiments/flash_variants.py _fwd_v2 (fwd_call("v2")): E's
//             online softmax, but sm_scale multiplies the fp32 scores
//             (E rounds q*scale to bf16 first); l sums fp32 p;
//   kVarV3    _fwd_v3 (fwd_call("v3")): v2 with the row sum folded into
//             P.V: l is column 0 of P.[1 0 ... 0], the sum of bf16(p),
//             rescaled with the accumulator (the reference pads V by its
//             128-lane tile; here by one n8 fragment);
//   kVarV4    _fwd_v4 (fwd_call("v4")): v2 with two heads per block;
//   kVarV5    _fwd_v5 (fwd_v5_call): NH = 2 or 4 heads per block, V padded
//             once outside to d+64 with ones at column d, scores in base 2
//             (score_scale carries log2 e), l from column d, lse back in
//             base e;
//   kVarNoMax experiments/flash_ablate.py _fwd_nomax (nomax_call): no
//             running max: p = 2^(s log2 e) unguarded, l and the
//             accumulator are never rescaled; lse = log(l). Overflows once
//             a score passes ~88: a cost probe, not an attention kernel.
// Design: each variant is kernel E with its one lever changed. E's kernel
// (flash_fwd_tc_kernel below) is a template over the heads a block and the
// kind, every lever behind `if constexpr`; E is flash_fwd_tc_kernel<D, 1,
// kFwdE> and compiles to the code it had alone (the same registers and
// bits). So a variant's time against E's is its lever's cost. Per lever:
//   - v2-v5 stage q unscaled (no scale_tile) and multiply the fp32 score
//     fragments by score_scale before the row max; v5's scale carries
//     log2 e, so its p is 2^(s - m) (one FMUL, where E folds log2 e into
//     an FMA); nomax drops the shuffles, the rescale factor and the
//     rescales;
//   - v3's ones column is one more n8 accumulator fragment whose B
//     operand is a register constant (bf16 1.0 in the lanes of column 0,
//     else 0): one more mma.sync per 16 keys and row tile and no shared
//     memory. v5 reads that fragment from the padded copy: columns d..d+7
//     of each V row ride the ring as a third (64, 8) tile, read with
//     ldmatrix .x2.trans. l is column 0 of the fragment, summed over the
//     quad once at the end;
//   - NH heads a block (v4, v5) are NH groups of E's four warps, one head
//     each, with its own query tile and ring stages (FwdPlan::HEAD bytes);
//     each group copies its own head's rows and takes E's one barrier a
//     tile as a named barrier of its own (group_sync), so the heads of a
//     block never wait for each other (one block barrier for all is
//     slower: experiments/flash_variant_levers.py, PERF.md).
// Trouble with several heads a block, and what the plan does about it:
//   - shared memory is a head's 47-56 KB times NH (v4 108 KiB, v5h2 112,
//     v5h4 188 of the 227 a block may take), so such a block runs alone on
//     its SM;
//   - registers: the SM's 65536 are shared by a block's threads. E takes
//     ~236 a thread unbounded, so v4 and v5h2 (256 threads, 255 a thread)
//     keep E's two 16-row tiles a warp. At 512 threads (v5h4) 128 are left
//     a thread, where two tiles a warp spill (the "3 blocks/SM" ablation of
//     experiments/flash_fwd_ablate.py spills at 168), so v5h4 runs one
//     16-row tile a warp, 64 queries a head (E's "1 row tile/warp"), and
//     reads its qs fragments from shared memory per key tile as E does at
//     d = 256 (held in registers they spill more and run slower; the same
//     script).
//   Each instantiation's registers, spills, shared memory and blocks an SM
//   are printed by chip_smoke.py's variant phase.
// All mask key j > query i + (s_k - s_q) under causal masking and keys
// past s_k (p = 0), skip key tiles wholly above the diagonal, and write
// out = bf16(acc / l) and fp32 lse, as E does.
// Bound: E's (4*b*h*pairs*d flops over the tensor cores' 989.4 TFLOP/s:
// 0.052 ms causal at b*h 96, s 2048); v3 and v5 execute one more n8
// fragment per eight of P.V.
enum FwdKind { kVarV2 = 0, kVarV3, kVarV4, kVarV5, kVarNoMax, kFwdE };
constexpr int kErrVariant = -4;    // variant / heads-per-block not compiled
constexpr int kErrHeads = -5;      // b*h not divisible by heads per block
constexpr int kErrPass = -6;       // not a pass of E, G or F

// A launch of flash_fwd_tc_kernel: E's tiles, NH heads a block, kind KIND.
template <int D, int NH, int KIND> struct FwdPlan {
  using E = FwdTile<D>;
  static constexpr bool IS_E = KIND == kFwdE;
  static constexpr bool NOMAX = KIND == kVarNoMax;
  static constexpr bool BASE2 = KIND == kVarV5;   // scores times log2 e
  static constexpr bool SUMFOLD = KIND == kVarV3 || KIND == kVarV5;
  static constexpr bool VPAD = KIND == kVarV5;    // ones from the padded V
  // 16-row tiles a warp: one at four heads a block (128 registers a thread)
  static constexpr int RT = NH == 4 ? 1 : E::RT;
  // qs fragments in registers; at four heads a block (128 registers a
  // thread) read from shared memory per key tile, as E at d = 256
  static constexpr bool QREG = NH == 4 ? false : E::QREG;
  static constexpr int QUERIES = 16 * RT * E::WARPS;   // a head's
  static constexpr int THREADS = E::THREADS * NH;      // a group a head
  static constexpr int BLOCKS = NH == 1 ? E::BLOCKS : 1;
  // a ring stage: K, V and (v5) the (KEYS, 8) ones chunk, in elements
  static constexpr int STAGE =
      2 * E::KEYS * E::LD + (VPAD ? E::KEYS * 8 : 0);
  static constexpr size_t HEAD =
      (size_t(QUERIES) * E::LD + size_t(E::STAGES) * STAGE) * 2;
  static constexpr size_t kSmem = NH * HEAD;
  static_assert(!IS_E || (NH == 1 && kSmem == E::kSmem), "E's own plan");
  static_assert(IS_E || D == 64, "the variants are compiled for d = 64");
};

// A head group's barrier: the block's when the block is one group, else
// named barrier 1 + grp over the group's NT threads (the heads of a block
// do not wait for each other)
template <int NH, int NT>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (NH == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(NT) : "memory");
}

// A row's lse from its running max and l (> 0): E, v2-v4 m + log(l); v5
// in base 2, back to base e; nomax log(l)
template <typename PL>
__device__ __forceinline__ float lse_of(float m, float l) {
  if constexpr (PL::NOMAX)
    return logf(l);
  else if constexpr (PL::BASE2)
    return (m + log2f(l)) * 0.6931471805599453f;
  else
    return m + logf(l);
}

// Kernel E (NH = 1, KIND = kFwdE) and its variants (d = 64): one block
// per (query tile, NH heads of the folded batch*head), a group of E's
// warps a head. (A __device__ body behind two kernels cost E a register
// at d = 128: one kernel template keeps E's code as it was.)
template <int D, int NH = 1, int KIND = kFwdE>
__global__ void __launch_bounds__(FwdPlan<D, NH, KIND>::THREADS,
                                  FwdPlan<D, NH, KIND>::BLOCKS)
    flash_fwd_tc_kernel(const Params p) {
  using TL = FwdTile<D>;
  using PL = FwdPlan<D, NH, KIND>;
  constexpr int LD = TL::LD, NT = TL::THREADS, BQ = PL::QUERIES;
  constexpr int RT = PL::RT, BK = TL::KEYS, NK8 = BK / 8, ND8 = D / 8;
  constexpr int KD = D / 16, STAGE = PL::STAGE;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's group (its head of the block), and its place there
  const int grp = NH > 1 ? warp / TL::WARPS : 0;
  const int gtid = NH > 1 ? tid % NT : tid;
  const int gwarp = NH > 1 ? warp % TL::WARPS : warp;
  bf16* sQ = reinterpret_cast<bf16*>(smem) + grp * (PL::HEAD / 2);  // qs
  bf16* ring = sQ + BQ * LD;                     // STAGES x (K, V[, ones])

  const int g = lane >> 2, t = lane & 3, r0 = 16 * RT * gwarp;
  // the heaviest tiles (the last under causal masking) start first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y * NH + grp, b = bh / p.h, hh = bh - b * p.h;
  const int q0 = qt * BQ, nq = min(BQ, p.sq - q0);
  const bf16* qp = head_ptr<bf16>(p.q, p.st[kQ], b, hh);
  const bf16* kp = head_ptr<bf16>(p.k, p.st[kK], b, hh);
  const bf16* vp = head_ptr<bf16>(p.v, p.st[kV], b, hh);
  const long long sq_ = p.st[kQ][2], sk_ = p.st[kK][2], sv = p.st[kV][2];
  const bool vq = aligned16(qp, sq_), vk = aligned16(kp, sk_);
  const bool vv = aligned16(vp, sv);

  const int k_end =
      p.causal ? min(p.sk, q0 + nq - 1 + p.offset + 1) : p.sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  copy_rows<D, LD, BQ, NT>(sQ, qp, sq_, q0, nq, vq,
                           PL::IS_E ? p.q_scale : 0.f, gtid);
  copy_rows<D, LD, BK, NT>(ring, kp, sk_, 0, min(BK, p.sk), vk, 0.f, gtid);
  copy_rows<D, LD, BK, NT>(ring + BK * LD, vp, sv, 0, min(BK, p.sk), vv,
                           0.f, gtid);
  if constexpr (PL::VPAD)
    copy_rows<8, 8, BK, NT>(ring + 2 * BK * LD, vp + D, sv, 0,
                            min(BK, p.sk), vv, 0.f, gtid);
  cp_async_commit();
  cp_async_wait_all();
  if constexpr (PL::IS_E) {
    if (vq) scale_tile<D, BQ, NT>(sQ, p.q_scale);
  }
  group_sync<NH, NT>(grp);

  // this warp's qs rows as A fragments: row tile j, k16 step kk
  const int arow = r0 + (lane & 15), acol = (lane >> 4) * 8;
  uint32_t qf[RT][PL::QREG ? KD : 1][4];
  if constexpr (PL::QREG) {
#pragma unroll
    for (int j = 0; j < RT; ++j)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[j][kk], sQ + (arow + 16 * j) * LD + kk * 16 + acol);
  }
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  const int xrow = lane & 15, xcol = (lane >> 4) * 8;
  // the variants' multiplier of the fp32 scores (nomax: times log2 e);
  // v3's ones column as a B fragment: bf16 1.0 in column 0's lanes
  const float sc = PL::NOMAX ? p.score_scale * kLog2e : p.score_scale;
  const uint32_t ones = g == 0 ? 0x3F803F80u : 0u;

  // rows 16 j + g and 16 j + g + 8 of this warp: the running max, this
  // thread's part of the running sum, and the accumulator fragments (v3,
  // v5: and the ones column's, whose column 0 is l)
  float m_r[RT][2], l_r[RT][2], acc[RT][ND8][4];
  float acc_l[RT][PL::SUMFOLD ? 4 : 1];
#pragma unroll
  for (int j = 0; j < RT; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_r[j][r] = -INFINITY;
      l_r[j][r] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;
    if constexpr (PL::SUMFOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_l[j][i] = 0.f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    const bf16* sK = ring + (it & 1) * STAGE;
    const bf16* sV = sK + BK * LD;
    if (it > 0) {
      cp_async_wait_all();
      group_sync<NH, NT>(grp);   // tile `it` landed; it-1's readers are done
    }
    if (it + 1 < n_tiles) {   // the next tile's copy overlaps this tile
      const int k1 = k0 + BK, n1 = min(BK, p.sk - k1);
      bf16* nK = ring + ((it + 1) & 1) * STAGE;
      copy_rows<D, LD, BK, NT>(nK, kp, sk_, k1, n1, vk, 0.f, gtid);
      copy_rows<D, LD, BK, NT>(nK + BK * LD, vp, sv, k1, n1, vv, 0.f, gtid);
      if constexpr (PL::VPAD)
        copy_rows<8, 8, BK, NT>(nK + 2 * BK * LD, vp + D, sv, k1, n1, vv,
                                0.f, gtid);
      cp_async_commit();
    }
    // s = qs . k^T for this warp's rows; each K fragment serves all RT
    float s[RT][NK8][4];
#pragma unroll
    for (int j = 0; j < RT; ++j)
#pragma unroll
      for (int n = 0; n < NK8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[RT][4];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        if constexpr (PL::QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[j][i] = qf[j][kk][i];
        } else {
          ldsm_x4(a[j], sQ + (arow + 16 * j) * LD + kk * 16 + acol);
        }
      }
#pragma unroll
      for (int np = 0; np < NK8 / 2; ++np) {
        uint32_t fb[4];
        ldsm_x4(fb, sK + (np * 16 + brow) * LD + kk * 16 + bcol);
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          mma_bf16(s[j][2 * np], a[j], fb[0], fb[1]);
          mma_bf16(s[j][2 * np + 1], a[j], fb[2], fb[3]);
        }
      }
    }
    const bool full = q0 + BQ <= p.sq && k0 + BK <= p.sk &&
                      (!p.causal || k0 + BK - 1 <= q0 + p.offset);
    auto to_p = [&](auto masked) {   // one copy of the loop per case
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        if constexpr (PL::NOMAX) {   // no max: p = 2^(s log2 e) as it is
#pragma unroll
          for (int n = 0; n < NK8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float x = s[j][n][i] * sc;
              if constexpr (decltype(masked)::value) {
                const int row = q0 + r0 + 16 * j + g + 8 * (i >> 1);
                const int key = k0 + n * 8 + 2 * t + (i & 1);
                if (key >= p.sk || (p.causal && key > row + p.offset))
                  x = -INFINITY;
              }
              s[j][n][i] = exp2_approx(x);
              l_r[j][i >> 1] += s[j][n][i];
            }
          continue;
        }
        float mt[2] = {m_r[j][0], m_r[j][1]};
#pragma unroll
        for (int n = 0; n < NK8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (!PL::IS_E) s[j][n][i] *= sc;
            if constexpr (decltype(masked)::value) {
              const int row = q0 + r0 + 16 * j + g + 8 * (i >> 1);
              const int key = k0 + n * 8 + 2 * t + (i & 1);
              if (key >= p.sk || (p.causal && key > row + p.offset))
                s[j][n][i] = -INFINITY;   // p = 0, as exp(-1e30 - m)
            }
            mt[i >> 1] = fmaxf(mt[i >> 1], s[j][n][i]);
          }
        float m2[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
          if constexpr (PL::BASE2)
            alpha[r] = exp2_approx(m_r[j][r] - mt[r]);
          else
            alpha[r] = exp2_approx((m_r[j][r] - mt[r]) * kLog2e);  // 0 first
          m2[r] = mt[r] * kLog2e;
          m_r[j][r] = mt[r];
          if constexpr (!PL::SUMFOLD) l_r[j][r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < NK8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float pr;
            if constexpr (PL::BASE2)
              pr = exp2_approx(s[j][n][i] - mt[i >> 1]);
            else
              pr = exp2_approx(fmaf(s[j][n][i], kLog2e, -m2[i >> 1]));
            s[j][n][i] = pr;
            if constexpr (!PL::SUMFOLD) l_r[j][i >> 1] += pr;
          }
#pragma unroll
        for (int n = 0; n < ND8; ++n) {
          acc[j][n][0] *= alpha[0];
          acc[j][n][1] *= alpha[0];
          acc[j][n][2] *= alpha[1];
          acc[j][n][3] *= alpha[1];
        }
        if constexpr (PL::SUMFOLD) {
          acc_l[j][0] *= alpha[0];
          acc_l[j][1] *= alpha[0];
          acc_l[j][2] *= alpha[1];
          acc_l[j][3] *= alpha[1];
        }
      }
    };
    if (full)
      to_p(std::false_type());
    else
      to_p(std::true_type());
    // acc += p . v: p packed as bf16 A fragments (the m16n8 accumulator
    // pair 2kk, 2kk+1 is the m16k16 A fragment of key step kk); each V
    // fragment, read transposed, serves all RT
#pragma unroll
    for (int kk = 0; kk < NK8 / 2; ++kk) {
      uint32_t a[RT][4];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        a[j][0] = pack_bf16(s[j][2 * kk][0], s[j][2 * kk][1]);
        a[j][1] = pack_bf16(s[j][2 * kk][2], s[j][2 * kk][3]);
        a[j][2] = pack_bf16(s[j][2 * kk + 1][0], s[j][2 * kk + 1][1]);
        a[j][3] = pack_bf16(s[j][2 * kk + 1][2], s[j][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < ND8 / 2; ++dp) {
        uint32_t fb[4];
        ldsm_x4_t(fb, sV + (kk * 16 + xrow) * LD + xcol + dp * 16);
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          mma_bf16(acc[j][2 * dp], a[j], fb[0], fb[1]);
          mma_bf16(acc[j][2 * dp + 1], a[j], fb[2], fb[3]);
        }
      }
      if constexpr (PL::SUMFOLD) {   // l += p . [1 0 ... 0]
        uint32_t fo[2] = {ones, ones};
        if constexpr (PL::VPAD)   // column d of the padded V, as it came
          ldsm_x2_t(fo, sV + BK * LD + (kk * 16 + xrow) * 8);
#pragma unroll
        for (int j = 0; j < RT; ++j) mma_bf16(acc_l[j], a[j], fo[0], fo[1]);
      }
    }
  }

  // out = acc / l as bf16 into this warp's rows of the query tile, then
  // 16-byte row chunks; lse once per row
  __syncwarp();   // this warp's qs rows are no longer read
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (PL::SUMFOLD)   // column 0 lives in the quad's lane 0
        l_r[j][r] = acc_l[j][2 * r] + acc_l[j][2 * r + 1];
      l_r[j][r] += __shfl_xor_sync(0xffffffffu, l_r[j][r], 1);
      l_r[j][r] += __shfl_xor_sync(0xffffffffu, l_r[j][r], 2);
      inv[r] = l_r[j][r] > 0.f ? 1.f / l_r[j][r] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND8; ++n) {
      acc[j][n][0] *= inv[0];
      acc[j][n][1] *= inv[0];
      acc[j][n][2] *= inv[1];
      acc[j][n][3] *= inv[1];
    }
    frag_to_tile<D, ND8>(sQ, acc[j], r0 + 16 * j, 0, 1.f);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 16 * j + g + 8 * r;
        if (row < nq)
          p.lse[static_cast<long long>(bh) * p.sq + q0 + row] =
              lse_of<PL>(m_r[j][r], fmaxf(l_r[j][r], 1e-30f));
      }
    }
  }
  __syncwarp();
  const int rows = min(16 * RT, nq - r0);
  bf16* op = head_ptr_mut<bf16>(p.out, p.st[kO], b, hh);
  const long long so = p.st[kO][2];
  if (aligned16(op, so)) {
    for (int e = lane; e < rows * ND8; e += 32) {
      const int r = e / ND8, c = (e % ND8) * 8;
      *reinterpret_cast<uint4*>(op + (q0 + r0 + r) * so + c) =
          *reinterpret_cast<const uint4*>(sQ + (r0 + r) * LD + c);
    }
  } else {
    for (int e = lane; e < rows * D; e += 32) {
      const int r = e / D, c = e % D;
      op[(q0 + r0 + r) * so + c] = sQ[(r0 + r) * LD + c];
    }
  }
}

// ------------------------------------------------------------ launchers
// Above 48 KB a block's dynamic shared memory must be opted into; each
// launcher instantiation does it once for its own kernels.
int opt_in_smem(void (*kernel)(Params), size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The three passes: E, and the backward's two kernels in their launch
// order (G writes the delta scratch that F reads).
enum Pass { kPassFwd = 0, kPassDQ = 1, kPassDKDV = 2 };

// fp32 runs the FMA kernels above (Tile), bf16 the tensor-core ones
// (FwdTile, BwdTile); only those instantiations are compiled.
template <typename T, int D>
int launch(const Params& p, int bh, int pass, cudaStream_t stream) {
  void (*kernel)(Params);
  size_t smem;
  int rows, threads = kThreads;
  if constexpr (std::is_same_v<T, bf16>) {
    using BT = BwdTile<D>;
    if (pass == kPassFwd) {
      kernel = flash_fwd_tc_kernel<D>;
      smem = FwdTile<D>::kSmem;
      rows = FwdTile<D>::QUERIES;
      threads = FwdTile<D>::THREADS;
    } else if (pass == kPassDQ) {
      kernel = flash_bwd_dq_tc_kernel<D>;
      smem = BT::kGSmem;
      rows = BT::G_QUERIES;
      threads = BT::THREADS;
    } else {
      kernel = flash_bwd_dkdv_tc_kernel<D>;
      smem = BT::kFSmem;
      rows = BT::F_KEYS;
      threads = BT::THREADS;
    }
  } else {
    kernel = pass == kPassFwd  ? flash_fwd_kernel<T, D>
             : pass == kPassDQ ? flash_bwd_dq_kernel<T, D>
                               : flash_bwd_dkdv_kernel<T, D>;
    smem = pass == kPassFwd ? Tile<D>::kFwdSmem : Tile<D>::kBwdSmem;
    rows = Tile<D>::ROWS;
  }
  static bool opted[3] = {false, false, false};
  if (!opted[pass]) {
    if (const int rc = opt_in_smem(kernel, smem)) return rc;
    opted[pass] = true;
  }
  const int n = pass == kPassDKDV ? p.sk : p.sq;
  const dim3 grid((n + rows - 1) / rows, bh);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int pass, int d, const Params& p, int bh, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, bh, pass, stream);
    case 64: return launch<T, 64>(p, bh, pass, stream);
    case 128: return launch<T, 128>(p, bh, pass, stream);
    case 256: return launch<T, 256>(p, bh, pass, stream);
    default: return kErrHeadDim;
  }
}

int run(int pass, const Params& p, int b, int d, int dtype, void* stream) {
  const int bh = b * p.h;
  if (bh <= 0 || p.sq <= 0 || p.sk <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch<float>(pass, d, p, bh, st);
  if (dtype == kBF16) return dispatch<bf16>(pass, d, p, bh, st);
  return kErrDType;
}

void set_strides(Params& p, const long long* strides, int n) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
}

// The variant kernel of (variant, heads a block) as f(NH, KIND) with both
// as std::integral_constant, or kErrVariant where none is compiled.
template <typename F>
int with_variant(int variant, int n_heads, F&& f) {
  using std::integral_constant;
  switch (variant * 8 + n_heads) {
    case kVarV2 * 8 + 1:
      return f(integral_constant<int, 1>(), integral_constant<int, kVarV2>());
    case kVarV3 * 8 + 1:
      return f(integral_constant<int, 1>(), integral_constant<int, kVarV3>());
    case kVarV4 * 8 + 2:
      return f(integral_constant<int, 2>(), integral_constant<int, kVarV4>());
    case kVarV5 * 8 + 2:
      return f(integral_constant<int, 2>(), integral_constant<int, kVarV5>());
    case kVarV5 * 8 + 4:
      return f(integral_constant<int, 4>(), integral_constant<int, kVarV5>());
    case kVarNoMax * 8 + 1:
      return f(integral_constant<int, 1>(),
               integral_constant<int, kVarNoMax>());
    default: return kErrVariant;
  }
}

template <int NH, int KIND>
int launch_variant(const Params& p, int bh, cudaStream_t stream) {
  using PL = FwdPlan<64, NH, KIND>;
  if (bh % NH) return kErrHeads;
  void (*kernel)(Params) = flash_fwd_tc_kernel<64, NH, KIND>;
  static bool opted = false;
  if (!opted) {
    if (const int rc = opt_in_smem(kernel, PL::kSmem)) return rc;
    opted = true;
  }
  const dim3 grid((p.sq + PL::QUERIES - 1) / PL::QUERIES, bh / NH);
  kernel<<<grid, PL::THREADS, PL::kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The forward variants of kernel E (#12; see the section above). q, k, v,
// out: (b*h, s, 64) bf16 with (head, position) element strides in
// `strides` (8 int64: q, k, v, out; the head_dim stride is 1; for variant
// kVarV5, v is the (b*h, s_k, 128) padded copy); lse: (b*h, s_q) fp32.
// variant: 0 v2, 1 v3, 2 v4 (n_heads 2), 3 v5 (n_heads 2 or 4), 4 nomax.
// Returns 0, a negative code of this file, or a cudaError_t.
extern "C" int flash_fwd_variant(const void* q, const void* k, const void* v,
                                 void* out, float* lse,
                                 const long long* strides, int bh, int sq,
                                 int sk, int d, int causal, int variant,
                                 int n_heads, float score_scale,
                                 void* stream) {
  if (d != 64) return kErrHeadDim;
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  Params p = {};   // b*h batches of one head
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  const int operand[4] = {kQ, kK, kV, kO};
  for (int i = 0; i < 4; ++i) {
    p.st[operand[i]][0] = strides[2 * i];
    p.st[operand[i]][2] = strides[2 * i + 1];
  }
  p.h = 1;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.offset = causal ? sk - sq : 0;
  p.score_scale = score_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_variant(variant, n_heads, [&](auto nh, auto kind) {
    return launch_variant<decltype(nh)::value, decltype(kind)::value>(
        p, bh, st);
  });
}

// A variant's footprint: the dynamic shared memory and threads a block
// takes and the blocks an SM holds by the runtime's occupancy calculator.
// Returns 0, a negative code of this file, or a cudaError_t.
extern "C" int flash_fwd_variant_occupancy(int variant, int n_heads,
                                           int* smem, int* threads,
                                           int* blocks) {
  return with_variant(variant, n_heads, [&](auto nh, auto kind) {
    constexpr int NH = decltype(nh)::value, KIND = decltype(kind)::value;
    using PL = FwdPlan<64, NH, KIND>;
    void (*kernel)(Params) = flash_fwd_tc_kernel<64, NH, KIND>;
    *smem = static_cast<int>(PL::kSmem);
    *threads = PL::THREADS;
    if (const int rc = opt_in_smem(kernel, PL::kSmem)) return rc;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, PL::THREADS, PL::kSmem));
  });
}

// Kernel E. q, k, v, out: (b, h, s, d) element strides in `strides` (12
// int64: q, k, v, out; the head_dim stride is 1); lse: (b, h, s_q) fp32.
// dtype 0 = fp32, 1 = bf16 (all four operands). Returns 0, a negative code
// of this file, or a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   const long long* strides, int b, int h,
                                   int sq, int sk, int d, int causal,
                                   float q_scale, int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  set_strides(p, strides, 3);
  for (int j = 0; j < 3; ++j) p.st[kO][j] = strides[9 + j];
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.offset = causal ? sk - sq : 0;
  p.q_scale = q_scale;
  return run(kPassFwd, p, b, d, dtype, stream);
}

namespace {

int backward_pass(int pass, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  const float* glse, float* delta, void* qs, void* dq,
                  void* dk, void* dv, const long long* strides, int b, int h,
                  int sq,
                  int sk, int d, int causal, float q_scale, float dq_scale,
                  int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.glse = glse;
  p.delta = delta;
  p.qs = qs;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  set_strides(p, strides, kOperands);
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.offset = causal ? sk - sq : 0;
  p.q_scale = q_scale;
  p.dq_scale = dq_scale;
  return run(pass, p, b, d, dtype, stream);
}

}  // namespace

// The backward is two launches on one stream, G then F. Both entries take
// the same arguments: operands q, k, v, o (the forward's output), dout,
// dq, dk, dv with (b, h, s, d) element strides in `strides` (24 int64, in
// that order); lse, glse (optional, nullptr for none) and delta are
// (b, h, s_q) fp32; qs is a contiguous (b, h, s_q, d) scratch of the
// operands' dtype. bf16: G writes delta = rowsum(dout * o) - glse, qs =
// round_bf16(q * q_scale) and dq; F reads delta and qs and writes dk and
// dv. fp32: each kernel computes delta and qs itself and the scratches are
// not touched. Each returns 0, a negative code of this file, or a
// cudaError_t.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, const float* glse, float* delta,
    void* qs, void* dq, void* dk, void* dv, const long long* strides, int b,
    int h, int sq, int sk, int d, int causal, float q_scale, float dq_scale,
    int dtype, void* stream) {
  return backward_pass(kPassDQ, q, k, v, o, dout, lse, glse, delta, qs, dq,
                       dk, dv, strides, b, h, sq, sk, d, causal, q_scale,
                       dq_scale, dtype, stream);
}

extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, const float* glse, float* delta,
    void* qs, void* dq, void* dk, void* dv, const long long* strides, int b,
    int h, int sq, int sk, int d, int causal, float q_scale, float dq_scale,
    int dtype, void* stream) {
  return backward_pass(kPassDKDV, q, k, v, o, dout, lse, glse, delta, qs,
                       dq, dk, dv, strides, b, h, sq, sk, d, causal, q_scale,
                       dq_scale, dtype, stream);
}

namespace {

template <int D>
int tc_occupancy(int pass, int* smem, int* threads, int* blocks) {
  using BT = BwdTile<D>;
  void (*kernel)(Params) = pass == kPassFwd  ? flash_fwd_tc_kernel<D>
                           : pass == kPassDQ ? flash_bwd_dq_tc_kernel<D>
                                             : flash_bwd_dkdv_tc_kernel<D>;
  *smem = static_cast<int>(pass == kPassFwd  ? FwdTile<D>::kSmem
                           : pass == kPassDQ ? BT::kGSmem
                                             : BT::kFSmem);
  *threads = pass == kPassFwd ? FwdTile<D>::THREADS : BT::THREADS;
  if (const int rc = opt_in_smem(kernel, *smem)) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       *threads, *smem);
}

}  // namespace

// The bf16 kernels' footprint at head_dim d (pass 0 = E, 1 = G, 2 = F):
// the dynamic shared memory and threads a block takes, and the blocks an
// SM holds by the runtime's occupancy calculator. Returns 0, a negative
// code of this file, or a cudaError_t.
extern "C" int flash_attention_occupancy(int d, int pass, int* smem,
                                         int* threads, int* blocks) {
  if (pass != kPassFwd && pass != kPassDQ && pass != kPassDKDV)
    return kErrPass;
  switch (d) {
    case 32: return tc_occupancy<32>(pass, smem, threads, blocks);
    case 64: return tc_occupancy<64>(pass, smem, threads, blocks);
    case 128: return tc_occupancy<128>(pass, smem, threads, blocks);
    case 256: return tc_occupancy<256>(pass, smem, threads, blocks);
    default: return kErrHeadDim;
  }
}
