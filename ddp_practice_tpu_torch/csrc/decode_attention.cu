// Single-token decode attention for sm_90a, over the flat (b, L, h*hd) KV
// cache and over the paged (num_blocks, block_size, h*hd) block pool. Built
// with nvcc into a shared library with a plain C interface
// (ddp_practice_tpu_torch/ops/cuda_build.py) and launched through ctypes by
// ddp_practice_tpu_torch/ops/decode_attention.py.
//
// Replaces the Pallas TPU kernels of ddp_practice_tpu/ops/decode_attention.py:
//   kernel A (decode_attention): decode_attention_packed's _kernel_single
//     and _kernel (the multi-block online softmax of _online_softmax_cell),
//     fp32 or bf16 flat caches;
//   kernel B (decode_attention_int8): _kernel_single_quant and the
//     dequantizing branch that feeds _kernel for long caches, int8 flat
//     caches with per-(batch, head, position) fp32 scales;
//   kernel C (paged_decode_attention): paged_decode_attention's
//     _paged_kernel, fp32 or bf16 block pools walked through a per-slot
//     page table with per-slot cursors;
//   kernel D (paged_decode_attention_int8): _paged_kernel_quant, an int8
//     block pool with per-block (num_blocks, h, block_size) fp32 scale pages.
//
// What it computes, per (batch/slot b, head h), over the valid keys
// j in [start_b, last_b] (flat: last = cur, shared; paged: last =
// min(lengths[b], mb*bs - 1), per slot; start_b = attn_start[b] or 0):
//   qs   = round_Tq(q * scale)
//   s_j  = <qs, k_j>                              (fp32 sums)
//   p_j  = exp(s_j - max_j s_j);  l = sum_j p_j
//   out  = round_Tq( sum_j round_Tp(p_j) * v_j / l )
// Tq is q's dtype. Where the rounding and the int8 scales go follows the
// TPU kernel each one replaces:
//   A: Tp = Tq.
//   B: k_j, v_j = round_Tq(int8 * scale_j) (the reference's dequantizing
//      branch, computed here at every L); Tp = Tq.
//   C: Tp = the pool's dtype (the TPU kernel rounds p to the value tile's
//      dtype).
//   D: the scales fold into the rows, no dequantized tile: s_j = <qs,
//      k_j> * kscale_j with k_j the int8 values, and round_Tp(p_j) becomes
//      round_Tq(p_j * vscale_j) against the int8 v_j; l stays unscaled.
// The TPU kernels normalise per 256-position or block_size tile with an
// online max; these take the exact max over the whole range, so a bf16 run
// differs from the plain PyTorch version (which rounds at the same points)
// only by fp32 summation order. An empty range (start > last) gives zeros.
//
// Bound: HBM bytes. A step reads each valid key and value row once:
// 2 * sum_b (last_b - start_b + 1) * h * hd * bytes_per_elem (+ 2 * 4 bytes
// per valid position and head of scales for int8), at 3.35 TB/s on an H100
// SXM; the page table adds 4 bytes per block and slot, negligible. Paged
// slots may share blocks (the prefix cache, fork): HBM then need deliver
// each distinct (block, row) of the union of the slots' ranges only once,
// and the bound counts it once, though each slot's block reads it. The
// arithmetic is ~4 flop per byte read for bf16, far below the card's ridge
// point. Design for that bound: keys outside [start, last] are never read
// (the TPU kernels read whole tiles and mask them); each lane issues
// 16-byte loads, a group of lanes covers one key row, and every lane keeps
// kUnroll loads in flight so one block per (batch, head) streams its rows
// at a useful fraction of the bandwidth. Scores live in shared memory (4
// bytes per position), so K and V are each read exactly once and the
// softmax uses the exact global max — no online rescaling. A paged block
// first stages its slot's page-table row in shared memory, so finding a
// row costs a shared-memory read, not a dependent global load. One block
// per (batch, head) and no split over L is the simple first design: at
// batch 1 it fills only h of the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                 // 16-byte loads in flight per lane
constexpr size_t kMaxSmem = 232448;        // opt-in dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

// error codes below zero are this library's own; >0 are cudaError_t
constexpr int kErrHeadDim = -1;
constexpr int kErrSpan = -2;
constexpr int kErrDType = -3;

enum DType { kF32 = 0, kBF16 = 1 };

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

// round-to-nearest-even into T and back: the reference's `.astype(T)`.
// int8 rounds to itself (never used for a rounding point).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// 16 raw bytes of a cache row -> N floats
template <typename T> struct Unpack;
template <> struct Unpack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void run(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};
template <> struct Unpack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void run(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);             // low half first
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Unpack<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void run(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[4 * i + k] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * k)) & 0xffu));
  }
};

// How a block walks one head's rows: a group of G lanes reads one key row
// of D elements with PER 16-byte loads per lane; a warp covers KPW keys
// per step and the block NGROUPS keys.
template <typename TKV, int D> struct Layout {
  static constexpr int VEC = Unpack<TKV>::N;
  static constexpr int VECS = D / VEC;
  static constexpr int G = VECS < 32 ? VECS : 32;
  static constexpr int PER = VECS / G;
  static constexpr int KPW = 32 / G;
  static constexpr int NGROUPS = kWarps * KPW;
  static_assert(D % VEC == 0 && VECS % G == 0 && (G & (G - 1)) == 0,
                "head_dim must tile into 16-byte loads");
};

// Where key/value row j of batch b lives (in units of h*hd elements), where
// its scale lives, and which keys are valid. Flat cache: row b*L + j,
// keys [start_b, cur].
struct FlatRows {
  static constexpr bool kPaged = false;
  const int* attn_start;  // (b,) or nullptr
  int L, H, cur;
  __device__ __forceinline__ int first(int b) const {
    return attn_start != nullptr ? max(attn_start[b], 0) : 0;
  }
  __device__ __forceinline__ int last(int) const { return cur; }
  __device__ __forceinline__ long long row(int b, int j) const {
    return static_cast<long long>(b) * L + j;
  }
  __device__ __forceinline__ long long scale(int b, int hh, int j) const {
    return (static_cast<long long>(b) * H + hh) * L + j;
  }
};

// Paged pool: position j of slot b is row j % bs of pool block
// page_table[b, j / bs]; keys [start_b, min(lengths[b], mb*bs - 1)] (the
// TPU kernel's grid never reaches a table column >= mb). `table` is the
// slot's table row, staged in shared memory by the kernel.
struct PagedRows {
  static constexpr bool kPaged = true;
  const int* attn_start;  // (b,) or nullptr
  const int* page_table;  // (b, mb)
  const int* lengths;     // (b,), inclusive cursor
  const int* table;
  int mb, bs, H;
  __device__ __forceinline__ int first(int b) const {
    return attn_start != nullptr ? max(attn_start[b], 0) : 0;
  }
  __device__ __forceinline__ int last(int b) const {
    return min(lengths[b], mb * bs - 1);
  }
  __device__ __forceinline__ long long row(int, int j) const {
    return static_cast<long long>(table[j / bs]) * bs + j % bs;
  }
  __device__ __forceinline__ long long scale(int, int hh, int j) const {
    return (static_cast<long long>(table[j / bs]) * H + hh) * bs + j % bs;
  }
};

template <typename TQ, typename TKV, int D, bool QUANT, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, TQ* __restrict__ out, Rows rows,
    int span, float scale) {
  using Lay = Layout<TKV, D>;
  constexpr int VEC = Lay::VEC, G = Lay::G, PER = Lay::PER, KPW = Lay::KPW;
  constexpr int NG = Lay::NGROUPS;
  // int8 scales folded into the score and probability rows (kernel D)
  constexpr bool FOLD = QUANT && Rows::kPaged;
  // the dtype p is rounded to before p.v (see the header)
  using TP = std::conditional_t<Rows::kPaged && !QUANT, TKV, TQ>;

  extern __shared__ float smem[];
  float* s_q = smem;                    // D
  float* s_red = s_q + D;               // 2 * kWarps
  float* s_acc = s_red + 2 * kWarps;    // NG * D
  float* s_p = s_acc + NG * D;          // span: one per position

  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gk = lane / G;  // which key of the warp's step
  const int gl = lane % G;  // which slice of that key's row
  const long long hd = static_cast<long long>(rows.H) * D;

  if constexpr (Rows::kPaged) {
    int* s_pt = reinterpret_cast<int*>(s_p + span);   // mb table entries
    const int* src = rows.page_table + static_cast<long long>(b) * rows.mb;
    for (int i = tid; i < rows.mb; i += kThreads) s_pt[i] = src[i];
    rows.table = s_pt;
  }
  const int start = rows.first(b);
  const int last = rows.last(b);

  for (int i = tid; i < D; i += kThreads)
    s_q[i] = round_to<TQ>(to_float<TQ>(q[b * hd + hh * D + i]) * scale);
  __syncthreads();  // also publishes the staged page-table row
  float qr[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p)
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[p][e] = s_q[(p * G + gl) * VEC + e];

  const TKV* kb = k + hh * D;
  const TKV* vb = v + hh * D;

  // ---- scores: s_j = <qs, k_j> into shared memory, running max
  float mloc = -INFINITY;
  for (int base = start + warp * KPW; base <= last; base += NG * kUnroll) {
    uint4 raw[kUnroll][PER];
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * NG + gk;
#pragma unroll
      for (int p = 0; p < PER; ++p)
        raw[u][p] = j <= last ? __ldg(reinterpret_cast<const uint4*>(
                                    kb + rows.row(b, j) * hd +
                                    (p * G + gl) * VEC))
                              : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (QUANT)
        sc[u] = j <= last ? __ldg(ks + rows.scale(b, hh, j)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * NG + gk;
      float dot = 0.f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        float kf[VEC];
        Unpack<TKV>::run(raw[u][p], kf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float kv = kf[e];
          if constexpr (QUANT && !FOLD) kv = round_to<TQ>(kv * sc[u]);
          dot += qr[p][e] * kv;
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      if constexpr (FOLD) dot *= sc[u];
      if (j <= last) {
        if (gl == 0) s_p[j - start] = dot;
        mloc = fmaxf(mloc, dot);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mloc = fmaxf(mloc, __shfl_xor_sync(kFull, mloc, o));
  if (lane == 0) s_red[warp] = mloc;
  __syncthreads();
  float m = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_red[w]);

  // ---- probabilities: l sums the unrounded p; p.v uses round_Tp(p), or
  // for kernel D round_Tq(p * vscale) in the loop below
  const int n = last + 1 - start;
  float lloc = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float p = expf(s_p[i] - m);
    lloc += p;
    s_p[i] = FOLD ? p : round_to<TP>(p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lloc += __shfl_xor_sync(kFull, lloc, o);
  if (lane == 0) s_red[kWarps + warp] = lloc;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += s_red[kWarps + w];

  // ---- p.v: each lane group accumulates its keys' rows for its dims
  float acc[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[p][e] = 0.f;
  for (int base = start + warp * KPW; base <= last; base += NG * kUnroll) {
    uint4 raw[kUnroll][PER];
    float pj[kUnroll], sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * NG + gk;
#pragma unroll
      for (int p = 0; p < PER; ++p)
        raw[u][p] = j <= last ? __ldg(reinterpret_cast<const uint4*>(
                                    vb + rows.row(b, j) * hd +
                                    (p * G + gl) * VEC))
                              : make_uint4(0u, 0u, 0u, 0u);
      pj[u] = j <= last ? s_p[j - start] : 0.f;
      if constexpr (QUANT)
        sc[u] = j <= last ? __ldg(vs + rows.scale(b, hh, j)) : 0.f;
      if constexpr (FOLD) pj[u] = round_to<TQ>(pj[u] * sc[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        float vf[VEC];
        Unpack<TKV>::run(raw[u][p], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float vv = vf[e];
          if constexpr (QUANT && !FOLD) vv = round_to<TQ>(vv * sc[u]);
          acc[p][e] += pj[u] * vv;
        }
      }
    }
  }
  const int group = warp * KPW + gk;
#pragma unroll
  for (int p = 0; p < PER; ++p)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s_acc[group * D + (p * G + gl) * VEC + e] = acc[p][e];
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    float sum = 0.f;
#pragma unroll 4
    for (int g = 0; g < NG; ++g) sum += s_acc[g * D + i];
    // an empty range (start > last) yields zeros rather than 0/0
    out[b * hd + hh * D + i] = from_float<TQ>(l > 0.f ? sum / l : 0.f);
  }
}

// span: score slots in shared memory (flat: cur + 1; paged: mb * bs, the
// host-known capacity); extra_ints: the staged page-table row (paged: mb)
template <typename TQ, typename TKV, int D, bool QUANT, typename Rows>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* out, Rows rows, int B, int span,
           int extra_ints, float scale, cudaStream_t stream) {
  using Lay = Layout<TKV, D>;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(D) + 2 * kWarps +
                       static_cast<size_t>(Lay::NGROUPS) * D +
                       static_cast<size_t>(span)) +
      sizeof(int) * static_cast<size_t>(extra_ints);
  if (smem > kMaxSmem) return kErrSpan;
  auto kern = decode_attention_kernel<TQ, TKV, D, QUANT, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(rows.H, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, static_cast<TQ*>(out), rows, span,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT, typename Rows>
int dispatch_head_dim(int D, const void* q, const void* k, const void* v,
                      const float* ks, const float* vs, void* out, Rows rows,
                      int B, int span, int extra_ints, float scale,
                      cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<TQ, TKV, 64, QUANT, Rows>(q, k, v, ks, vs, out, rows, B,
                                              span, extra_ints, scale,
                                              stream);
    case 128:
      return launch<TQ, TKV, 128, QUANT, Rows>(q, k, v, ks, vs, out, rows, B,
                                               span, extra_ints, scale,
                                               stream);
    case 256:
      return launch<TQ, TKV, 256, QUANT, Rows>(q, k, v, ks, vs, out, rows, B,
                                               span, extra_ints, scale,
                                               stream);
    default:
      return kErrHeadDim;
  }
}

// fp32 q with fp32 or bf16 K/V, or bf16 throughout
template <typename Rows>
int dispatch_float(int q_dtype, int kv_dtype, int d, const void* q,
                   const void* k, const void* v, void* out, Rows rows, int b,
                   int span, int extra_ints, float scale, cudaStream_t st) {
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch_head_dim<float, float, false>(
        d, q, k, v, nullptr, nullptr, out, rows, b, span, extra_ints, scale,
        st);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, false>(
        d, q, k, v, nullptr, nullptr, out, rows, b, span, extra_ints, scale,
        st);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return dispatch_head_dim<float, __nv_bfloat16, false>(
        d, q, k, v, nullptr, nullptr, out, rows, b, span, extra_ints, scale,
        st);
  return kErrDType;
}

// int8 K/V with fp32 or bf16 q
template <typename Rows>
int dispatch_int8(int q_dtype, int d, const void* q, const void* k,
                  const void* v, const float* ks, const float* vs, void* out,
                  Rows rows, int b, int span, int extra_ints, float scale,
                  cudaStream_t st) {
  if (q_dtype == kF32)
    return dispatch_head_dim<float, int8_t, true>(
        d, q, k, v, ks, vs, out, rows, b, span, extra_ints, scale, st);
  if (q_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, int8_t, true>(
        d, q, k, v, ks, vs, out, rows, b, span, extra_ints, scale, st);
  return kErrDType;
}

}  // namespace

extern "C" {

// Kernel A. q/out (b, 1, h*d) in q_dtype; k/v (b, L, h*d) in kv_dtype;
// attn_start (b,) int32 or NULL. Returns 0, a cudaError_t, or a negative
// code above.
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     const int* attn_start, int b, int L, int h, int d,
                     int cur, float scale, int q_dtype, int kv_dtype,
                     void* stream) {
  const FlatRows rows{attn_start, L, h, cur};
  return dispatch_float(q_dtype, kv_dtype, d, q, k, v, out, rows, b, cur + 1,
                        0, scale, static_cast<cudaStream_t>(stream));
}

// Kernel B. As kernel A over an int8 cache; k_scale/v_scale (b, h, L) fp32.
int decode_attention_int8(const void* q, const void* k, const void* v,
                          const float* k_scale, const float* v_scale,
                          void* out, const int* attn_start, int b, int L,
                          int h, int d, int cur, float scale, int q_dtype,
                          void* stream) {
  const FlatRows rows{attn_start, L, h, cur};
  return dispatch_int8(q_dtype, d, q, k, v, k_scale, v_scale, out, rows, b,
                       cur + 1, 0, scale, static_cast<cudaStream_t>(stream));
}

// Kernel C. q/out (b, 1, h*d) in q_dtype; k/v pools (nb, bs, h*d) in
// kv_dtype; page_table (b, mb), lengths (b,) and attn_start (b,) int32 on
// the device (attn_start may be NULL). Every table entry a valid range
// reaches must be a block of the pool: the wrapper cannot check device
// data without a host sync, and the engine guarantees it.
int paged_decode_attention(const void* q, const void* k, const void* v,
                           void* out, const int* page_table,
                           const int* lengths, const int* attn_start, int b,
                           int bs, int mb, int h, int d, float scale,
                           int q_dtype, int kv_dtype, void* stream) {
  const PagedRows rows{attn_start, page_table, lengths, nullptr, mb, bs, h};
  return dispatch_float(q_dtype, kv_dtype, d, q, k, v, out, rows, b, mb * bs,
                        mb, scale, static_cast<cudaStream_t>(stream));
}

// Kernel D. As kernel C over an int8 pool; k_scale/v_scale are the
// (nb, h, bs) fp32 scale pages.
int paged_decode_attention_int8(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                void* out, const int* page_table,
                                const int* lengths, const int* attn_start,
                                int b, int bs, int mb, int h, int d,
                                float scale, int q_dtype, void* stream) {
  const PagedRows rows{attn_start, page_table, lengths, nullptr, mb, bs, h};
  return dispatch_int8(q_dtype, d, q, k, v, k_scale, v_scale, out, rows, b,
                       mb * bs, mb, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
