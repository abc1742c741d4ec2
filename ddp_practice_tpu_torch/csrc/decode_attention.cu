// Single-token decode attention over the flat (b, L, h*hd) KV cache, for
// sm_90a. Built with nvcc into a shared library with a plain C interface
// (ddp_practice_tpu_torch/ops/cuda_build.py) and launched through ctypes by
// ddp_practice_tpu_torch/ops/decode_attention.py.
//
// Replaces the Pallas TPU kernels of
//   ddp_practice_tpu/ops/decode_attention.py decode_attention_packed:
//   kernel A (decode_attention): _kernel_single and _kernel (the
//     multi-block online softmax of _online_softmax_cell), fp32 or bf16
//     caches;
//   kernel B (decode_attention_int8): _kernel_single_quant and the
//     dequantizing branch that feeds _kernel for long caches, int8 caches
//     with per-(batch, head, position) fp32 scales.
//
// What it computes, per (batch b, head h): with start = attn_start[b],
//   qs   = round_Tq(q * scale)
//   s_j  = <qs, k_j>                     j in [start, cur]   (fp32 sums)
//   p_j  = exp(s_j - max_j s_j);  l = sum_j p_j
//   out  = round_Tq( sum_j round_Tq(p_j) * v_j / l )
// where Tq is q's dtype (the compute dtype) and, for kernel B, k_j / v_j
// are round_Tq(int8 * scale_j) — the reference's dequantizing branch,
// computed here at every L. The rounding points are those of the
// reference's single-tile kernel (q*scale and p are rounded to the compute
// dtype before their products), so a bf16 run differs from the plain
// PyTorch version only by fp32 summation order.
//
// Bound: HBM bytes. A step reads each valid key and value row once:
// 2 * sum_b (cur - start_b + 1) * h * hd * bytes_per_elem (+ 2 * 4 bytes
// per position and head of scales for int8), at 3.35 TB/s on an H100 SXM;
// the arithmetic is ~4 flop per byte read for bf16, far below the card's
// ridge point. Design for that bound: keys outside [start, cur] are never
// read (the TPU kernel reads whole tiles and masks them); each lane issues
// 16-byte loads, a group of lanes covers one key row, and every lane keeps
// kUnroll loads in flight so one block per (batch, head) streams its rows
// at a useful fraction of the bandwidth. Scores live in shared memory
// (4 bytes per valid position), so K and V are each read exactly once and
// the softmax uses the exact global max — no online rescaling. One block
// per (batch, head) and no split over L is the simple first design: at
// batch 1 it fills only h of the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// round-to-nearest-even into T and back: the reference's `.astype(T)`
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

template <typename TQ, typename TKV, int D, bool QUANT>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, TQ* __restrict__ out,
    const int* __restrict__ attn_start, int L, int H, int cur, float scale) {
  using Lay = Layout<TKV, D>;
  constexpr int VEC = Lay::VEC, G = Lay::G, PER = Lay::PER, KPW = Lay::KPW;
  constexpr int NG = Lay::NGROUPS;

  extern __shared__ float smem[];
  float* s_q = smem;                    // D
  float* s_red = s_q + D;               // 2 * kWarps
  float* s_acc = s_red + 2 * kWarps;    // NG * D
  float* s_p = s_acc + NG * D;          // one per valid position

  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gk = lane / G;  // which key of the warp's step
  const int gl = lane % G;  // which slice of that key's row
  const long long hd = static_cast<long long>(H) * D;
  const int start = attn_start != nullptr ? max(attn_start[b], 0) : 0;

  for (int i = tid; i < D; i += kThreads)
    s_q[i] = round_to<TQ>(to_float<TQ>(q[b * hd + hh * D + i]) * scale);
  __syncthreads();
  float qr[PER][VEC];
#pragma unroll
  for (int p = 0; p < PER; ++p)
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[p][e] = s_q[(p * G + gl) * VEC + e];

  const long long row0 = static_cast<long long>(b) * L * hd + hh * D;
  const TKV* kb = k + row0;
  const TKV* vb = v + row0;
  const long long srow = (static_cast<long long>(b) * H + hh) * L;

  // ---- scores: s_j = <qs, k_j> into shared memory, running max
  float mloc = -INFINITY;
  for (int base = start + warp * KPW; base <= cur; base += NG * kUnroll) {
    uint4 raw[kUnroll][PER];
    float sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * NG + gk;
#pragma unroll
      for (int p = 0; p < PER; ++p)
        raw[u][p] = j <= cur ? __ldg(reinterpret_cast<const uint4*>(
                                   kb + j * hd + (p * G + gl) * VEC))
                             : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (QUANT) sc[u] = j <= cur ? __ldg(ks + srow + j) : 0.f;
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
          if constexpr (QUANT) kv = round_to<TQ>(kv * sc[u]);
          dot += qr[p][e] * kv;
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      if (j <= cur) {
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

  // ---- probabilities: l sums the unrounded p, p.v uses round_Tq(p)
  const int n = cur + 1 - start;
  float lloc = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float p = expf(s_p[i] - m);
    lloc += p;
    s_p[i] = round_to<TQ>(p);
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
  for (int base = start + warp * KPW; base <= cur; base += NG * kUnroll) {
    uint4 raw[kUnroll][PER];
    float pj[kUnroll], sc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * NG + gk;
#pragma unroll
      for (int p = 0; p < PER; ++p)
        raw[u][p] = j <= cur ? __ldg(reinterpret_cast<const uint4*>(
                                   vb + j * hd + (p * G + gl) * VEC))
                             : make_uint4(0u, 0u, 0u, 0u);
      pj[u] = j <= cur ? s_p[j - start] : 0.f;
      if constexpr (QUANT) sc[u] = j <= cur ? __ldg(vs + srow + j) : 0.f;
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
          if constexpr (QUANT) vv = round_to<TQ>(vv * sc[u]);
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
    // an empty range (start > cur) yields zeros rather than 0/0
    out[b * hd + hh * D + i] = from_float<TQ>(l > 0.f ? sum / l : 0.f);
  }
}

template <typename TQ, typename TKV, int D, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* out, const int* attn_start, int B, int L,
           int H, int cur, float scale, cudaStream_t stream) {
  using Lay = Layout<TKV, D>;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(D) + 2 * kWarps +
       static_cast<size_t>(Lay::NGROUPS) * D + static_cast<size_t>(cur) + 1);
  if (smem > kMaxSmem) return kErrSpan;
  auto kern = decode_attention_kernel<TQ, TKV, D, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, static_cast<TQ*>(out), attn_start,
      L, H, cur, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT>
int dispatch_head_dim(int D, const void* q, const void* k, const void* v,
                      const float* ks, const float* vs, void* out,
                      const int* attn_start, int B, int L, int H, int cur,
                      float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<TQ, TKV, 64, QUANT>(q, k, v, ks, vs, out, attn_start, B,
                                        L, H, cur, scale, stream);
    case 128:
      return launch<TQ, TKV, 128, QUANT>(q, k, v, ks, vs, out, attn_start, B,
                                         L, H, cur, scale, stream);
    case 256:
      return launch<TQ, TKV, 256, QUANT>(q, k, v, ks, vs, out, attn_start, B,
                                         L, H, cur, scale, stream);
    default:
      return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// Kernel A. q/out (b, 1, h*d) in q_dtype; k/v (b, L, h*d) in kv_dtype
// (fp32 q with fp32 or bf16 caches, or bf16 throughout); attn_start (b,)
// int32 or NULL. Returns 0, a cudaError_t, or a negative code above.
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     const int* attn_start, int b, int L, int h, int d,
                     int cur, float scale, int q_dtype, int kv_dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch_head_dim<float, float, false>(
        d, q, k, v, nullptr, nullptr, out, attn_start, b, L, h, cur, scale,
        st);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, false>(
        d, q, k, v, nullptr, nullptr, out, attn_start, b, L, h, cur, scale,
        st);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return dispatch_head_dim<float, __nv_bfloat16, false>(
        d, q, k, v, nullptr, nullptr, out, attn_start, b, L, h, cur, scale,
        st);
  return kErrDType;
}

// Kernel B. As kernel A over an int8 cache; k_scale/v_scale (b, h, L) fp32.
int decode_attention_int8(const void* q, const void* k, const void* v,
                          const float* k_scale, const float* v_scale,
                          void* out, const int* attn_start, int b, int L,
                          int h, int d, int cur, float scale, int q_dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_head_dim<float, int8_t, true>(
        d, q, k, v, k_scale, v_scale, out, attn_start, b, L, h, cur, scale,
        st);
  if (q_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, int8_t, true>(
        d, q, k, v, k_scale, v_scale, out, attn_start, b, L, h, cur, scale,
        st);
  return kErrDType;
}

}  // extern "C"
