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
//   p_j  = exp(s_j - m);  l = sum_j p_j
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
// An empty range (start > last) gives zeros.
//
// Bound: HBM bytes. A step reads each valid key and value row once:
// 2 * sum_b (last_b - start_b + 1) * h * hd * bytes_per_elem (+ 2 * 4 bytes
// per valid position and head of scales for int8), at 3.35 TB/s on an H100
// SXM; the page table adds 4 bytes per block and slot, negligible. Paged
// slots may share blocks (the prefix cache, fork): HBM then need deliver
// each distinct (block, row) of the union of the slots' ranges only once,
// and the bound counts it once, though each slot's block reads it. The
// arithmetic is ~4 flop per byte read for bf16, far below the card's ridge
// point, so the design is about keeping enough bytes in flight:
//
// - Split over the cache (flash-decoding). The wrapper's plan
//   (`_split_plan`, from host-known ints only: flat cur + 1, paged the
//   capacity mb*bs) gives S, a chunk and a span, the most keys one split
//   holds in shared memory (~112 KB of K and V rows). A (batch, head)'s
//   valid keys [first, last] go to one split when there are at most span
//   of them, else to ceil(len / chunk) splits of chunk keys from `first`
//   on, so batch 1 over a long cache reaches a wave of blocks instead of
//   h; paged chunks are whole pages. Every block derives a (batch,
//   head)'s split count from the same cursors, so a split past it exits
//   without a copy (a paged slot's capacity past its cursor costs a
//   launch, not a pass).
// - Inside a split, K and V are in flight together: every thread issues
//   its 16-byte cp.async copies of the split's key AND value rows (and its
//   int8 scales) at once, into shared memory, the K rows as one group and
//   the V rows as the next, so the scores are computed while V lands. Only
//   a valid key's rows are copied; a paged split stages its own pages'
//   table entries. The chunk's scores stay in shared memory, so p is
//   rounded against the split's exact max. No length limit remains: a
//   longer range is more splits.
// - The blocks are persistent: one per resident slot walks the (split,
//   batch, head) items, heads fastest, and keeps the K and V buffers in
//   turn busy: the next item's K rows land during this item's p.v and
//   epilogue, its V rows during its own scores.
// - One split of a (batch, head) writes `out` directly, as the plain
//   version computes it (the exact max over the whole range); an empty
//   range writes zeros. Several combine in the same launch: each writes
//   (m_s, l_s, acc_s[D]) in fp32 to the wrapper's scratch of (b, h, S,
//   D+2) floats (the acc rows, then the (m, l) pairs, so a row is 16-byte
//   aligned) and arrives on the (batch, head)'s int32 counter
//   (__threadfence + atomicAdd). The last to arrive merges in one pass:
//   m = max m_s, out = round_Tq(sum e^(m_s-m) acc_s / sum e^(m_s-m) l_s),
//   and resets the counter to 0. The wrapper zeroes the counters once when
//   it allocates them; every launch leaves them at 0, so there is no
//   memset before a launch and no host sync (a CUDA graph can hold it).
//   Calls that share a counter buffer must be ordered: the engines issue
//   every decode step on one stream.
// - S = 1 remains for short ranges (the serve shapes, and any range of at
//   most span keys): splitting them would add the combine's round trips
//   and buy nothing, their (batch, head) blocks already cover the SMs. At
//   S > 1 each p is rounded against its split's max instead of the global
//   one (the TPU kernels round against a running max over 256-position or
//   block_size tiles); l sums the unrounded p either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 40;                   // block reductions, a flag
constexpr size_t kMaxSmem = 232448;        // opt-in dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

// error codes below zero are this library's own; >0 are cudaError_t
constexpr int kErrHeadDim = -1;
constexpr int kErrPlan = -2;
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
// per step and the block NGROUPS keys (`_key_group` in the wrapper).
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

// Byte offsets of a split's shared memory for up to `span` keys: K rows
// and V rows (row_bytes each), the int8 scales (k then v), the scores, the
// block reductions, the per-warp sums of acc (or the combine's lanes) and
// (paged) the staged page-table entries. `_smem_bytes` in the wrapper
// mirrors `total`.
struct Smem {
  size_t v, scales, scores, red, acc, table, total;
  __host__ __device__ Smem(int span, int row_bytes, bool quant, int bs,
                           int d) {
    const size_t c = static_cast<size_t>(span);
    v = c * row_bytes;
    scales = 2 * v;
    scores = scales + (quant ? 2 * c * sizeof(float) : 0);
    red = scores + c * sizeof(float);
    acc = red + kRed * sizeof(float);   // 16-byte aligned: span % 4 == 0
    table = acc + static_cast<size_t>(kWarps * d > 4 * kThreads
                                          ? kWarps * d
                                          : 4 * kThreads) *
                      sizeof(float);
    total = table + (bs > 0 ? (c / bs + 2) * sizeof(int) : 0);
  }
};

// Where key/value row j of batch b lives (in units of h*hd elements), where
// its scale lives, and which keys are valid. Flat cache: row b*L + j,
// keys [start_b, cur].
struct FlatRows {
  static constexpr bool kPaged = false;
  const int* attn_start;  // (b,) or nullptr
  int L, H, cur;
  __host__ __device__ int page() const { return 0; }
  __device__ __forceinline__ void stage(int, int, int, int*) {}
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
  // rows j, j + step, j + 2*step, ... of batch b
  struct Walk {
    long long r;
    int step;
    __device__ __forceinline__ long long row() const { return r; }
    __device__ __forceinline__ void next() { r += step; }
  };
  __device__ __forceinline__ Walk walk(int b, int j, int step) const {
    return {row(b, j), step};
  }
};

// Paged pool: position j of slot b is row j % bs of pool block
// page_table[b, j / bs]; keys [start_b, min(lengths[b], mb*bs - 1)] (the
// TPU kernel's grid never reaches a table column >= mb). A split stages
// the table entries of its own pages (from page p0 on) in shared memory.
struct PagedRows {
  static constexpr bool kPaged = true;
  const int* attn_start;  // (b,) or nullptr
  const int* page_table;  // (b, mb)
  const int* lengths;     // (b,), inclusive cursor
  const int* table;       // staged entries, table[i] = page_table[b, p0+i]
  int p0, mb, bs, H;
  __host__ __device__ int page() const { return bs; }
  // the table entries of positions [lo, lo + span) into `s_pt`
  // (published by the caller's next __syncthreads)
  __device__ __forceinline__ void stage(int b, int lo, int span,
                                        int* s_pt) {
    p0 = lo / bs;
    const int end = min(lo + span, mb * bs);
    const int np = (end - 1) / bs - p0 + 1;
    const int* src = page_table + static_cast<long long>(b) * mb + p0;
    for (int i = threadIdx.x; i < np; i += kThreads) s_pt[i] = src[i];
    table = s_pt;
  }
  __device__ __forceinline__ int first(int b) const {
    return attn_start != nullptr ? max(attn_start[b], 0) : 0;
  }
  __device__ __forceinline__ int last(int b) const {
    return min(lengths[b], mb * bs - 1);
  }
  __device__ __forceinline__ long long scale(int, int hh, int j) const {
    return (static_cast<long long>(table[j / bs - p0]) * H + hh) * bs +
           j % bs;
  }
  // rows j, j + step, ...: the page and the row in it advance without a
  // division per row
  struct Walk {
    const int* table;
    int bs, page, off, dpage, doff;
    __device__ __forceinline__ long long row() const {
      return static_cast<long long>(table[page]) * bs + off;
    }
    __device__ __forceinline__ void next() {
      page += dpage;
      off += doff;
      if (off >= bs) {
        off -= bs;
        ++page;
      }
    }
  };
  __device__ __forceinline__ Walk walk(int, int j, int step) const {
    return {table, bs, j / bs - p0, j % bs, step / bs, step % bs};
  }
};

// PTX wrappers (sm_80 instructions, present on sm_90a)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but this thread's last N committed groups have landed
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The last split of a (batch, head) to arrive merges the partials of its
// `active` splits (`acc` (S, D) and `ml` (S, 2) fp32, m and l) into `o`, in
// one pass: each lane group walks every NSL-th split with a running max,
// 16 bytes of acc a lane, then the groups merge in shared memory. Other
// blocks' partials are read through the L2 (__ldcg), which their writers'
// __threadfence reached.
template <typename TQ, int D>
__device__ void combine(const float* acc, const float* ml, int active,
                        TQ* o, float* s_red, float* s_acc) {
  constexpr int V4 = D / 4;            // float4s of a row
  constexpr int NSL = kThreads / V4;   // splits side by side
  const int tid = threadIdx.x, c4 = tid % V4, sl = tid / V4;
  float m = -INFINITY, den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int s = sl; s < active; s += NSL) {
    const float ms = __ldcg(ml + 2 * s), ls = __ldcg(ml + 2 * s + 1);
    const float4 as = __ldcg(reinterpret_cast<const float4*>(
                                 acc + static_cast<long long>(s) * D) + c4);
    const float mn = fmaxf(m, ms);
    const float r = expf(m - mn), w = expf(ms - mn);  // first: r = e^-inf
    num.x = num.x * r + w * as.x;
    num.y = num.y * r + w * as.y;
    num.z = num.z * r + w * as.z;
    num.w = num.w * r + w * as.w;
    den = den * r + w * ls;
    m = mn;
  }
  reinterpret_cast<float4*>(s_acc)[tid] = num;  // s_acc[sl * D + d]
  if (c4 == 0) {
    s_red[sl] = m;                              // -inf for an idle group
    s_red[NSL + sl] = den;
  }
  __syncthreads();
  if (tid < D) {
    float mm = s_red[0];
#pragma unroll
    for (int i = 1; i < NSL; ++i) mm = fmaxf(mm, s_red[i]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int i = 0; i < NSL; ++i) {
      const float w = expf(s_red[i] - mm);
      a += w * s_acc[i * D + tid];
      l += w * s_red[NSL + i];
    }
    o[tid] = from_float<TQ>(l > 0.f ? a / l : 0.f);
  }
}

// One work item: split `split` of (batch b, head hh), its valid keys
// [lo, lo + n), and how many splits of the (batch, head) hold keys.
struct Item {
  int hh, b, split, lo, n, active;
};

// The first item at or after `it` (stride gridDim.x) that holds valid keys.
// A (batch, head)'s valid keys [first, last] go to one split when they fit
// its shared memory (`span` keys), else to splits of `chunk` keys from
// `first` on; every block derives that from the same cursors, so a split
// past them is skipped without a copy. An empty range (start > last)
// writes zeros, rather than 0/0, from its split 0. Block-uniform.
template <typename TQ, int D, typename Rows>
__device__ bool find_item(int& it, int items, int B, int chunk, int span,
                          const Rows& rows, TQ* out, long long hd,
                          Item& item) {
  for (; it < items; it += gridDim.x) {
    const int hh = it % rows.H, b = it / rows.H % B;
    const int split = it / (rows.H * B);
    const int first = rows.first(b), len = rows.last(b) - first + 1;
    if (len <= 0) {
      if (split == 0 && threadIdx.x < D)
        out[b * hd + hh * D + threadIdx.x] = from_float<TQ>(0.f);
      continue;
    }
    const int active = len <= span ? 1 : (len + chunk - 1) / chunk;
    if (split >= active) continue;
    const int lo = first + split * chunk;
    const int n = active == 1 ? len : min(chunk, len - split * chunk);
    item = {hh, b, split, lo, n, active};
    return true;
  }
  return false;
}

// Copies one item's K or V rows (and int8 scales) into shared memory as
// one cp.async group: a thread copies one 16-byte piece of a row.
template <typename TKV, int D, bool QUANT, typename Rows>
__device__ __forceinline__ void issue(const TKV* src, const float* sc,
                                      unsigned char* dst, float* dst_sc,
                                      const Rows& rows, const Item& it,
                                      long long hd) {
  constexpr int ROWB = D * static_cast<int>(sizeof(TKV));
  constexpr int PIECES = ROWB / 16, STEP = kThreads / PIECES;
  const int piece = threadIdx.x % PIECES, key0 = threadIdx.x / PIECES;
  const TKV* base = src + it.hh * D;
  auto w = rows.walk(it.b, it.lo + key0, STEP);
  for (int key = key0; key < it.n; key += STEP, w.next())
    cp_async16(dst + key * ROWB + piece * 16,
               reinterpret_cast<const unsigned char*>(base + w.row() * hd) +
                   piece * 16);
  if constexpr (QUANT)
    for (int i = threadIdx.x; i < it.n; i += kThreads)
      cp_async4(dst_sc + i, sc + rows.scale(it.b, it.hh, it.lo + i));
  cp_async_commit();
}

// A persistent block walks the items (splits of (batch, head) pairs, heads
// fastest) with stride gridDim.x, the K and V buffers in turn: item i+1's
// K rows land during item i's p.v and epilogue, its V rows during its own
// scores.
template <typename TQ, typename TKV, int D, bool QUANT, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, TQ* __restrict__ out,
    float* __restrict__ part, int* __restrict__ count, Rows rows, int B,
    int nsplit, int chunk, int span, float scale) {
  using Lay = Layout<TKV, D>;
  constexpr int VEC = Lay::VEC, G = Lay::G, PER = Lay::PER, KPW = Lay::KPW;
  constexpr int NG = Lay::NGROUPS;
  constexpr int ROWB = D * static_cast<int>(sizeof(TKV));  // a head's row
  // int8 scales folded into the score and probability rows (kernel D)
  constexpr bool FOLD = QUANT && Rows::kPaged;
  // the dtype p is rounded to before p.v (see the header)
  using TP = std::conditional_t<Rows::kPaged && !QUANT, TKV, TQ>;

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(span, ROWB, QUANT, rows.page(), D);
  unsigned char* s_k = smem;
  unsigned char* s_v = smem + sm.v;
  float* s_ks = reinterpret_cast<float*>(smem + sm.scales);  // int8 only
  float* s_vs = s_ks + span;
  float* s_s = reinterpret_cast<float*>(smem + sm.scores);   // span
  float* s_red = reinterpret_cast<float*>(smem + sm.red);    // kRed
  float* s_acc = reinterpret_cast<float*>(smem + sm.acc);
  int* s_pt = reinterpret_cast<int*>(smem + sm.table);       // paged
  int* s_last = reinterpret_cast<int*>(s_red + kRed - 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gk = lane / G;  // which key of the warp's step
  const int gl = lane % G;  // which slice of that key's row
  const long long hd = static_cast<long long>(rows.H) * D;
  const int items = rows.H * B * nsplit;

  int it = blockIdx.x;
  Item cur;
  if (!find_item<TQ, D>(it, items, B, chunk, span, rows, out, hd, cur))
    return;
  rows.stage(cur.b, cur.lo, span, s_pt);
  if constexpr (Rows::kPaged) __syncthreads();  // publishes the table
  issue<TKV, D, QUANT>(k, ks, s_k, s_ks, rows, cur, hd);
  issue<TKV, D, QUANT>(v, vs, s_v, s_vs, rows, cur, hd);
  for (;;) {
    const int n = cur.n;
    float qr[PER][VEC];
    const TQ* qb = q + cur.b * hd + cur.hh * D;
#pragma unroll
    for (int p = 0; p < PER; ++p)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[p][e] =
            round_to<TQ>(to_float<TQ>(qb[(p * G + gl) * VEC + e]) * scale);
    cp_async_wait<1>();  // this item's K rows (its V rows may be in flight)
    __syncthreads();

    // ---- scores: s_i = <qs, k_i> into shared memory, the split's max
    float mloc = -INFINITY;
    for (int base = warp * KPW; base < n; base += NG) {  // warp-uniform
      const int i = base + gk;
      float dot = 0.f;
      if (i < n) {
        const unsigned char* row = s_k + i * ROWB;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          float kf[VEC];
          Unpack<TKV>::run(
              *reinterpret_cast<const uint4*>(row + (p * G + gl) * 16), kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float kv = kf[e];
            if constexpr (QUANT && !FOLD) kv = round_to<TQ>(kv * s_ks[i]);
            dot += qr[p][e] * kv;
          }
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(kFull, dot, o);
      if (i < n) {
        if constexpr (FOLD) dot *= s_ks[i];
        if (gl == 0) s_s[i] = dot;
        mloc = fmaxf(mloc, dot);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(kFull, mloc, o));
    if (lane == 0) s_red[warp] = mloc;
    __syncthreads();  // also: every thread is done with the K buffer
    float m = s_red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_red[w]);

    // ---- the next item's K rows, into the free K buffer
    int nit = it + gridDim.x;
    Item nxt;
    const bool more =
        find_item<TQ, D>(nit, items, B, chunk, span, rows, out, hd, nxt);
    if (more) {
      rows.stage(nxt.b, nxt.lo, span, s_pt);
      if constexpr (Rows::kPaged) __syncthreads();
      issue<TKV, D, QUANT>(k, ks, s_k, s_ks, rows, nxt, hd);
    } else {
      cp_async_commit();  // an empty group keeps the count
    }
    cp_async_wait<1>();  // this item's V rows
    __syncthreads();

    // ---- p.v: l sums the unrounded p; p.v uses round_Tp(p), or for
    // kernel D round_Tq(p * vscale)
    float acc[PER][VEC];
#pragma unroll
    for (int p = 0; p < PER; ++p)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[p][e] = 0.f;
    float lloc = 0.f;
    for (int i = warp * KPW + gk; i < n; i += NG) {
      const float p = expf(s_s[i] - m);
      if (gl == 0) lloc += p;
      float pr;
      if constexpr (FOLD)
        pr = round_to<TQ>(p * s_vs[i]);
      else
        pr = round_to<TP>(p);
      const unsigned char* row = s_v + i * ROWB;
#pragma unroll
      for (int pp = 0; pp < PER; ++pp) {
        float vf[VEC];
        Unpack<TKV>::run(
            *reinterpret_cast<const uint4*>(row + (pp * G + gl) * 16), vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float vv = vf[e];
          if constexpr (QUANT && !FOLD) vv = round_to<TQ>(vv * s_vs[i]);
          acc[pp][e] += pr * vv;
        }
      }
    }
    // the warp's groups, then the warps
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
#pragma unroll
      for (int p = 0; p < PER; ++p)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[p][e] += __shfl_xor_sync(kFull, acc[p][e], o);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lloc += __shfl_xor_sync(kFull, lloc, o);
    if (gk == 0) {
#pragma unroll
      for (int p = 0; p < PER; ++p)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          s_acc[warp * D + (p * G + gl) * VEC + e] = acc[p][e];
    }
    if (lane == 0) s_red[kWarps + warp] = lloc;
    __syncthreads();
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += s_red[kWarps + w];
    float a = 0.f;
    if (tid < D) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += s_acc[w * D + tid];
    }

    // ---- the item's output: one active split writes `out`; several
    // write their partials (`part`: the (B, h, S, D) acc rows, then the
    // (B, h, S, 2) (m, l) pairs) and the last of them to arrive merges
    TQ* ob = out + cur.b * hd + cur.hh * D;
    const int active = cur.active;
    if (active == 1) {
      if (tid < D) ob[tid] = from_float<TQ>(a / l);
      __syncthreads();  // every thread is done with s_red and s_acc
    } else {
      const long long bh = static_cast<long long>(cur.b) * rows.H + cur.hh;
      const long long row = bh * nsplit + cur.split;
      float* ml_part = part + static_cast<long long>(B) * rows.H * nsplit * D;
      if (tid < D) part[row * D + tid] = a;
      if (tid == 0) {
        ml_part[2 * row] = m;
        ml_part[2 * row + 1] = l;
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) *s_last = atomicAdd(count + bh, 1) == active - 1;
      __syncthreads();
      if (*s_last) {  // block-uniform
        __threadfence();
        combine<TQ, D>(part + bh * nsplit * D, ml_part + bh * nsplit * 2,
                       active, ob, s_red, s_acc);
        if (tid == 0) count[bh] = 0;  // all arrived: zero for the next launch
        __syncthreads();
      }
    }
    if (!more) return;
    // ---- the next item's V rows, into the V buffer p.v has released
    issue<TKV, D, QUANT>(v, vs, s_v, s_vs, rows, nxt, hd);
    it = nit;
    cur = nxt;
  }
}

// One call's pointers and launch shape: q/out in TQ, k/v in TKV, the int8
// scales, the (b, h, S, D+2) fp32 partials and the (b*h) int32 arrival
// counters (both unused at S = 1), S splits of `chunk` positions, and the
// keys one split holds in shared memory (`span` >= chunk).
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  void* out;
  float* part;
  int* count;
  int b, nsplit, chunk, span;
  float scale;
  cudaStream_t stream;
};

// One persistent block per resident slot (the runtime's occupancy at this
// shared memory), or one per item when there are fewer items.
template <typename TQ, typename TKV, int D, bool QUANT, typename Rows>
int launch(const Args& a, Rows rows) {
  const Smem sm(a.span, D * static_cast<int>(sizeof(TKV)), QUANT,
                rows.page(), D);
  const long long items = static_cast<long long>(rows.H) * a.b * a.nsplit;
  if (a.chunk <= 0 || a.span < a.chunk || a.span % 4 || a.nsplit <= 0 ||
      items > 0x7fffffffLL || sm.total > kMaxSmem ||
      static_cast<long long>(a.nsplit) * a.chunk > 0x7fffffffLL ||
      (a.nsplit > 1 && (a.part == nullptr || a.count == nullptr)))
    return kErrPlan;
  auto kern = decode_attention_kernel<TQ, TKV, D, QUANT, Rows>;
  cudaError_t e = cudaSuccess;
  if (sm.total > 48 * 1024)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm.total));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, sm.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long slots = static_cast<long long>(sms) * max(per_sm, 1);
  const int grid = static_cast<int>(items < slots ? items : slots);
  kern<<<grid, kThreads, sm.total, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, static_cast<TQ*>(a.out),
      a.part, a.count, rows, a.b, a.nsplit, a.chunk, a.span, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT, typename Rows>
int dispatch_head_dim(int D, const Args& a, Rows rows) {
  switch (D) {
    case 64:
      return launch<TQ, TKV, 64, QUANT, Rows>(a, rows);
    case 128:
      return launch<TQ, TKV, 128, QUANT, Rows>(a, rows);
    case 256:
      return launch<TQ, TKV, 256, QUANT, Rows>(a, rows);
    default:
      return kErrHeadDim;
  }
}

// fp32 q with fp32 or bf16 K/V, or bf16 throughout
template <typename Rows>
int dispatch_float(int q_dtype, int kv_dtype, int d, const Args& a,
                   Rows rows) {
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch_head_dim<float, float, false>(d, a, rows);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, false>(d, a, rows);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return dispatch_head_dim<float, __nv_bfloat16, false>(d, a, rows);
  return kErrDType;
}

// int8 K/V with fp32 or bf16 q
template <typename Rows>
int dispatch_int8(int q_dtype, int d, const Args& a, Rows rows) {
  if (q_dtype == kF32)
    return dispatch_head_dim<float, int8_t, true>(d, a, rows);
  if (q_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, int8_t, true>(d, a, rows);
  return kErrDType;
}

}  // namespace

extern "C" {

// Every entry: `part` is the (b, h, nsplit, d+2) fp32 scratch and `count`
// the (b*h) int32 arrival counters, all zero, that the launch leaves zero
// (both may be NULL when nsplit = 1); a (batch, head)'s valid keys go to
// one split if they are at most `span`, else to splits of `chunk` keys
// from its first valid key on (nsplit * chunk covers the range's most).
// Returns 0, a cudaError_t, or a negative code above.

// Kernel A. q/out (b, 1, h*d) in q_dtype; k/v (b, L, h*d) in kv_dtype;
// attn_start (b,) int32 or NULL.
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     const int* attn_start, float* part, int* count, int b,
                     int L, int h, int d, int cur, int nsplit, int chunk,
                     int span, float scale, int q_dtype, int kv_dtype,
                     void* stream) {
  const FlatRows rows{attn_start, L, h, cur};
  const Args a{q,     k,      v,     nullptr, nullptr, out, part,
               count, b,      nsplit, chunk, span, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch_float(q_dtype, kv_dtype, d, a, rows);
}

// Kernel B. As kernel A over an int8 cache; k_scale/v_scale (b, h, L) fp32.
int decode_attention_int8(const void* q, const void* k, const void* v,
                          const float* k_scale, const float* v_scale,
                          void* out, const int* attn_start, float* part,
                          int* count, int b, int L, int h, int d, int cur,
                          int nsplit, int chunk, int span, float scale,
                          int q_dtype, void* stream) {
  const FlatRows rows{attn_start, L, h, cur};
  const Args a{q,     k,      v,     k_scale, v_scale, out, part,
               count, b,      nsplit, chunk, span, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch_int8(q_dtype, d, a, rows);
}

// Kernel C. q/out (b, 1, h*d) in q_dtype; k/v pools (nb, bs, h*d) in
// kv_dtype; page_table (b, mb), lengths (b,) and attn_start (b,) int32 on
// the device (attn_start may be NULL). Every table entry a valid range
// reaches must be a block of the pool: the wrapper cannot check device
// data without a host sync, and the engine guarantees it.
int paged_decode_attention(const void* q, const void* k, const void* v,
                           void* out, const int* page_table,
                           const int* lengths, const int* attn_start,
                           float* part, int* count, int b, int bs, int mb,
                           int h, int d, int nsplit, int chunk, int span,
                           float scale, int q_dtype, int kv_dtype,
                           void* stream) {
  const PagedRows rows{attn_start, page_table, lengths, nullptr, 0, mb, bs,
                       h};
  const Args a{q,     k,      v,     nullptr, nullptr, out, part,
               count, b,      nsplit, chunk, span, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch_float(q_dtype, kv_dtype, d, a, rows);
}

// Kernel D. As kernel C over an int8 pool; k_scale/v_scale are the
// (nb, h, bs) fp32 scale pages.
int paged_decode_attention_int8(const void* q, const void* k, const void* v,
                                const float* k_scale, const float* v_scale,
                                void* out, const int* page_table,
                                const int* lengths, const int* attn_start,
                                float* part, int* count, int b, int bs,
                                int mb, int h, int d, int nsplit, int chunk,
                                int span, float scale, int q_dtype,
                                void* stream) {
  const PagedRows rows{attn_start, page_table, lengths, nullptr, 0, mb, bs,
                       h};
  const Args a{q,     k,      v,     k_scale, v_scale, out, part,
               count, b,      nsplit, chunk, span, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch_int8(q_dtype, d, a, rows);
}

}  // extern "C"
