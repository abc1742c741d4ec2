// Ragged grouped matmul over expert-sorted rows for sm_90a, built with nvcc
// into a shared library with a plain C interface
// (ddp_practice_tpu_torch/ops/cuda_build.py) and launched through ctypes by
// ddp_practice_tpu_torch/ops/grouped_matmul.py.
//
// Replaces the Pallas TPU kernels that ddp_practice_tpu/ops/moe.py reaches
// through `_mb_gmm` and `_grouped_matmul` (megablox `gmm` and `tgmm`):
//   kernel J (gmm_kernel): out = the rows of group e times rhs[e], with rhs
//     read as (k, n) (the forward) or as (n, k) transposed (the input
//     grad, dlhs = gmm(g, rhs, transpose_rhs=True));
//   kernel K (tgmm_kernel): out[e] = lhs_e^T . g_e, the per-group weight
//     grad.
// group_sizes (E,) int32 splits the m rows into E consecutive groups.
// Every product accumulates in fp32 and rounds once to the output dtype.
//
// Bound: at the lm_moe shapes (m = 32768 sorted rows, (k, n) = (768, 3072)
// and (3072, 768), bf16) each call does 2*m*k*n = 154.6 GFLOP, 0.156 ms at
// the tensor cores' 989.4 TFLOP/s, against ~0.25 GB of operands (0.075 ms
// at 3.35 TB/s): operations bound it. fp32 runs outside the tensor cores
// (67 TFLOP/s), for the tests and cross-checks.
//
// Design (a simple first kernel):
//   - The schedule is built on the device from group_sizes; the host reads
//     nothing back. J's grid has m_tiles + E rows of blocks: grid row v is
//     the v-th (row tile, group) visit in group order (a tile that
//     straddles a group boundary is visited once per group, its rows
//     masked to that group, as megablox's group_offsets / m_tile_ids
//     metadata; one more visit writes rows past sum(group_sizes) as
//     zeros). Thread 0 finds its visit by walking the E group sizes; blocks
//     past the last visit exit at once. ops/grouped_matmul.py gmm_schedule
//     is the same walk in Python.
//   - K runs one block per (group, k tile, n tile) and reduces over the
//     group's rows in row order: no atomics, the same bits every run; an
//     empty group writes zeros.
//   - A block of 256 threads computes a 128 x 128 output tile (fp32: 64 x
//     64), staging 32-deep (fp32: 16) slices of both operands in shared
//     memory in their global layout (16-byte loads when the rows allow;
//     rows and columns outside the operand read as zero). The next slice
//     is fetched into registers while the current one is multiplied.
//     bf16: eight warps, each a 64 x 32 patch of WMMA mma.sync 16x16x16
//     fragments with fp32 accumulation; a transposed operand is read with
//     a col_major fragment. fp32: FMAs, 4 x 4 outputs a thread. No
//     cp.async, wgmma or TMA yet.
//   - J is held to 128 registers a thread (__launch_bounds__(256, 2)) so
//     that two blocks share an SM: at the 167 it takes unbounded, one
//     block ran alone and J was the slower for it (PERF.md). K fits 128
//     registers as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
// error codes below zero are this library's own; >0 are cudaError_t
constexpr int kErrShape = -2;
constexpr int kErrDType = -3;

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int BM = 128, BN = 128, BK = 32, PAD = 8, VEC = 8;
};
template <> struct Cfg<float> {
  static constexpr int BM = 64, BN = 64, BK = 16, PAD = 4, VEC = 4;
};

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements that move as one load or store (16 bytes when VEC > 1)
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A (R, C) window of a row-major global matrix (row stride ld) on its way
// to shared memory: fetch() reads rows [row0, row0 + R) and columns
// [col0, col0 + C) into registers, a row outside [row_lo, row_hi) or a
// column past col_hi as zero (col_hi is a multiple of VEC); commit()
// stores them at row stride lds.
template <typename T, int R, int C, int VEC> struct TileLoader {
  static constexpr int CV = C / VEC;
  static constexpr int PER = R * CV / kThreads;
  static_assert(C % VEC == 0 && (R * CV) % kThreads == 0, "tile split");
  Pack<T, VEC> reg[PER];

  __device__ __forceinline__ void fetch(const T* src, long long ld,
                                        long long row0, long long row_lo,
                                        long long row_hi, long long col0,
                                        long long col_hi) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const long long gr = row0 + e / CV;
      const long long gc = col0 + (e % CV) * VEC;
      if (gr >= row_lo && gr < row_hi && gc < col_hi) {
        reg[i] = *reinterpret_cast<const Pack<T, VEC>*>(src + gr * ld + gc);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) reg[i].v[j] = from_float<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void commit(T* dst, int lds) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * kThreads;
      *reinterpret_cast<Pack<T, VEC>*>(dst + (e / CV) * lds +
                                       (e % CV) * VEC) = reg[i];
    }
  }
};

// Shared-memory layout of one operand slice. A is (BM rows, BK deep), B
// (BK deep, BN cols); a "col" operand is staged transposed, in the layout
// its global rows have: A_COL as (BK, BM), B_COL as (BN, BK).
template <typename T, bool A_COL, bool B_COL> struct Smem {
  using C = Cfg<T>;
  static constexpr int LDA = A_COL ? C::BM + C::PAD : C::BK + C::PAD;
  static constexpr int LDB = B_COL ? C::BK + C::PAD : C::BN + C::PAD;
  static constexpr int A_ELEMS = (A_COL ? C::BK : C::BM) * LDA;
  static constexpr int B_ELEMS = (B_COL ? C::BN : C::BK) * LDB;
};

// Element (i, kk) of the staged A slice and (kk, j) of the staged B slice.
template <typename T, bool A_COL, bool B_COL>
__device__ __forceinline__ float a_at(const T* s, int i, int kk) {
  using S = Smem<T, A_COL, B_COL>;
  return to_float<T>(A_COL ? s[kk * S::LDA + i] : s[i * S::LDA + kk]);
}
template <typename T, bool A_COL, bool B_COL>
__device__ __forceinline__ float b_at(const T* s, int kk, int j) {
  using S = Smem<T, A_COL, B_COL>;
  return to_float<T>(B_COL ? s[j * S::LDB + kk] : s[kk * S::LDB + j]);
}

// The product every block computes: out rows [m0, m0 + BM) x cols
// [n0, n0 + BN) = sum over the reduction index r in [r_lo, r_hi) of
// A(i, r) B(r, j), where
//   A(i, r) = A_COL ? a[r * lda + i] : a[i * lda + r]   (i < a_rows)
//   B(r, j) = B_COL ? b[j * ldb + r] : b[r * ldb + j]   (j < n_cols)
// stored in rows [store_lo, store_hi) and cols below n_cols of out (row
// stride ldo). A reduction index outside [r_lo, r_hi) reads as zero, so a
// group's rows never mix with its neighbours'.
template <typename T, bool A_COL, bool B_COL, int VEC>
__device__ __forceinline__ void block_product(
    const T* a, long long lda, long long a_rows, const T* b, long long ldb,
    long long n_cols, long long r_lo, long long r_hi, long long m0,
    long long n0, T* out, long long ldo, long long store_lo,
    long long store_hi) {
  using C = Cfg<T>;
  using S = Smem<T, A_COL, B_COL>;
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK;
  __shared__ __align__(32) T sA[S::A_ELEMS];
  __shared__ __align__(32) T sB[S::B_ELEMS];
  TileLoader<T, A_COL ? BK : BM, A_COL ? BM : BK, VEC> la;
  TileLoader<T, B_COL ? BN : BK, B_COL ? BK : BN, VEC> lb;

  auto fetch = [&](long long r) {
    if (A_COL) la.fetch(a, lda, r, r_lo, r_hi, m0, a_rows);
    else la.fetch(a, lda, m0, 0, a_rows, r, r_hi);
    if (B_COL) lb.fetch(b, ldb, n0, 0, n_cols, r, r_hi);
    else lb.fetch(b, ldb, r, r_lo, r_hi, n0, n_cols);
  };

  if constexpr (std::is_same<T, bf16>::value) {
    using LayA = typename std::conditional<A_COL, wmma::col_major,
                                           wmma::row_major>::type;
    using LayB = typename std::conditional<B_COL, wmma::col_major,
                                           wmma::row_major>::type;
    using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA>;
    using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB>;
    using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
    __shared__ __align__(32) float sC[kThreads / 32][16 * 16];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4;  // a 64 x 32 patch per warp
    FragC acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    if (r_lo < r_hi) fetch(r_lo);
    for (long long r = r_lo; r < r_hi; r += BK) {
      __syncthreads();  // the previous slice is no longer read
      la.commit(sA, S::LDA);
      lb.commit(sB, S::LDB);
      __syncthreads();
      if (r + BK < r_hi) fetch(r + BK);  // in flight while we multiply
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA fa[4];
        FragB fb[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wm * 64 + i * 16;
          wmma::load_matrix_sync(
              fa[i], A_COL ? sA + kk * S::LDA + row : sA + row * S::LDA + kk,
              S::LDA);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wn * 32 + j * 16;
          wmma::load_matrix_sync(
              fb[j], B_COL ? sB + col * S::LDB + kk : sB + kk * S::LDB + col,
              S::LDB);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }

    // epilogue: each fragment through the warp's 16 x 16 scratch; a lane
    // writes 8 consecutive columns of one row
    float* scratch = sC[warp];
    const int rr = lane / 2, cc = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const long long gr = m0 + wm * 64 + i * 16 + rr;
        const long long gc = n0 + wn * 32 + j * 16 + cc;
        if (gr >= store_lo && gr < store_hi) {
          T* dst = out + gr * ldo + gc;
          if (VEC > 1 && gc + 8 <= n_cols) {
            Pack<T, 8> p;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              p.v[c] = from_float<T>(scratch[rr * 16 + cc + c]);
            *reinterpret_cast<Pack<T, 8>*>(dst) = p;
          } else {
            for (int c = 0; c < 8 && gc + c < n_cols; ++c)
              dst[c] = from_float<T>(scratch[rr * 16 + cc + c]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    // fp32: thread (ty, tx) owns rows ty + 16 i and cols tx + 16 j
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[4][4] = {};
    if (r_lo < r_hi) fetch(r_lo);
    for (long long r = r_lo; r < r_hi; r += BK) {
      __syncthreads();
      la.commit(sA, S::LDA);
      lb.commit(sB, S::LDB);
      __syncthreads();
      if (r + BK < r_hi) fetch(r + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = a_at<T, A_COL, B_COL>(sA, ty + 16 * i, kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = b_at<T, A_COL, B_COL>(sB, kk, tx + 16 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gr = m0 + ty + 16 * i;
      if (gr < store_lo || gr >= store_hi) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long gc = n0 + tx + 16 * j;
        if (gc < n_cols) out[gr * ldo + gc] = from_float<T>(acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------- kernel J
// lhs (m, kred); rhs (E, kred, nout), or (E, nout, kred) when TRANS; out
// (m, nout). Grid (m_tiles + E, n_tiles).
template <typename T, bool TRANS, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_kernel(const T* lhs, const T* rhs, const int* group_sizes, T* out,
               int m, int kred, int nout, int num_groups) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  __shared__ long long visit[4];  // group, tile, row_lo, row_hi
  if (threadIdx.x == 0) {
    // the v-th (tile, group) visit in group order; group E is the tail of
    // rows past sum(group_sizes), written zero
    const long long v = blockIdx.x;
    long long off = 0, seen = 0;
    visit[0] = -1;
    for (int g = 0; g <= num_groups; ++g) {
      long long size = g < num_groups ? group_sizes[g] : m - off;
      if (size < 0) size = 0;
      if (size > 0 && off < m) {
        const long long hi = off + size < m ? off + size : m;
        const long long first = off / BM, count = (hi - 1) / BM - first + 1;
        if (v < seen + count) {
          const long long t = first + (v - seen);
          visit[0] = g;
          visit[1] = t;
          visit[2] = t * BM > off ? t * BM : off;
          visit[3] = t * BM + BM < hi ? t * BM + BM : hi;
          break;
        }
        seen += count;
      }
      off += size;
    }
  }
  __syncthreads();
  const long long g = visit[0];
  if (g < 0) return;  // past the last visit
  const long long t = visit[1], lo = visit[2], hi = visit[3];
  const long long n0 = (long long)blockIdx.y * BN;
  if (g == num_groups) {  // the tail
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const long long r = t * BM + e / BN, c = n0 + e % BN;
      if (r >= lo && r < hi && c < nout)
        out[r * nout + c] = from_float<T>(0.f);
    }
    return;
  }
  const T* w = rhs + g * (long long)kred * nout;
  block_product<T, false, TRANS, VEC>(
      lhs, kred, m, w, TRANS ? kred : nout, nout, 0, kred, t * BM, n0, out,
      nout, lo, hi);
}

// ------------------------------------------------------------- kernel K
// lhs (m, kd), g (m, n) -> out (E, kd, n). Grid (n_tiles, k_tiles, E).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    tgmm_kernel(const T* lhs, const T* grad, const int* group_sizes, T* out,
                int m, int kd, int n) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  const int e = blockIdx.z;
  long long off = 0;
  for (int g = 0; g < e; ++g) off += group_sizes[g] > 0 ? group_sizes[g] : 0;
  long long size = group_sizes[e] > 0 ? group_sizes[e] : 0;
  const long long lo = off < m ? off : m;
  const long long hi = off + size < m ? off + size : m;
  // out[e] (kd, n) = sum over rows r of lhs[r, i] g[r, j]: A is lhs read
  // transposed, B is g; an empty group's reduction is empty (zeros)
  block_product<T, true, false, VEC>(
      lhs, kd, kd, grad, n, n, lo, hi, (long long)blockIdx.y * BM,
      (long long)blockIdx.x * BN, out + e * (long long)kd * n, n, 0, kd);
}

template <typename T, bool TRANS, int VEC>
int launch_gmm(const void* lhs, const void* rhs, const int* gs, void* out,
               int m, int kred, int nout, int num_groups,
               cudaStream_t stream) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  const dim3 grid((m + BM - 1) / BM + num_groups, (nout + BN - 1) / BN);
  gmm_kernel<T, TRANS, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), gs,
      static_cast<T*>(out), m, kred, nout, num_groups);
  return cudaGetLastError();
}

template <typename T, int VEC>
int launch_tgmm(const void* lhs, const void* grad, const int* gs, void* out,
                int m, int kd, int n, int num_groups, cudaStream_t stream) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  const dim3 grid((n + BN - 1) / BN, (kd + BM - 1) / BM, num_groups);
  tgmm_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(grad), gs,
      static_cast<T*>(out), m, kd, n);
  return cudaGetLastError();
}

template <typename T>
int gmm_dispatch(const void* lhs, const void* rhs, const int* gs, void* out,
                 int m, int kred, int nout, int num_groups, int trans,
                 int vec, cudaStream_t stream) {
  constexpr int V = Cfg<T>::VEC;
  if (trans)
    return vec ? launch_gmm<T, true, V>(lhs, rhs, gs, out, m, kred, nout,
                                        num_groups, stream)
               : launch_gmm<T, true, 1>(lhs, rhs, gs, out, m, kred, nout,
                                        num_groups, stream);
  return vec ? launch_gmm<T, false, V>(lhs, rhs, gs, out, m, kred, nout,
                                       num_groups, stream)
             : launch_gmm<T, false, 1>(lhs, rhs, gs, out, m, kred, nout,
                                       num_groups, stream);
}

}  // namespace

// Kernel J. lhs (m, kred); rhs (E, kred, nout), or (E, nout, kred) with
// transpose_rhs; group_sizes (E,) int32 on the device; out (m, nout). All
// contiguous, one dtype (0 fp32, 1 bf16). vec = 1 when every operand is
// 16-byte aligned with rows a multiple of 16 bytes (16-byte loads).
extern "C" int grouped_matmul_gmm(const void* lhs, const void* rhs,
                                  const int* group_sizes, void* out, int m,
                                  int kred, int nout, int num_groups,
                                  int transpose_rhs, int vec, int dtype,
                                  void* stream) {
  if (m < 0 || kred < 0 || nout < 0 || num_groups < 1) return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return gmm_dispatch<bf16>(lhs, rhs, group_sizes, out, m, kred, nout,
                              num_groups, transpose_rhs, vec, s);
  if (dtype == kF32)
    return gmm_dispatch<float>(lhs, rhs, group_sizes, out, m, kred, nout,
                               num_groups, transpose_rhs, vec, s);
  return kErrDType;
}

// Kernel K. lhs (m, kd), grad (m, n), group_sizes (E,) int32 on the
// device; out (E, kd, n). Same conventions as kernel J.
extern "C" int grouped_matmul_tgmm(const void* lhs, const void* grad,
                                   const int* group_sizes, void* out, int m,
                                   int kd, int n, int num_groups, int vec,
                                   int dtype, void* stream) {
  if (m < 0 || kd < 0 || n < 0 || num_groups < 1 || num_groups > 65535)
    return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return vec ? launch_tgmm<bf16, 8>(lhs, grad, group_sizes, out, m, kd, n,
                                      num_groups, s)
               : launch_tgmm<bf16, 1>(lhs, grad, group_sizes, out, m, kd, n,
                                      num_groups, s);
  if (dtype == kF32)
    return vec ? launch_tgmm<float, 4>(lhs, grad, group_sizes, out, m, kd, n,
                                       num_groups, s)
               : launch_tgmm<float, 1>(lhs, grad, group_sizes, out, m, kd, n,
                                       num_groups, s);
  return kErrDType;
}
