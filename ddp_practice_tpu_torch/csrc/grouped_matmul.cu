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
//   - K cuts each group's rows into chunks (work units); a group of one
//     unit writes its tiles directly, a group of several writes fp32
//     partials that a second pass sums in unit order: no atomics, the same
//     bits every run; an empty group writes zeros. bf16 K runs on Hopper's
//     wgmma from a TMA ring (below, "kernel K, bf16 (Hopper)").
//   - The ring-less kernel (J's fp32 and unaligned bf16 operands, K's too):
//     a block of 256 threads computes a 128 x 128 output tile (fp32: 64 x
//     64), staging 32-deep (fp32: 16) slices of both operands in shared
//     memory in their global layout (16-byte loads when the rows allow;
//     rows and columns outside the operand read as zero). The next slice
//     is fetched into registers while the current one is multiplied.
//     bf16: eight warps, each a 64 x 32 patch of WMMA mma.sync 16x16x16
//     fragments with fp32 accumulation; a transposed operand is read with
//     a col_major fragment. fp32: FMAs, 4 x 4 outputs a thread. No
//     cp.async, wgmma or TMA yet.
//   - The ring-less J is held to 128 registers a thread
//     (__launch_bounds__(256, 2)) so that two blocks share an SM: at the
//     167 it takes unbounded, one block ran alone and J was the slower for
//     it (PERF.md). The ring-less K fits 128 registers as it is.

#include <cuda.h>   // CUtensorMap and the driver's enums (no -lcuda)
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
template <typename T, bool A_COL, bool B_COL, int VEC, typename TO = T>
__device__ __forceinline__ void block_product(
    const T* a, long long lda, long long a_rows, const T* b, long long ldb,
    long long n_cols, long long r_lo, long long r_hi, long long m0,
    long long n0, TO* out, long long ldo, long long store_lo,
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
          TO* dst = out + gr * ldo + gc;
          if (VEC > 1 && std::is_same<TO, T>::value && gc + 8 <= n_cols) {
            Pack<TO, 8> p;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              p.v[c] = from_float<TO>(scratch[rr * 16 + cc + c]);
            *reinterpret_cast<Pack<TO, 8>*>(dst) = p;
          } else {
            for (int c = 0; c < 8 && gc + c < n_cols; ++c)
              dst[c] = from_float<TO>(scratch[rr * 16 + cc + c]);
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
        if (gc < n_cols) out[gr * ldo + gc] = from_float<TO>(acc[i][j]);
      }
    }
  }
}

// The v-th (row tile, group) visit in group order, as (group, tile,
// row_lo, row_hi) into `visit`: the rows [row_lo, row_hi) of row tile
// `tile` (BM rows) that belong to `group`. Group E is the tail of rows past
// sum(group_sizes), written zero; group -1 means past the last visit.
// ops/grouped_matmul.py gmm_schedule is the same walk.
__device__ void find_visit(long long* visit, const int* group_sizes, int m,
                           int num_groups, int bm, long long v) {
  long long off = 0, seen = 0;
  visit[0] = -1;
  for (int g = 0; g <= num_groups; ++g) {
    long long size = g < num_groups ? group_sizes[g] : m - off;
    if (size < 0) size = 0;
    if (size > 0 && off < m) {
      const long long hi = off + size < m ? off + size : m;
      const long long first = off / bm, count = (hi - 1) / bm - first + 1;
      if (v < seen + count) {
        const long long t = first + (v - seen);
        visit[0] = g;
        visit[1] = t;
        visit[2] = t * bm > off ? t * bm : off;
        visit[3] = t * bm + bm < hi ? t * bm + bm : hi;
        return;
      }
      seen += count;
    }
    off += size;
  }
}

// ------------------------------------------------------------- kernel J
// The ring-less kernel: fp32 operands, and bf16 operands that the tensor
// memory accelerator cannot address (a base or a row that is not 16-byte
// aligned, or an empty reduction). lhs (m, kred); rhs (E, kred, nout), or
// (E, nout, kred) when TRANS; out (m, nout). Grid (m_tiles + E, n_tiles).
template <typename T, bool TRANS, int VEC, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_kernel(const T* lhs, const T* rhs, const int* group_sizes, TO* out,
               int m, int kred, int nout, int num_groups) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  __shared__ long long visit[4];  // group, tile, row_lo, row_hi
  if (threadIdx.x == 0)
    find_visit(visit, group_sizes, m, num_groups, BM, blockIdx.x);
  __syncthreads();
  const long long g = visit[0];
  if (g < 0) return;  // past the last visit
  const long long t = visit[1], lo = visit[2], hi = visit[3];
  const long long n0 = (long long)blockIdx.y * BN;
  if (g == num_groups) {  // the tail
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const long long r = t * BM + e / BN, c = n0 + e % BN;
      if (r >= lo && r < hi && c < nout)
        out[r * nout + c] = from_float<TO>(0.f);
    }
    return;
  }
  const T* w = rhs + g * (long long)kred * nout;
  block_product<T, false, TRANS, VEC, TO>(
      lhs, kred, m, w, TRANS ? kred : nout, nout, 0, kred, t * BM, n0, out,
      nout, lo, hi);
}

// ------------------------------------------------- kernel J, bf16 (Hopper)
// Replaces megablox `gmm` as ddp_practice_tpu/ops/moe.py reaches it
// through `_mb_gmm` (the forward, and transpose_rhs=True for the input
// grad), for bf16 operands that are 16-byte aligned.
// Bound: operations. 2*m*k*n = 154.6 GFLOP at the lm_moe shapes (m = 32768
// sorted rows, (k, n) = (768, 3072) or (3072, 768)), 0.156 ms at the tensor
// cores' 989.4 TFLOP/s; its ~0.25 GB of operands and result take 0.075 ms
// at 3.35 TB/s.
// Design:
//   - A block of three warpgroups owns a BM x BN = 128 x BN output tile of
//     one (row tile, group) visit, found on the device as above (a tile
//     that straddles groups multiplies all its rows and stores only its
//     group's). The blocks run column tile fastest, so the column tiles of
//     a row tile run side by side and read its lhs slices from L2: lhs
//     (50-200 MB at the lm_moe shapes, beyond the 50 MB L2) leaves device
//     memory about once instead of once per column tile (on an H100,
//     experiments/gmm_tune.py: 0.321 -> 0.275 ms at w_in).
//   - Warpgroup 0 is the producer: one thread keeps the tensor memory
//     accelerator (TMA) filling a ring of STAGES shared-memory stages,
//     each a 128 x 64 slice of lhs and a 64 x BN slice of rhs[e], and
//     signals a "full" mbarrier per stage with the bytes that landed.
//     Warpgroups 1 and 2 consume: each runs wgmma m64nBNk16 (bf16 from
//     shared memory through descriptors, fp32 accumulators in registers)
//     on its 64 rows, keeps one wgmma group in flight, and releases a
//     stage on its "empty" mbarrier once the products that read it are
//     done. setmaxnreg moves registers from the producer (40) to the
//     consumers (232): BN/2 accumulators a thread.
//   - TMA writes every slice with the 128-byte swizzle that the wgmma
//     descriptors name, so the products read shared memory without bank
//     conflicts. lhs is the K-major A operand (rows of 64 bf16 = 128
//     bytes, 8-row groups 1024 bytes apart). rhs[e] in the forward's
//     (k, n) layout is the MN-major B operand (transpose bit set): BN/64
//     boxes of 64 n-columns x 64 k-rows, 8 KiB apart (the descriptor's
//     leading offset), 8-row k groups 1024 bytes apart (its stride
//     offset). The transposed (n, k) rhs is K-major like lhs. Neither
//     layout is copied or transposed outside the kernel. The tensor maps
//     are built on the host per launch (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint, so nothing links -lcuda) and passed
//     as __grid_constant__ parameters; rows and columns outside an operand
//     (past m or k, past the group's k rows of rhs) arrive as zeros.
//   - Epilogue: the accumulators go to shared memory as the output type
//     (bf16, or fp32 for the reference's preferred_element_type=float32),
//     in rows padded so the fragment stores hit distinct banks; then each
//     consumer warpgroup writes its 64 rows as 16-byte chunks, only rows in
//     [row_lo, row_hi) and columns below n. Every sum has one owner and a
//     fixed order (no atomic operations): the same bits on every run. The
//     tail visit writes zeros.
//   - Registers, spills and shared memory per instantiation: PERF.md (from
//     the card's `-Xptxas -v`; chip_smoke.py prints them beside the
//     blocks an SM the occupancy calculator gives).
constexpr int kErrTensorMap = -4;

template <int BN_> struct WgTile {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int THREADS = 384;   // producer + two consumer groups
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  // the ring, 2 x STAGES mbarriers and the visit; 1 KiB for alignment
  static constexpr int SMEM = RING + 16 * STAGES + 32 + 1024;
  static constexpr int LDO = BN + 8;    // padded epilogue row (elements)
  static_assert(2 * 64 * LDO * 4 <= RING, "the epilogue fits the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// one box of a 2-d / 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// A wgmma shared-memory descriptor with the 128-byte swizzle: the start
// address, the leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lead,
                                            uint32_t stride) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lead >> 4) & 0x3FFF) << 16) |
         (uint64_t((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the accumulators across a wait
template <int N>
__device__ __forceinline__ void wg_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(i) WG_F8(i), WG_F8(i + 8), WG_F8(i + 16), WG_F8(i + 24)

// d (64 x N fp32, this warpgroup's accumulators) += A . B over k16, A and
// B read from shared memory through their descriptors; TA: A is MN-major,
// TB: B is MN-major
template <int N, int TA, int TB> struct Wgmma;
template <int TA, int TB> struct Wgmma<128, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : WG_F32(0), WG_F32(32)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<192, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, %99, %100;\n}\n"
        : WG_F32(0), WG_F32(32), WG_F32(64)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<256, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : WG_F32(0), WG_F32(32), WG_F32(64), WG_F32(96)
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
#undef WG_F32
#undef WG_F8

// this warpgroup's fragment pair (row, col), (row, col + 1) into a padded
// staging row of the output type
__device__ __forceinline__ void stage_pair(bf16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void stage_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

// lhs_map: lhs (m, kred), boxes of 64 x 128 (k, rows); rhs_map: rhs as
// (E, kred, nout), boxes of 64 x 64 (n, k), or with TRANS as (E, nout,
// kred), boxes of 64 x BN (k, n). out (m, nout), fp32 with F32OUT, else
// bf16. Grid (m_tiles + E) x n_tiles blocks in one dimension, THREADS.
template <int BN, bool TRANS, bool F32OUT>
__global__ void __launch_bounds__(WgTile<BN>::THREADS, 1)
    gmm_kernel(const __grid_constant__ CUtensorMap lhs_map,
               const __grid_constant__ CUtensorMap rhs_map,
               const int* group_sizes, void* out_ptr, int m, int kred,
               int nout, int num_groups) {
  using W = WgTile<BN>;
  using TO = typename std::conditional<F32OUT, float, bf16>::type;
  TO* out = static_cast<TO*>(out_ptr);
  constexpr int BM = W::BM, BK = W::BK, S = W::STAGES;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + W::RING);
  uint64_t* empty = full + S;
  long long* visit = reinterpret_cast<long long*>(empty + S);
  const int tid = threadIdx.x;
  // block b is column tile b % n_tiles of visit b / n_tiles: the column
  // tiles of one row tile run side by side and share its lhs slices in L2
  const int n_tiles = (nout + BN - 1) / BN;
  if (tid == 0) {
    find_visit(visit, group_sizes, m, num_groups, BM, blockIdx.x / n_tiles);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long g = visit[0];
  if (g < 0) return;  // past the last visit
  const long long t = visit[1], lo = visit[2], hi = visit[3];
  const int n0 = (blockIdx.x % n_tiles) * BN;
  constexpr int CV = 16 / int(sizeof(TO));   // elements a 16-byte chunk
  if (g == num_groups) {  // the tail: zeros in 16-byte chunks
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int e = tid; e < BM * (BN / CV); e += W::THREADS) {
      const long long r = t * BM + e / (BN / CV);
      const int c = n0 + (e % (BN / CV)) * CV;
      if (r >= lo && r < hi && c < nout)
        *reinterpret_cast<uint4*>(out + r * nout + c) = zero;
    }
    return;
  }
  const int n_k = (kred + BK - 1) / BK;
  const int wg = tid / 128;
  if (wg == 0) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % S;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        uint8_t* sa = base + s * W::STAGE_BYTES;
        uint8_t* sb = sa + W::A_BYTES;
        tma_2d(sa, &lhs_map, &full[s], kt * BK, int(t * BM));
        if (TRANS) {
          tma_3d(sb, &rhs_map, &full[s], kt * BK, n0, int(g));
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_3d(sb + c * 64 * BK * 2, &rhs_map, &full[s], n0 + 64 * c,
                   kt * BK, int(g));
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;                 // rows 64 cw of the tile
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  wg_fence_acc(acc);
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const uint8_t* sa = base + s * W::STAGE_BYTES + cw * 64 * BK * 2;
    const uint8_t* sb = base + s * W::STAGE_BYTES + W::A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = wg_desc(sa + kk * 32, 16, 1024);
      const uint64_t db = TRANS ? wg_desc(sb + kk * 32, 16, 1024)
                                : wg_desc(sb + kk * 16 * 128, 64 * BK * 2,
                                          1024);
      Wgmma<BN, 0, TRANS ? 0 : 1>::run(acc, da, db);
    }
    wg_commit();
    wg_wait<1>();   // the products of stage kt - 1 are done
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wg_wait<0>();
  wg_fence_acc(acc);

  // epilogue: both consumer groups are done with the ring, which stages
  // the output (rows padded to LDO elements)
  named_sync(1, 256);
  TO* st = reinterpret_cast<TO*>(base) + cw * 64 * W::LDO;
  const int gq = lane >> 2, tq = lane & 3, r0 = warp * 16 + gq;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    stage_pair(st + r0 * W::LDO + c, acc[4 * j], acc[4 * j + 1]);
    stage_pair(st + (r0 + 8) * W::LDO + c, acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_sync(2 + cw, 128);
  constexpr int CPR = BN / CV;             // 16-byte chunks a row
  const long long row0 = t * BM + cw * 64;
  for (int e = tid & 127; e < 64 * CPR; e += 128) {
    const int r = e / CPR, c = (e % CPR) * CV;
    const long long gr = row0 + r;
    if (gr >= lo && gr < hi && n0 + c < nout)
      *reinterpret_cast<uint4*>(out + gr * nout + n0 + c) =
          *reinterpret_cast<const uint4*>(st + r * W::LDO + c);
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime already loaded
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; byte strides of the
// outer ones) read in boxes of `box`, 128-byte swizzled, zeros outside.
int tensor_map(CUtensorMap* map, const void* base, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrTensorMap;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int BN, bool TRANS, bool F32OUT>
int launch_gmm_wg(const void* lhs, const void* rhs, const int* gs,
                  void* out, int m, int kred, int nout, int num_groups,
                  cudaStream_t stream) {
  using W = WgTile<BN>;
  CUtensorMap lhs_map, rhs_map;
  const cuuint64_t a_dims[2] = {cuuint64_t(kred), cuuint64_t(m)};
  const cuuint64_t a_str[1] = {cuuint64_t(kred) * 2};
  const cuuint32_t a_box[2] = {W::BK, W::BM};
  if (const int rc = tensor_map(&lhs_map, lhs, 2, a_dims, a_str, a_box))
    return rc;
  const cuuint64_t inner = TRANS ? kred : nout, outer = TRANS ? nout : kred;
  const cuuint64_t b_dims[3] = {inner, outer, cuuint64_t(num_groups)};
  const cuuint64_t b_str[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t b_box[3] = {64, TRANS ? cuuint32_t(BN) : W::BK, 1};
  if (const int rc = tensor_map(&rhs_map, rhs, 3, b_dims, b_str, b_box))
    return rc;
  const auto kernel = gmm_kernel<BN, TRANS, F32OUT>;
  static bool opted = false;
  if (!opted) {
    if (const int rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM))
      return rc;
    opted = true;
  }
  const long long visits = (m + W::BM - 1) / W::BM + num_groups;
  const long long blocks = visits * ((nout + BN - 1) / BN);
  if (blocks > 0x7fffffff) return kErrShape;
  kernel<<<unsigned(blocks), W::THREADS, W::SMEM, stream>>>(
      lhs_map, rhs_map, gs, out, m, kred, nout, num_groups);
  return cudaGetLastError();
}

template <typename T, bool TRANS, int VEC, typename TO>
int launch_gmm(const void* lhs, const void* rhs, const int* gs, void* out,
               int m, int kred, int nout, int num_groups,
               cudaStream_t stream) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  const dim3 grid((m + BM - 1) / BM + num_groups, (nout + BN - 1) / BN);
  gmm_kernel<T, TRANS, VEC, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), gs,
      static_cast<TO*>(out), m, kred, nout, num_groups);
  return cudaGetLastError();
}

// ------------------------------------------------------------- kernel K
// out[e] (kd, n) = lhs_e^T . g_e over the rows of group e. The rows of a
// group are cut into chunks of `chunk` rows (the last one shorter); a work
// unit is one chunk of one group, and unit v is the v-th in group order
// (an empty group, or one past m, is one unit of no rows: it writes
// zeros). A group of one unit writes its output tile directly; a group of
// several writes one fp32 partial tile per unit into the workspace, and
// tgmm_reduce_kernel sums them in unit order and rounds once. The Hopper
// K gives slabs only to the units of groups of several units, numbered in
// unit order (ops/grouped_matmul.py tgmm_ws_slabs bounds them); the
// ring-less K writes every unit v into slab v. ops/grouped_matmul.py
// tgmm_units is the same walk.
// Every sum has one owner and a fixed order: no atomics, the same bits on
// every run.

// Unit v into `unit` as (group, v, row_lo, row_hi, units of the group,
// its slab among the units of groups of several units, -1 in a group of
// one); group -1 past the last unit.
__device__ void find_unit(long long* unit, const int* group_sizes, int m,
                          int num_groups, int chunk, long long v) {
  long long off = 0, seen = 0, split = 0;
  unit[0] = -1;
  for (int g = 0; g < num_groups; ++g) {
    const long long size = group_sizes[g] > 0 ? group_sizes[g] : 0;
    const long long lo = off < m ? off : m;
    const long long hi = off + size < m ? off + size : m;
    const long long count = hi > lo ? (hi - lo + chunk - 1) / chunk : 1;
    if (v < seen + count) {
      const long long c = v - seen;
      unit[0] = g;
      unit[1] = v;
      unit[2] = lo + c * chunk;
      unit[3] = lo + (c + 1) * chunk < hi ? lo + (c + 1) * chunk : hi;
      unit[4] = count;
      unit[5] = count > 1 ? split + c : -1;
      return;
    }
    seen += count;
    if (count > 1) split += count;
    off += size;
  }
}

// The ring-less K: fp32 operands, and bf16 ones that the tensor memory
// accelerator cannot address. Every unit writes its fp32 partial (slab v
// of ws) and the second pass (`all` set) sums every group, one unit or
// several. Grid (n_tiles, k_tiles, units).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    tgmm_kernel(const T* lhs, const T* grad, const int* group_sizes,
                float* ws, int m, int kd, int n, int num_groups, int chunk) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  __shared__ long long unit[6];
  if (threadIdx.x == 0)
    find_unit(unit, group_sizes, m, num_groups, chunk, blockIdx.z);
  __syncthreads();
  if (unit[0] < 0) return;   // past the last unit
  // A is lhs read transposed, B is g; rows outside [lo, hi) read as zero
  block_product<T, true, false, VEC, float>(
      lhs, kd, kd, grad, n, n, unit[2], unit[3], (long long)blockIdx.y * BM,
      (long long)blockIdx.x * BN, ws + unit[1] * (long long)kd * n, n, 0,
      kd);
}

// ------------------------------------------------- kernel K, bf16 (Hopper)
// Replaces megablox `tgmm` as ddp_practice_tpu/ops/moe.py reaches it
// (`_grouped_matmul`'s drhs, :465), for bf16 operands that are 16-byte
// aligned; ops/fused_encoder.py also runs the fused layer's four weight
// grads through it (one group over all tokens, fp32 output).
// Bound: operations. 2*m*kd*n = 154.6 GFLOP at the lm_moe shapes (m = 32768
// sorted rows, (kd, n) = (768, 3072) or (3072, 768)), 0.156 ms at 989.4
// TFLOP/s; ~0.25 GB of operands and result, 0.075 ms at 3.35 TB/s.
// Design (J's pieces, the reduction running over rows):
//   - A block of three warpgroups owns a 128 x BN tile (kd rows i0.., n
//     columns n0..) of one work unit; blocks run tile fastest (kd tile
//     fastest within a unit), so the tiles of a unit run side by side and
//     read its rows from L2.
//   - Warpgroup 0 is the producer: one thread keeps TMA filling a ring of
//     STAGES stages, each one 64-row slice of the unit: lhs as two boxes of
//     64 kd-columns x 64 rows, g as BN/64 boxes of 64 n-columns x 64 rows,
//     all 128-byte swizzled, and signals the stage's "full" mbarrier with
//     the bytes that landed. A slice starts at any row (TMA coordinates
//     need no alignment); rows past m arrive as zeros.
//   - Warpgroups 1 and 2 consume, 64 kd rows each: wgmma m64nBNk16 with
//     lhs^T as the MN-major A operand (transpose bit set; one 64-wide atom,
//     8-row groups 1024 bytes apart, a k16 step 2048 bytes on) and g as
//     the MN-major B operand exactly as J's forward rhs (BN/64 atoms 8 KiB
//     apart). fp32 accumulators in registers, one wgmma group in flight, a
//     stage released on its "empty" mbarrier once the products that read
//     it are done; setmaxnreg 40 / 232.
//   - The unit's last slice holds rows past its end (the next chunk, the
//     next group, the tail). In an MN-major slice each row is one whole
//     128-byte row of every box, and the swizzle permutes 16-byte chunks
//     only within a row, so the consumers zero those rows in every box of
//     both operands (0 . Inf from a neighbour's row would be NaN), fence
//     the generic writes to the async proxy (fence.proxy.async) and meet
//     at a named barrier before the wgmma that reads them.
//   - Epilogue: the accumulators go to shared memory in padded rows, then
//     16-byte stores of the rows below kd and columns below n: the output
//     type (bf16, or fp32 with F32OUT) into out[e] for a group of one unit,
//     fp32 into the unit's workspace slab otherwise.
//   - The split: chunk rows (ops/grouped_matmul.py tgmm_chunk: 16384,
//     4096 for an fp32 output, whose accumulation chain stays shorter;
//     halved down to 512 while the units would fill less than half the
//     SMs; chosen by experiments/tgmm_tune.py on an H100). At the lm_moe
//     shapes every group, balanced or skewed, is one unit (no partials); a
//     group beyond 16384 rows spreads over several units instead of
//     setting the kernel's time alone; a one-group product with few output
//     tiles (the fused layer's weight grads) gets 64-160 blocks of
//     1024-4096 rows. Longer units amortise the ring's fill and the
//     epilogue, and fewer of them mean fewer partials: 4096-row units beat
//     2048-row ones that fill all 132 SMs at those shapes.
//   - The workspace holds only the units that can split: a group of
//     several units has more than `chunk` rows, so there are at most
//     m / chunk + min(E, m / (chunk + 1)) such units (3 fp32 (kd, n) slabs,
//     28 MB, at the lm_moe shapes, where 10 would be needed for every
//     unit); none, and no second pass, when m <= chunk.
//   - Registers, spills and shared memory per instantiation: PERF.md (from
//     `-Xptxas -v`; chip_smoke.py prints them beside the blocks an SM).
template <int BN_> struct TgTile {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int STAGES = BN == 256 ? 4 : 5;
  static constexpr int THREADS = 384;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  // the ring, 2 x STAGES mbarriers and the unit; 1 KiB for alignment
  static constexpr int SMEM = RING + 16 * STAGES + 64 + 1024;
  static constexpr int LDO = BN + 8;   // padded epilogue row (elements)
  static_assert(2 * 64 * LDO * 4 <= RING, "the epilogue fits the ring");
};

// this warpgroup's 64 x BN accumulators to dst (rows i0.., row stride n):
// staged in shared memory (rows padded to LDO), stored as 16-byte chunks,
// rows below kd and columns below n only
template <int BN, typename U>
__device__ __forceinline__ void tgmm_store(U* dst, const float* acc,
                                           uint8_t* stage, int cw, int i0,
                                           int n0, int kd, int n) {
  constexpr int LDO = TgTile<BN>::LDO, CV = 16 / int(sizeof(U));
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  U* st = reinterpret_cast<U*>(stage) + cw * 64 * LDO;
  const int r0 = warp * 16 + (lane >> 2), tq = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    stage_pair(st + r0 * LDO + c, acc[4 * j], acc[4 * j + 1]);
    stage_pair(st + (r0 + 8) * LDO + c, acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_sync(2 + cw, 128);
  constexpr int CPR = BN / CV;   // 16-byte chunks a row
  const int row0 = i0 + cw * 64;
  for (int e = tid & 127; e < 64 * CPR; e += 128) {
    const int r = e / CPR, c = (e % CPR) * CV;
    if (row0 + r < kd && n0 + c < n)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * n + n0 + c) =
          *reinterpret_cast<const uint4*>(st + r * LDO + c);
  }
}

// lhs_map: lhs (m, kd), boxes of 64 x 64 (kd, rows); g_map: g (m, n), boxes
// of 64 x 64 (n, rows). out (E, kd, n), fp32 with F32OUT, else bf16; ws
// (units, kd, n) fp32. Grid units x tiles blocks in one dimension.
template <int BN, bool F32OUT>
__global__ void __launch_bounds__(TgTile<BN>::THREADS, 1)
    tgmm_wg_kernel(const __grid_constant__ CUtensorMap lhs_map,
                   const __grid_constant__ CUtensorMap g_map,
                   const int* group_sizes, void* out_ptr, float* ws, int m,
                   int kd, int n, int num_groups, int chunk) {
  using W = TgTile<BN>;
  using TO = typename std::conditional<F32OUT, float, bf16>::type;
  constexpr int BM = W::BM, BK = W::BK, S = W::STAGES;
  constexpr int BOX = 64 * BK * 2;   // one 64 x 64 box, 8 KiB
  extern __shared__ uint8_t wg_smem[];
  uint8_t* base = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + W::RING);
  uint64_t* empty = full + S;
  long long* unit = reinterpret_cast<long long*>(empty + S);
  const int tid = threadIdx.x;
  const int k_tiles = (kd + BM - 1) / BM;
  const int tiles = k_tiles * ((n + BN - 1) / BN);
  if (tid == 0) {
    find_unit(unit, group_sizes, m, num_groups, chunk, blockIdx.x / tiles);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long e = unit[0];
  if (e < 0) return;   // past the last unit
  const long long lo = unit[2], hi = unit[3], count = unit[4];
  const int tile = blockIdx.x % tiles;
  const int i0 = (tile % k_tiles) * BM, n0 = (tile / k_tiles) * BN;
  const int n_k = int((hi - lo + BK - 1) / BK);
  const int wg = tid / 128;
  if (wg == 0) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % S;
        mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        uint8_t* sa = base + s * W::STAGE_BYTES;
        uint8_t* sb = sa + W::A_BYTES;
        const int r0 = int(lo + (long long)kt * BK);
#pragma unroll
        for (int c = 0; c < BM / 64; ++c)
          tma_2d(sa + c * BOX, &lhs_map, &full[s], i0 + 64 * c, r0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_2d(sb + c * BOX, &g_map, &full[s], n0 + 64 * c, r0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;   // kd rows i0 + 64 cw .. of the tile
  const int lane = tid & 31;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  wg_fence_acc(acc);
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    uint8_t* stage = base + s * W::STAGE_BYTES;
    const long long left = hi - (lo + (long long)kt * BK);
    if (left < BK) {   // rows [left, 64) of the slice are not this unit's
      constexpr int BOXES = BM / 64 + BN / 64;
      const int per_box = (BK - int(left)) * 8;   // 16-byte chunks
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int x = tid - 128; x < BOXES * per_box; x += 256) {
        const int b = x / per_box, y = x % per_box;
        *reinterpret_cast<uint4*>(stage + b * BOX +
                                  (int(left) + y / 8) * 128 + (y % 8) * 16) =
            zero;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1, 256);
    }
    const uint8_t* sa = stage + cw * BOX;
    const uint8_t* sb = stage + W::A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = wg_desc(sa + kk * 16 * 128, BOX, 1024);
      const uint64_t db = wg_desc(sb + kk * 16 * 128, BOX, 1024);
      Wgmma<BN, 1, 1>::run(acc, da, db);
    }
    wg_commit();
    wg_wait<1>();   // the products of slice kt - 1 are done
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wg_wait<0>();
  wg_fence_acc(acc);
  // epilogue: both consumer groups are done with the ring, which stages
  // the output
  named_sync(1, 256);
  const long long slab = (long long)kd * n;
  if (count == 1)
    tgmm_store<BN>(static_cast<TO*>(out_ptr) + e * slab, acc, base, cw, i0,
                   n0, kd, n);
  else
    tgmm_store<BN>(ws + unit[5] * slab, acc, base, cw, i0, n0, kd, n);
}

// The second pass: out[e] = the sum, in unit order, of group e's partial
// slabs, rounded once, for every group of several units (every group when
// `all`: the ring-less K writes each unit's partial, and every unit has a
// slab). Each block walks the
// groups and strides over a group's elements; a group of one unit costs it
// one check. Grid min(ceil(kd * n / 256), kReduceBlocks), 256 threads.
constexpr int kReduceBlocks = 1024;
template <typename TO>
__global__ void __launch_bounds__(256)
    tgmm_reduce_kernel(const float* ws, const int* group_sizes, TO* out,
                       int m, int kd, int n, int num_groups, int chunk,
                       int all) {
  const long long slab = (long long)kd * n;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long off = 0, u0 = 0;
  for (int e = 0; e < num_groups; ++e) {
    const long long size = group_sizes[e] > 0 ? group_sizes[e] : 0;
    const long long lo = off < m ? off : m;
    const long long hi = off + size < m ? off + size : m;
    const long long count = hi > lo ? (hi - lo + chunk - 1) / chunk : 1;
    if (count > 1 || all) {
      for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
           i < slab; i += step) {
        float a = 0.f;
        for (long long c = 0; c < count; ++c) a += ws[(u0 + c) * slab + i];
        out[e * slab + i] = from_float<TO>(a);
      }
    }
    if (count > 1 || all) u0 += count;
    off += size;
  }
}

template <typename T, int VEC>
int launch_tgmm(const void* lhs, const void* grad, const int* gs, void* ws,
                int m, int kd, int n, int num_groups, int chunk,
                cudaStream_t stream) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  const long long units = (m + (long long)chunk - 1) / chunk + num_groups;
  if (units > 65535) return kErrShape;
  const dim3 grid((n + BN - 1) / BN, (kd + BM - 1) / BM, unsigned(units));
  tgmm_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(grad), gs,
      static_cast<float*>(ws), m, kd, n, num_groups, chunk);
  return cudaGetLastError();
}

template <int BN, bool F32OUT>
int launch_tgmm_wg(const void* lhs, const void* grad, const int* gs,
                   void* out, void* ws, int m, int kd, int n, int num_groups,
                   int chunk, cudaStream_t stream) {
  using W = TgTile<BN>;
  CUtensorMap lhs_map, g_map;
  const cuuint32_t box[2] = {64, W::BK};
  const cuuint64_t a_dims[2] = {cuuint64_t(kd), cuuint64_t(m)};
  const cuuint64_t a_str[1] = {cuuint64_t(kd) * 2};
  if (const int rc = tensor_map(&lhs_map, lhs, 2, a_dims, a_str, box))
    return rc;
  const cuuint64_t b_dims[2] = {cuuint64_t(n), cuuint64_t(m)};
  const cuuint64_t b_str[1] = {cuuint64_t(n) * 2};
  if (const int rc = tensor_map(&g_map, grad, 2, b_dims, b_str, box))
    return rc;
  const auto kernel = tgmm_wg_kernel<BN, F32OUT>;
  static bool opted = false;
  if (!opted) {
    if (const int rc = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM))
      return rc;
    opted = true;
  }
  const long long units = (m + (long long)chunk - 1) / chunk + num_groups;
  const long long blocks =
      units * ((kd + W::BM - 1) / W::BM) * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffff) return kErrShape;
  kernel<<<unsigned(blocks), W::THREADS, W::SMEM, stream>>>(
      lhs_map, g_map, gs, out, static_cast<float*>(ws), m, kd, n,
      num_groups, chunk);
  return cudaGetLastError();
}

template <bool F32OUT>
int tgmm_bf16_wg(const void* lhs, const void* grad, const int* gs, void* out,
                 void* ws, int m, int kd, int n, int num_groups, int chunk,
                 int bn, cudaStream_t stream) {
  if (bn == 192)
    return launch_tgmm_wg<192, F32OUT>(lhs, grad, gs, out, ws, m, kd, n,
                                       num_groups, chunk, stream);
  return launch_tgmm_wg<256, F32OUT>(lhs, grad, gs, out, ws, m, kd, n,
                                     num_groups, chunk, stream);
}

template <int BN>
int tg_occupancy(int* smem, int* threads, int* blocks) {
  using W = TgTile<BN>;
  const auto kernel = tgmm_wg_kernel<BN, false>;
  *smem = W::SMEM;
  *threads = W::THREADS;
  if (const int rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM))
    return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       W::THREADS, W::SMEM);
}

// The bf16 J: the Hopper kernel at tile width `bn` (256 or 128) when vec,
// else the ring-less kernel; fp32 output with F32OUT.
template <bool TRANS, bool F32OUT>
int gmm_bf16(const void* lhs, const void* rhs, const int* gs, void* out,
             int m, int kred, int nout, int num_groups, int vec, int bn,
             cudaStream_t stream) {
  using TO = typename std::conditional<F32OUT, float, bf16>::type;
  if (!vec || kred == 0)
    return launch_gmm<bf16, TRANS, 1, TO>(lhs, rhs, gs, out, m, kred, nout,
                                          num_groups, stream);
  if (bn == 128)
    return launch_gmm_wg<128, TRANS, F32OUT>(lhs, rhs, gs, out, m, kred,
                                             nout, num_groups, stream);
  return launch_gmm_wg<256, TRANS, F32OUT>(lhs, rhs, gs, out, m, kred, nout,
                                           num_groups, stream);
}

template <bool TRANS>
int gmm_dispatch(const void* lhs, const void* rhs, const int* gs, void* out,
                 int m, int kred, int nout, int num_groups, int vec,
                 int dtype, int out_f32, int bn, cudaStream_t stream) {
  if (dtype == kF32)
    return vec ? launch_gmm<float, TRANS, 4, float>(
                     lhs, rhs, gs, out, m, kred, nout, num_groups, stream)
               : launch_gmm<float, TRANS, 1, float>(
                     lhs, rhs, gs, out, m, kred, nout, num_groups, stream);
  if (out_f32)
    return gmm_bf16<TRANS, true>(lhs, rhs, gs, out, m, kred, nout,
                                 num_groups, vec, bn, stream);
  return gmm_bf16<TRANS, false>(lhs, rhs, gs, out, m, kred, nout,
                                num_groups, vec, bn, stream);
}

template <int BN>
int wg_occupancy(int* smem, int* threads, int* blocks) {
  using W = WgTile<BN>;
  const auto kernel = gmm_kernel<BN, false, false>;
  *smem = W::SMEM;
  *threads = W::THREADS;
  if (const int rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM))
    return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       W::THREADS, W::SMEM);
}

}  // namespace

// Kernel J. lhs (m, kred); rhs (E, kred, nout), or (E, nout, kred) with
// transpose_rhs; group_sizes (E,) int32 on the device; out (m, nout). All
// contiguous; lhs and rhs of one dtype (0 fp32, 1 bf16); out of that dtype,
// or fp32 from bf16 operands with out_f32. vec = 1 when every operand is
// 16-byte aligned with rows a multiple of 16 bytes (16-byte loads; bf16:
// the Hopper kernel, tile width bn = 256 or 128, 0 for the default 256).
extern "C" int grouped_matmul_gmm(const void* lhs, const void* rhs,
                                  const int* group_sizes, void* out, int m,
                                  int kred, int nout, int num_groups,
                                  int transpose_rhs, int vec, int dtype,
                                  int out_f32, int bn, void* stream) {
  if (m < 0 || kred < 0 || nout < 0 || num_groups < 1) return kErrShape;
  if (dtype != kF32 && dtype != kBF16) return kErrDType;
  if (out_f32 && dtype != kBF16) return kErrDType;
  auto s = static_cast<cudaStream_t>(stream);
  return transpose_rhs
             ? gmm_dispatch<true>(lhs, rhs, group_sizes, out, m, kred, nout,
                                  num_groups, vec, dtype, out_f32, bn, s)
             : gmm_dispatch<false>(lhs, rhs, group_sizes, out, m, kred,
                                   nout, num_groups, vec, dtype, out_f32, bn,
                                   s);
}

// Kernel K. lhs (m, kd), grad (m, n), group_sizes (E,) int32 on the
// device; out (E, kd, n); ws (slabs, kd, n) fp32 (slabs:
// ops/grouped_matmul.py tgmm_ws_slabs). lhs and grad of one dtype (0 fp32,
// 1 bf16); out of that dtype, or fp32 from bf16 operands with out_f32.
// direct = 1: the Hopper kernel (bf16 operands 16-byte aligned with rows a
// multiple of 16 bytes, m > 0), tile width bn = 256 or 192; it writes
// groups of one unit into out and the units of the other groups into ws.
// direct = 0: the ring-less kernel (vec: 16-byte loads), every unit into
// ws. Then grouped_matmul_tgmm_reduce with the same direct, unless ws has
// no slab (direct and m <= chunk: every group is one unit).
extern "C" int grouped_matmul_tgmm(const void* lhs, const void* grad,
                                   const int* group_sizes, void* out,
                                   void* ws, int m, int kd, int n,
                                   int num_groups, int chunk, int direct,
                                   int vec, int dtype, int out_f32, int bn,
                                   void* stream) {
  if (m < 0 || kd < 0 || n < 0 || num_groups < 1 || chunk < 1)
    return kErrShape;
  if (dtype != kF32 && dtype != kBF16) return kErrDType;
  if (out_f32 && dtype != kBF16) return kErrDType;
  auto s = static_cast<cudaStream_t>(stream);
  if (direct) {
    if (dtype != kBF16 || m == 0) return kErrShape;
    return out_f32 ? tgmm_bf16_wg<true>(lhs, grad, group_sizes, out, ws, m,
                                        kd, n, num_groups, chunk, bn, s)
                   : tgmm_bf16_wg<false>(lhs, grad, group_sizes, out, ws, m,
                                         kd, n, num_groups, chunk, bn, s);
  }
  if (dtype == kBF16)
    return vec ? launch_tgmm<bf16, 8>(lhs, grad, group_sizes, ws, m, kd, n,
                                      num_groups, chunk, s)
               : launch_tgmm<bf16, 1>(lhs, grad, group_sizes, ws, m, kd, n,
                                      num_groups, chunk, s);
  return vec ? launch_tgmm<float, 4>(lhs, grad, group_sizes, ws, m, kd, n,
                                     num_groups, chunk, s)
             : launch_tgmm<float, 1>(lhs, grad, group_sizes, ws, m, kd, n,
                                     num_groups, chunk, s);
}

// Kernel K's second pass over the workspace grouped_matmul_tgmm filled:
// out (E, kd, n) in the operands' dtype (0 fp32, 1 bf16), or fp32 with
// out_f32. direct as given to grouped_matmul_tgmm.
extern "C" int grouped_matmul_tgmm_reduce(const void* ws,
                                          const int* group_sizes, void* out,
                                          int m, int kd, int n,
                                          int num_groups, int chunk,
                                          int direct, int dtype, int out_f32,
                                          void* stream) {
  if (m < 0 || kd < 0 || n < 0 || num_groups < 1 || chunk < 1)
    return kErrShape;
  auto s = static_cast<cudaStream_t>(stream);
  const long long slab = (long long)kd * n;
  if (slab == 0) return 0;
  const unsigned grid = unsigned(
      (slab + 255) / 256 < kReduceBlocks ? (slab + 255) / 256 : kReduceBlocks);
  const float* w = static_cast<const float*>(ws);
  if (dtype == kBF16 && !out_f32)
    tgmm_reduce_kernel<bf16><<<grid, 256, 0, s>>>(
        w, group_sizes, static_cast<bf16*>(out), m, kd, n, num_groups, chunk,
        !direct);
  else if (dtype == kBF16 || dtype == kF32)
    tgmm_reduce_kernel<float><<<grid, 256, 0, s>>>(
        w, group_sizes, static_cast<float*>(out), m, kd, n, num_groups,
        chunk, !direct);
  else
    return kErrDType;
  return cudaGetLastError();
}

// The bf16 Hopper K's footprint at tile width bn (256 or 192), as
// grouped_matmul_occupancy gives J's.
extern "C" int grouped_matmul_tgmm_occupancy(int bn, int* smem, int* threads,
                                             int* blocks) {
  if (bn == 192) return tg_occupancy<192>(smem, threads, blocks);
  if (bn == 256) return tg_occupancy<256>(smem, threads, blocks);
  return kErrShape;
}

// The bf16 Hopper J's footprint at tile width bn (256 or 128): dynamic
// shared memory and threads a block, and blocks an SM by the runtime's
// occupancy calculator. Returns 0, a negative code of this file, or a
// cudaError_t.
extern "C" int grouped_matmul_occupancy(int bn, int* smem, int* threads,
                                        int* blocks) {
  if (bn == 128) return wg_occupancy<128>(smem, threads, blocks);
  if (bn == 256) return wg_occupancy<256>(smem, threads, blocks);
  return kErrShape;
}
