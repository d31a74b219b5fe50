// A ring of factor tiles in shared memory that runs ahead of a serial
// vector: one producer warp streams the row bands of n x n factor blocks
// from global memory with 1-D bulk copies (cp.async.bulk, no tensor map)
// that complete on mbarriers; consumer warps wait for a band, multiply it
// with a vector from shared memory and release its stage.  The order of the
// blocks is the producer's and the consumers' common knowledge, so the
// producer runs ahead as far as the ring is deep: across blocks, across the
// turn between two sweeps, across iterations.
//
// A band is a run of whole rows (an even number of them, so that its bytes
// and its address are multiples of 16 for every even n) and is one bulk
// copy.  A block may be streamed whole or only its rows [lo, hi) (even
// bounds), where the blocks of a thread-block cluster share the rows of
// each factor block.  A lower triangular block is copied whole all the
// same: copying each row only up to its diagonal needs a copy per row, and
// both ways of doing that were slower than copying the zeros (a bulk copy
// per row is bound by the copy engine's request rate, 16-byte cp.async
// copies by how fast the one producer warp can start them).  The matvecs do
// stop at the diagonal of such a block.
//
// The factors are stored as float or as bf16 (the element type T of the
// ring): a bf16 element is widened to FP32 in registers as it is read, and
// every sum, vector and scalar stays FP32.  On bf16 rows the products read
// two neighbouring elements at once, one __nv_bfloat162 widened once (the
// bf16 overloads of matvec_rows and matvec_cols, matvec_rows_cols_bf16),
// so that a warp's load moves as many bytes as on float rows.  The rows of a block lie `ld`
// elements apart (Ring::ld): n for float factors; for bf16 ones n rounded
// up to a multiple of 8, so that every row is 16 bytes aligned
// (ops/group_solve.py bf16_row_stride).
//
// Used by admm_fused_x.cu, admm_fused_l.cu and, through group_sweep.cuh, by
// group_solve_x.cu, group_solve_l.cu and banded_solve.cu; the matvecs take
// the consumer warp's index and the number of consumer warps, so a kernel is
// free in how it splits its block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweeps.cuh"

namespace factor_ring {

constexpr int kMaxStages = 8;

// A factor element in FP32.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
constexpr int kBarrierBytes = 2 * kMaxStages * 8;   // full[], then empty[]

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The ring: `stages` tiles of `stage_elems` elements of T at `data`, and
// the full and empty barriers of each stage at `bars`; the rows of a factor
// block lie `ld` elements apart, in global memory and in a stage.
template <typename T>
struct RingOf {
  T* data;
  unsigned bars;            // shared address of full[kMaxStages], empty[...]
  int stages, stage_elems;
  int ld;
  __device__ unsigned full(int s) const { return bars + 8 * s; }
  __device__ unsigned empty(int s) const {
    return bars + 8 * (kMaxStages + s);
  }
};
using Ring = RingOf<float>;

// A role's position in the ring.  Both roles start at {0, 0} and walk the
// same sequence of bands.
struct Cursor {
  int stage;
  unsigned phase;
  __device__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// One thread initialises the barriers: a full barrier completes on the
// producer's arrival and the bytes it announced, an empty one on the
// arrival of every consumer warp.  The block synchronises afterwards.
template <typename T>
__device__ __forceinline__ void init(const RingOf<T>& ring,
                                     int consumer_warps) {
  for (int s = 0; s < ring.stages; ++s) {
    mbar_init(ring.full(s), 1);
    mbar_init(ring.empty(s), consumer_warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Producer warp: `elems` elements at `src` (16-byte aligned, a multiple of
// 16 bytes) as the next band of the ring, one bulk copy by lane 0.
template <typename T>
__device__ __forceinline__ void produce_span(const RingOf<T>& ring,
                                             Cursor& cur, const T* src,
                                             int elems) {
  if ((threadIdx.x & 31) != 0) return;
  mbar_wait(ring.empty(cur.stage), cur.phase ^ 1u);
  const unsigned bar = ring.full(cur.stage);
  const unsigned bytes =
      static_cast<unsigned>(sizeof(T)) * static_cast<unsigned>(elems);
  mbar_arrive_expect_tx(bar, bytes);
  bulk_copy(ring.data + static_cast<size_t>(cur.stage) * ring.stage_elems,
            src, bytes, bar);
  cur.advance(ring.stages);
}

// Producer warp: stream rows [lo, hi) of the row-major `block` (rows
// ring.ld apart) band by band (a band is one copy, so lane 0 does it all).
template <typename T>
__device__ __forceinline__ void produce_block(const RingOf<T>& ring,
                                              Cursor& cur, const T* block,
                                              int lo, int hi, int band_rows) {
  if ((threadIdx.x & 31) != 0) return;
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    produce_span(ring, cur, block + static_cast<size_t>(r0) * ring.ld,
                 (r1 - r0) * ring.ld);
  }
}

// Consumer: the band at the cursor, once it has landed.
template <typename T>
__device__ __forceinline__ const T* acquire(const RingOf<T>& ring,
                                            const Cursor& cur) {
  mbar_wait(ring.full(cur.stage), cur.phase);
  return ring.data + static_cast<size_t>(cur.stage) * ring.stage_elems;
}

// Consumer: this warp is done with the band at the cursor.
template <typename T>
__device__ __forceinline__ void release(const RingOf<T>& ring, Cursor& cur) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty(cur.stage));
  cur.advance(ring.stages);
}

constexpr int kRows = 4;        // rows a warp reduces at a time

// The pair (j, j + 1) of a bf16 row, j even, widened once; what lies from
// column lim on is taken as 0 (the second element of a pair at the
// diagonal too).
__device__ __forceinline__ float2 pair_below(const __nv_bfloat16* row, int j,
                                             int lim) {
  float2 e = make_float2(0.f, 0.f);
  if (j < lim) {
    e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + j));
    if (j + 1 >= lim) e.y = 0.f;
  }
  return e;
}

// As pair_below on a float row (8-byte aligned at j).
__device__ __forceinline__ float2 pair_below(const float* row, int j,
                                             int lim) {
  float2 e = make_float2(0.f, 0.f);
  if (j < lim) {
    e = *reinterpret_cast<const float2*>(row + j);
    if (j + 1 >= lim) e.y = 0.f;
  }
  return e;
}

// a[q] = M[i_q, :lim_q] . v for the rows i_q = i + q nwarps of the band
// [r0, r1) at M, rows ld apart (lim_q = i_q + 1 if `tri`, else n); a row
// beyond the band stands in as row i and gets lim 0 and a 0.  Every lane
// returns the sums; the result is the largest lim.
template <typename T>
__device__ __forceinline__ int row_dots(const T* M, int r0, int r1, int i,
                                        int nwarps, const float* v, int n,
                                        int ld, bool tri,
                                        const T* (&row)[kRows],
                                        int (&lim)[kRows], float (&a)[kRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const bool ok = i + q * nwarps < r1;
    const int iq = ok ? i + q * nwarps : i;
    row[q] = M + (iq - r0) * ld;
    lim[q] = ok ? (tri ? iq + 1 : n) : 0;
    a[q] = 0.f;
  }
  int last = lim[0];
#pragma unroll
  for (int q = 1; q < kRows; ++q) last = lim[q] > last ? lim[q] : last;
#pragma unroll 2
  for (int j = lane; j < last; j += 32) {
    const float vj = v[j];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (j < lim[q]) a[q] = fmaf(widen(row[q][j]), vj, a[q]);
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) a[q] = sweeps::warp_sum(a[q]);
  return last;
}

// fn(i, M[i, :] . v) for every row i in [lo, hi) of the next block in the
// ring, v (n) in shared memory.  `tri`: M is lower triangular, row i stops
// at column i.  Warp `warp` of `nwarps` takes rows r0 + warp,
// r0 + warp + nwarps, ... of each band [r0, r1), kRows at a time; its lanes
// read consecutive columns and reduce with shuffles.  Called by every
// consumer warp; fn runs on lane 0, and its writes need a barrier before
// they are read.
template <typename T, typename Fn>
__device__ __forceinline__ void matvec_rows(const RingOf<T>& ring,
                                            Cursor& cur, const float* v,
                                            int n, int lo, int hi,
                                            int band_rows, bool tri,
                                            int warp, int nwarps, Fn fn) {
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    const T* M = acquire(ring, cur);
    for (int i = r0 + warp; i < r1; i += kRows * nwarps) {
      const T* row[kRows];
      int lim[kRows];
      float a[kRows];
      row_dots(M, r0, r1, i, nwarps, v, n, ring.ld, tri, row, lim, a);
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (lim[q] > 0) fn(i + q * nwarps, a[q]);
      }
    }
    release(ring, cur);
  }
}

// The sums over a warp's lanes of kR values a lane (kR a power of two up
// to 32) in log2(kR) + log2(32 / kR) levels of shuffles, kR - 1 + log2(32 /
// kR) shuffles in all (kR log2(32) one by one): at each of the first levels
// the lanes of one half keep the upper half of the values, the others the
// lower, and each adds its partner's copy of what it keeps.  Lane l returns
// the sum of value l / (32 / kR).
template <int kR>
__device__ __forceinline__ float warp_sum_rows(float (&a)[kR], int lane) {
#pragma unroll
  for (int width = kR, s = 16; width > 1; width /= 2, s /= 2) {
    const bool upper = lane & s;
#pragma unroll
    for (int q = 0; q < width / 2; ++q) {
      const float keep = upper ? a[q + width / 2] : a[q];
      const float give = upper ? a[q] : a[q + width / 2];
      a[q] = keep + __shfl_xor_sync(0xffffffffu, give, s);
    }
  }
#pragma unroll
  for (int s = 16 / kR; s >= 1; s /= 2)
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], s);
  return a[0];
}

// matvec_rows on bf16 rows, each element read once and widened once: a
// warp takes kRows rows i + q nwarps at a time, lane l the column pairs j =
// 64 m + 2 l and j + 1 of each as one __nv_bfloat162 (a warp's load covers
// 128 bytes, as a float32 load does) with v[j], v[j + 1] as one float2 (v
// 8-byte aligned, n even); warp_sum_rows sums the kRows rows at once, and
// fn(i_q, sum) runs on the first of the 32 / kRows lanes that hold row q's.
template <typename Fn>
__device__ __forceinline__ void matvec_rows(
    const RingOf<__nv_bfloat16>& ring, Cursor& cur, const float* v, int n,
    int lo, int hi, int band_rows, bool tri, int warp, int nwarps, Fn fn) {
  constexpr int kSpan = 32 / kRows;      // lanes that end with one row's sum
  const int lane = threadIdx.x & 31;
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    const __nv_bfloat16* M = acquire(ring, cur);
    for (int i = r0 + warp; i < r1; i += kRows * nwarps) {
      const __nv_bfloat16* row = M + (i - r0) * ring.ld;
      int lim[kRows];
      float a[kRows];
      int last = 0;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int iq = i + q * nwarps;
        lim[q] = iq < r1 ? (tri ? iq + 1 : n) : 0;
        a[q] = 0.f;
        last = lim[q] > last ? lim[q] : last;
      }
      // j < last <= n, n even: v[j + 1] lies in v
#pragma unroll 2
      for (int j = 2 * lane; j < last; j += 64) {
        const float2 vj = *reinterpret_cast<const float2*>(v + j);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float2 e =
              pair_below(row + q * nwarps * ring.ld, j, lim[q]);
          a[q] = fmaf(e.y, vj.y, fmaf(e.x, vj.x, a[q]));
        }
      }
      const float sum = warp_sum_rows(a, lane);
      const int iq = i + lane / kSpan * nwarps;
      if (lane % kSpan == 0 && iq < r1) fn(iq, sum);
    }
    release(ring, cur);
  }
}

// Column products of a block with one read of its rows [lo, hi) from the
// ring: a weight y_i for each row, and at once acc[u] += M[i, j] y_i for
// the lane's columns j = 32 u + lane (j <= i if `tri`, else j < n), so the
// warp's partial sums of M[lo:hi, :]^T y stay in registers (U 32 >= hi if
// `tri`, else >= n).  kDots: y_i = M[i, :] . v (to the diagonal if `tri`),
// both products of the L form from one read; else y_i = v[i], the
// transposed product alone.  The rows are split over the warps as in
// matvec_rows; the caller sums the warps' acc.
template <int U, bool kDots, typename T>
__device__ __forceinline__ void matvec_rows_cols(const RingOf<T>& ring,
                                                 Cursor& cur, const float* v,
                                                 int n, int lo, int hi,
                                                 int band_rows, bool tri,
                                                 int warp, int nwarps,
                                                 float (&acc)[U]) {
  const int lane = threadIdx.x & 31;
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    const T* M = acquire(ring, cur);
    for (int i = r0 + warp; i < r1; i += kRows * nwarps) {
      const T* row[kRows];
      int lim[kRows];
      float y[kRows];
      int last;
      if constexpr (kDots) {
        last = row_dots(M, r0, r1, i, nwarps, v, n, ring.ld, tri, row, lim,
                        y);
      } else {
        last = 0;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const bool ok = i + q * nwarps < r1;
          const int iq = ok ? i + q * nwarps : i;
          row[q] = M + (iq - r0) * ring.ld;
          lim[q] = ok ? (tri ? iq + 1 : n) : 0;
          y[q] = ok ? v[iq] : 0.f;
          last = lim[q] > last ? lim[q] : last;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (32 * u >= last) break;
        const int j = 32 * u + lane;
        float s = acc[u];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (j < lim[q]) s = fmaf(widen(row[q][j]), y[q], s);
        acc[u] = s;
      }
    }
    release(ring, cur);
  }
}

// Pairs of a bf16 row that matvec_rows_cols_bf16 keeps in registers unless
// its caller asks for fewer
constexpr int kHoldPairs = 2;

// matvec_rows_cols on bf16 rows, each element read once and widened once:
// lane l reads the columns j = 64 m + 2 l and j + 1 of a row as one
// __nv_bfloat162 (a warp's load covers 128 bytes, as a float32 load does)
// and keeps their partial sums in acc[2 m] (column j) and acc[2 m + 1]
// (column j + 1), U 32 >= hi if `tri`, else >= n.  kDots: y_i is the row
// dot, formed from the same widened pairs (to the diagonal if `tri`); the
// first kHeld pairs of each row stay in registers for the column sums, and
// a row longer than 64 kHeld columns is read and widened again past them.
// Else y_i = v[i], and each pair is read once, for its column sums.
// What lies past the diagonal of a `tri` block is taken as 0, the second
// element of a pair at the diagonal too.  The rows are split over the warps
// as in matvec_rows; the caller sums the warps' acc.
template <int U, bool kDots, int kHeld = kHoldPairs>
__device__ __forceinline__ void matvec_rows_cols_bf16(
    const RingOf<__nv_bfloat16>& ring, Cursor& cur, const float* v, int n,
    int lo, int hi, int band_rows, bool tri, int warp, int nwarps,
    float (&acc)[U]) {
  constexpr int kPairs = U / 2;
  constexpr int kHold = !kDots ? 0 : kPairs < kHeld ? kPairs : kHeld;
  const int lane = threadIdx.x & 31;
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    const __nv_bfloat16* M = acquire(ring, cur);
    for (int i = r0 + warp; i < r1; i += kRows * nwarps) {
      // row q at row + q nwarps ld (read only where it lies in the band)
      const __nv_bfloat16* row = M + (i - r0) * ring.ld;
      const int step = nwarps * ring.ld;
      int lim[kRows];
      float y[kRows];
      float2 held[kRows][kHold > 0 ? kHold : 1];
      int last = 0;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const bool ok = i + q * nwarps < r1;
        const int iq = ok ? i + q * nwarps : i;
        lim[q] = ok ? (tri ? iq + 1 : n) : 0;
        y[q] = kDots || !ok ? 0.f : v[iq];
        last = lim[q] > last ? lim[q] : last;
      }
      if constexpr (kDots) {
#pragma unroll
        for (int m = 0; m < kPairs; ++m) {
          if (64 * m >= last) break;
          const int j = 64 * m + 2 * lane;
          // j < last <= n, n even: v[j + 1] lies in v wherever j < last
          const float2 vj = j < last
                                ? *reinterpret_cast<const float2*>(v + j)
                                : make_float2(0.f, 0.f);
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float2 e = pair_below(row + q * step, j, lim[q]);
            y[q] = fmaf(e.y, vj.y, fmaf(e.x, vj.x, y[q]));
            if (m < kHold) held[q][m < kHold ? m : 0] = e;
          }
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) y[q] = sweeps::warp_sum(y[q]);
      }
#pragma unroll
      for (int m = 0; m < kPairs; ++m) {
        if (64 * m >= last) break;
        const int j = 64 * m + 2 * lane;
        float s0 = acc[2 * m], s1 = acc[2 * m + 1];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float2 e = m < kHold ? held[q][m < kHold ? m : 0]
                                     : pair_below(row + q * step, j, lim[q]);
          s0 = fmaf(e.x, y[q], s0);
          s1 = fmaf(e.y, y[q], s1);
        }
        acc[2 * m] = s0;
        acc[2 * m + 1] = s1;
      }
    }
    release(ring, cur);
  }
}

// fn(j, M[:, j] . v) for every column j of the next block in the ring: the
// transposed matvec, straight down the columns of the band in shared memory.
// A warp owns the column octets warp, warp + nwarps, ... (at most kOct of
// them: n <= 8 kOct nwarps); a lane owns one column of the octet and every
// fourth row, so a warp's loads touch four rows of eight consecutive
// elements, and two shuffles sum the four row groups.  `tri`: M is lower
// triangular, column j starts at row j.
template <int kOct, typename T, typename Fn>
__device__ __forceinline__ void matvec_cols(const RingOf<T>& ring,
                                            Cursor& cur, const float* v,
                                            int n, int band_rows, bool tri,
                                            int warp, int nwarps, Fn fn) {
  const int lane = threadIdx.x & 31, g = lane >> 3, jj = lane & 7;
  float acc[kOct];
#pragma unroll
  for (int u = 0; u < kOct; ++u) acc[u] = 0.f;
  for (int r0 = 0; r0 < n; r0 += band_rows) {
    const int r1 = r0 + band_rows < n ? r0 + band_rows : n;
    const T* M = acquire(ring, cur);
#pragma unroll
    for (int u = 0; u < kOct; ++u) {
      const int first = (warp + u * nwarps) * 8, j = first + jj;
      if (first < n && !(tri && first >= r1)) {
        // rows below the octet's first column hold nothing of it
        int i = r0 + g;
        if (tri && first > r0) i += (first - r0) & ~3;
        const bool col_ok = j < n;
#pragma unroll 4
        for (; i < r1; i += 4)
          if (col_ok && (!tri || i >= j))
            acc[u] = fmaf(widen(M[(i - r0) * ring.ld + j]), v[i], acc[u]);
      }
    }
    release(ring, cur);
  }
#pragma unroll
  for (int u = 0; u < kOct; ++u) {
    float a = acc[u];
    a += __shfl_xor_sync(0xffffffffu, a, 8);
    a += __shfl_xor_sync(0xffffffffu, a, 16);
    const int j = (warp + u * nwarps) * 8 + jj;
    if (g == 0 && j < n) fn(j, a);
  }
}

// matvec_cols on bf16 rows, each element read once, as part of a
// __nv_bfloat162, and widened once: a warp owns the column octets warp,
// warp + nwarps, ... (at most kOct of them: n <= 8 kOct nwarps), as
// matvec_cols does; a lane owns the column pair j, j + 1 of its octet (j
// even) and every eighth row, so a warp's load covers eight rows of 16
// consecutive bytes (rows 240 bytes apart, as at n = 120, fall in distinct
// banks; a 16-column group and every fourth row would not), and three
// shuffles sum the row groups.  `tri`: column j starts at row j, so a pair
// is read from row j on and its second element taken as 0 in row j.  n is
// even, so a pair never crosses the end of a row.
template <int kOct, typename Fn>
__device__ __forceinline__ void matvec_cols(
    const RingOf<__nv_bfloat16>& ring, Cursor& cur, const float* v, int n,
    int band_rows, bool tri, int warp, int nwarps, Fn fn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, jj = 2 * (lane & 3);
  float2 acc[kOct];
#pragma unroll
  for (int u = 0; u < kOct; ++u) acc[u] = make_float2(0.f, 0.f);
  for (int r0 = 0; r0 < n; r0 += band_rows) {
    const int r1 = r0 + band_rows < n ? r0 + band_rows : n;
    const __nv_bfloat16* M = acquire(ring, cur);
#pragma unroll
    for (int u = 0; u < kOct; ++u) {
      const int first = (warp + u * nwarps) * 8, j = first + jj;
      if (j < n && !(tri && first >= r1)) {
        // rows below the octet's first column hold nothing of it
        int i = r0 + g;
        if (tri && first > r0) i += (first - r0) & ~7;
        const __nv_bfloat16* col = M + (i - r0) * ring.ld + j;
#pragma unroll 4
        for (; i < r1; i += 8, col += 8 * ring.ld)
          if (!tri || i >= j) {
            float2 e = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(col));
            if (tri && i == j) e.y = 0.f;
            const float vi = v[i];
            acc[u].x = fmaf(e.x, vi, acc[u].x);
            acc[u].y = fmaf(e.y, vi, acc[u].y);
          }
      }
    }
    release(ring, cur);
  }
#pragma unroll
  for (int u = 0; u < kOct; ++u) {
    float2 a = acc[u];
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {
      a.x += __shfl_xor_sync(0xffffffffu, a.x, s);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, s);
    }
    const int j = (warp + u * nwarps) * 8 + jj;
    if (g == 0 && j < n) {
      fn(j, a.x);
      fn(j + 1, a.y);
    }
  }
}

}  // namespace factor_ring
