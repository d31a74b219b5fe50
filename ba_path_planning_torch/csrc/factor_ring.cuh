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
// Used by admm_fused_x.cu, admm_fused_l.cu and, through group_sweep.cuh, by
// group_solve_x.cu, group_solve_l.cu and banded_solve.cu; the matvecs take
// the consumer warp's index and the number of consumer warps, so a kernel is
// free in how it splits its block.

#pragma once

#include <cuda_runtime.h>

#include "sweeps.cuh"

namespace factor_ring {

constexpr int kMaxStages = 8;
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
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The ring: `stages` tiles of `stage_floats` floats at `data`, and the full
// and empty barriers of each stage at `bars`.
struct Ring {
  float* data;
  unsigned bars;            // shared address of full[kMaxStages], empty[...]
  int stages, stage_floats;
  __device__ unsigned full(int s) const { return bars + 8 * s; }
  __device__ unsigned empty(int s) const {
    return bars + 8 * (kMaxStages + s);
  }
};

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
__device__ __forceinline__ void init(const Ring& ring, int consumer_warps) {
  for (int s = 0; s < ring.stages; ++s) {
    mbar_init(ring.full(s), 1);
    mbar_init(ring.empty(s), consumer_warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Producer warp: `floats` floats at `src` (a multiple of 4, 16-byte
// aligned) as the next band of the ring, one bulk copy by lane 0.
__device__ __forceinline__ void produce_span(const Ring& ring, Cursor& cur,
                                             const float* src, int floats) {
  if ((threadIdx.x & 31) != 0) return;
  mbar_wait(ring.empty(cur.stage), cur.phase ^ 1u);
  const unsigned bar = ring.full(cur.stage);
  const unsigned bytes = 4u * static_cast<unsigned>(floats);
  mbar_arrive_expect_tx(bar, bytes);
  bulk_copy(ring.data + static_cast<size_t>(cur.stage) * ring.stage_floats,
            src, bytes, bar);
  cur.advance(ring.stages);
}

// Producer warp: stream rows [lo, hi) of the n x n row-major `block` band
// by band (a band is one copy, so lane 0 does it all).
__device__ __forceinline__ void produce_block(const Ring& ring, Cursor& cur,
                                              const float* block, int n,
                                              int lo, int hi, int band_rows) {
  if ((threadIdx.x & 31) != 0) return;
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    produce_span(ring, cur, block + static_cast<size_t>(r0) * n,
                 (r1 - r0) * n);
  }
}

// Consumer: the band at the cursor, once it has landed.
__device__ __forceinline__ const float* acquire(const Ring& ring,
                                                const Cursor& cur) {
  mbar_wait(ring.full(cur.stage), cur.phase);
  return ring.data + static_cast<size_t>(cur.stage) * ring.stage_floats;
}

// Consumer: this warp is done with the band at the cursor.
__device__ __forceinline__ void release(const Ring& ring, Cursor& cur) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty(cur.stage));
  cur.advance(ring.stages);
}

constexpr int kRows = 4;        // rows a warp reduces at a time

// a[q] = M[i_q, :lim_q] . v for the rows i_q = i + q nwarps of the band
// [r0, r1) at M (lim_q = i_q + 1 if `tri`, else n); a row beyond the band
// stands in as row i and gets lim 0 and a 0.  Every lane returns the sums;
// the result is the largest lim.
__device__ __forceinline__ int row_dots(const float* M, int r0, int r1, int i,
                                        int nwarps, const float* v, int n,
                                        bool tri, const float* (&row)[kRows],
                                        int (&lim)[kRows], float (&a)[kRows]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const bool ok = i + q * nwarps < r1;
    const int iq = ok ? i + q * nwarps : i;
    row[q] = M + (iq - r0) * n;
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
      if (j < lim[q]) a[q] = fmaf(row[q][j], vj, a[q]);
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
template <typename Fn>
__device__ __forceinline__ void matvec_rows(const Ring& ring, Cursor& cur,
                                            const float* v, int n, int lo,
                                            int hi, int band_rows, bool tri,
                                            int warp, int nwarps, Fn fn) {
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    const float* M = acquire(ring, cur);
    for (int i = r0 + warp; i < r1; i += kRows * nwarps) {
      const float* row[kRows];
      int lim[kRows];
      float a[kRows];
      row_dots(M, r0, r1, i, nwarps, v, n, tri, row, lim, a);
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (lim[q] > 0) fn(i + q * nwarps, a[q]);
      }
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
template <int U, bool kDots>
__device__ __forceinline__ void matvec_rows_cols(const Ring& ring,
                                                 Cursor& cur, const float* v,
                                                 int n, int lo, int hi,
                                                 int band_rows, bool tri,
                                                 int warp, int nwarps,
                                                 float (&acc)[U]) {
  const int lane = threadIdx.x & 31;
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    const float* M = acquire(ring, cur);
    for (int i = r0 + warp; i < r1; i += kRows * nwarps) {
      const float* row[kRows];
      int lim[kRows];
      float y[kRows];
      int last;
      if constexpr (kDots) {
        last = row_dots(M, r0, r1, i, nwarps, v, n, tri, row, lim, y);
      } else {
        last = 0;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const bool ok = i + q * nwarps < r1;
          const int iq = ok ? i + q * nwarps : i;
          row[q] = M + (iq - r0) * n;
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
          if (j < lim[q]) s = fmaf(row[q][j], y[q], s);
        acc[u] = s;
      }
    }
    release(ring, cur);
  }
}

// Both products of a lower triangular block with one read of its rows
// [lo, hi), as matvec_rows_cols<U, true> with tri, for blocks too wide for
// register column sums: the products M[i, j] y_i of kRows rows at a time are
// added into the shared row `col` (col[j] += ..., j <= i), which the caller
// zeroes before and reads after a barrier.
__device__ __forceinline__ void matvec_rows_cols_shared(
    const Ring& ring, Cursor& cur, const float* v, int n, int lo, int hi,
    int band_rows, int warp, int nwarps, float* col) {
  const int lane = threadIdx.x & 31;
  for (int r0 = lo; r0 < hi; r0 += band_rows) {
    const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
    const float* M = acquire(ring, cur);
    for (int i = r0 + warp; i < r1; i += kRows * nwarps) {
      const float* row[kRows];
      int lim[kRows];
      float y[kRows];
      const int last = row_dots(M, r0, r1, i, nwarps, v, n, true, row, lim, y);
      for (int j = lane; j < last; j += 32) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (j < lim[q]) s = fmaf(row[q][j], y[q], s);
        atomicAdd(col + j, s);
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
// floats, and two shuffles sum the four row groups.  `tri`: M is lower
// triangular, column j starts at row j.
template <int kOct, typename Fn>
__device__ __forceinline__ void matvec_cols(const Ring& ring, Cursor& cur,
                                            const float* v, int n,
                                            int band_rows, bool tri, int warp,
                                            int nwarps, Fn fn) {
  const int lane = threadIdx.x & 31, g = lane >> 3, jj = lane & 7;
  float acc[kOct];
#pragma unroll
  for (int u = 0; u < kOct; ++u) acc[u] = 0.f;
  for (int r0 = 0; r0 < n; r0 += band_rows) {
    const int r1 = r0 + band_rows < n ? r0 + band_rows : n;
    const float* M = acquire(ring, cur);
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
            acc[u] = fmaf(M[(i - r0) * n + j], v[i], acc[u]);
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

}  // namespace factor_ring
