// Block-wide matvecs from global memory (banded_solve.cu), the warp sum of
// the ring's matvecs (factor_ring.cuh) and the slot recombinations of the
// grouped sweeps (group_sweep.cuh).  Every matvec is called by all threads
// of the block; none of them synchronises before it reads its inputs, so
// the caller puts a barrier between writing a vector and the matvec that
// reads it.

#pragma once

#include <cuda_runtime.h>

namespace sweeps {

// Columns a thread keeps partial sums of in matvec_cols: 8 registers a lane,
// 256 columns a pass.
constexpr int kColRegs = 8;
constexpr int kColTile = 32 * kColRegs;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Floats of shared memory matvec_cols needs for a block of `threads`.
__host__ __device__ inline int cols_part_floats(int threads) {
  return (threads / 32) * kColTile;
}

// fn(i, M[i, :] . r) for every row i < n.  A warp owns rows warp,
// warp + nwarps, ... and takes two of them at a time, so each lane keeps
// two row loads in flight; its lanes read consecutive addresses of a row
// and reduce with shuffles.
template <typename Fn>
__device__ __forceinline__ void matvec_rows(const float* __restrict__ M,
                                            const float* r, int n, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < n; i += 2 * nwarps) {
    const int i2 = i + nwarps;
    const float* row0 = M + static_cast<size_t>(i) * n;
    const float* row1 = M + static_cast<size_t>(i2 < n ? i2 : i) * n;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      const float rj = r[j];
      a0 = fmaf(__ldg(row0 + j), rj, a0);
      a1 = fmaf(__ldg(row1 + j), rj, a1);
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    if (lane == 0) {
      fn(i, a0);
      if (i2 < n) fn(i2, a1);
    }
  }
}

// fn(j, M[:, j] . t) for every column j < n: the transposed matvec, read
// by rows.  A warp owns rows warp, warp + nwarps, ...; its lanes read
// consecutive addresses of the row, each lane keeps the partial sums of its
// columns in registers, and the warps' partial sums meet in `part`
// (cols_part_floats(blockDim.x) floats of shared memory).  Ends with a
// barrier, so fn's writes are visible to the block when it returns.
template <typename Fn>
__device__ __forceinline__ void matvec_cols(const float* __restrict__ M,
                                            const float* t, int n,
                                            float* part, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int c0 = 0; c0 < n; c0 += kColTile) {
    float acc[kColRegs];
#pragma unroll
    for (int u = 0; u < kColRegs; ++u) acc[u] = 0.f;
    for (int i = warp; i < n; i += nwarps) {
      const float ti = t[i];
      const float* row = M + static_cast<size_t>(i) * n + c0;
#pragma unroll
      for (int u = 0; u < kColRegs; ++u) {
        const int j = u * 32 + lane;
        if (c0 + j < n) acc[u] = fmaf(__ldg(row + j), ti, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kColRegs; ++u)
      part[warp * kColTile + u * 32 + lane] = acc[u];
    __syncthreads();
    const int width = n - c0 < kColTile ? n - c0 : kColTile;
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += part[w * kColTile + j];
      fn(c0 + j, s);
    }
    __syncthreads();
  }
}

// (B w)[j] for B = C (x) I_n2 with C (3, 3) upper triangular, row-major c[9];
// w is anything indexed like an array of floats.
template <typename V>
__device__ __forceinline__ float slot_b(const float* c, const V& w, int j,
                                        int n2) {
  const int s = j / n2, q = j % n2;
  const float wa = w[q], wp = w[n2 + q], wv = w[2 * n2 + q];
  if (s == 0) return c[0] * wa + c[1] * wp + c[2] * wv;
  if (s == 1) return c[4] * wp + c[5] * wv;
  return c[8] * wv;
}

// (B^T v)[j] for the same B.
template <typename V>
__device__ __forceinline__ float slot_bt(const float* c, const V& v, int j,
                                         int n2) {
  const int s = j / n2, q = j % n2;
  const float va = v[q], vp = v[n2 + q], vv = v[2 * n2 + q];
  if (s == 0) return c[0] * va;
  if (s == 1) return c[1] * va + c[4] * vp;
  return c[2] * va + c[5] * vp + c[8] * vv;
}

}  // namespace sweeps
