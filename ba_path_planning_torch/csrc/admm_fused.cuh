// What the two fused ADMM-interval kernels (admm_fused_x.cu on X-form
// factors, admm_fused_l.cu on dense (Linv, Eb) factors) share: one block a
// scenario of one producer warp, which streams the factor blocks through
// factor_ring.cuh, and 16 consumer warps, which run the sweeps from the
// ring and the elementwise stages of admm_rows.cuh; the layout of the
// block's dynamic shared memory; the check of a launch plan.  The plan
// (band rows and stages of the ring, whether the (K, 6N) sweep plane lies
// in shared memory or in a global scratch, and whether the X-form factors
// come as packed upper triangles) is made by the launcher,
// ops/admm_fused.py fused_plan.

#pragma once

#include <cuda_runtime.h>

#include "admm_rows.cuh"
#include "factor_ring.cuh"

namespace admm_fused {

constexpr int kConsumers = 512;               // 16 consumer warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr long kSmemMax = 232448;

// Barrier of the consumer threads only.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The X-form kernel's packed mode (admm_fused_x.cu): the most n = 6N it
// serves, and the most bands a block splits into.
constexpr int kPackedMaxN = 512;
constexpr int kMaxBands = 256;

// Floats a row of a factor block takes in the ring: n, or in the packed
// mode n rounded up to a multiple of 4.
__host__ __device__ inline long ring_width(long n, int packed) {
  return packed ? (n + 3) / 4 * 4 : n;
}

// Dynamic shared memory of a block for K steps of N vehicles (n = 6N): the
// ring's barriers and its `stages` stages of `band_rows` rows, the (K, n)
// sweep plane where `plane` is 1 (else it lies in a global scratch), one
// vector of n floats, in the packed mode the warps' column partial sums
// (kWarps x n), the row dots (n) and the band table (kMaxBands ints), the
// pair table (two 16-bit indices a pair) and, in the X form (`xform` 1),
// the slot scalars ((K - 1) x 9 floats).  ops/admm_fused.py fused_plan
// mirrors it, and tests/test_torch_fused_plan.py holds the two copies to
// each other.
__host__ __device__ inline long smem_bytes(int K, int N, int band_rows,
                                           int stages, int plane, int packed,
                                           int xform) {
  const long n = 6L * N;
  return factor_ring::kBarrierBytes +
         4L * (static_cast<long>(stages) * band_rows * ring_width(n, packed) +
               n * (1 + static_cast<long>(plane) * K +
                    static_cast<long>(packed) * (kWarps + 1)) +
               static_cast<long>(packed) * kMaxBands) +
         2L * N * (N - 1) + 36L * (K - 1) * xform;
}

// The shared memory of a launch plan, or -1 for a plan the kernels cannot
// run: bands of an even number of rows, 2 to kMaxStages stages, within an
// SM's shared memory; the packed mode up to n = kPackedMaxN.
inline long plan_smem(int B, int K, int N, int n_iters, int band_rows,
                      int stages, bool plane, bool packed, bool xform) {
  if (B < 1 || K < 2 || N < 1 || N > 65535 || n_iters < 0 ||
      band_rows < 2 || band_rows % 2 || band_rows > 6 * N || stages < 2 ||
      stages > factor_ring::kMaxStages ||
      (packed && 6 * N > kPackedMaxN))
    return -1;
  const long smem = smem_bytes(K, N, band_rows, stages, plane ? 1 : 0,
                               packed ? 1 : 0, xform ? 1 : 0);
  return smem <= kSmemMax ? smem : -1;
}

// Allow `kernel` the shared memory of a launch; returns a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, long smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace admm_fused
