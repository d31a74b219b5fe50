// The warp sum of the ring's matvecs (factor_ring.cuh) and the slot
// recombinations of the sweeps (group_sweep.cuh, admm_fused_x.cu).

#pragma once

#include <cuda_runtime.h>

namespace sweeps {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
