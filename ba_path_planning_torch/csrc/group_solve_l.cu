// L-only block-tridiagonal sweep solve (one ADMM x-update), for Hopper.
//
// Replaces the Pallas TPU kernel
// ba_path_planning_tpu/ops/pallas/group_solve.py (_make_group_kernel_L,
// launched by solve_factorized_grouped_L).  For every scenario it solves
// M x = b from the inverted diagonal Cholesky factors Linv_k alone; the dense
// off-diagonal factors E_k are never stored, because B_k = C_{k-1} (x) I_2N
// is six slot scalars:
//
//     forward   y_k = Linv_k (b_k - B_k w_{k-1}),  w_k = Linv_k^T y_k
//     backward  x_{K-1} = w_{K-1}
//               x_k = w_k - Linv_k^T (Linv_k (B_{k+1}^T x_{k+1}))
//
// What bounds it: memory bandwidth.  Each solve needs every Linv_k in both
// sweeps, 2 K n^2 4 bytes = 5.76 MB per scenario at N = 20, K = 50, against
// 4 flops per byte; the 4K matvecs of a scenario are serial.
//
// Design: one block of 1024 threads per scenario runs the 2K steps in order
// (the path's batches have about as many scenarios as the card has SMs, so
// a block's own 32 warps have to hide the load latency of each step).  Each
// step applies Linv_k and then Linv_k^T; both read the block by rows from
// global memory with consecutive addresses across a warp (sweeps.cuh), the
// second pass finding the block in L1/L2 behind the first.  The same code
// path serves every n: nothing is staged in shared memory but three vectors
// and the partial sums of the transposed matvec (about 34 KB), so no size
// of n = 6N has a layout of its own.  w_k is kept in the output array and
// overwritten by x_k in the backward sweep.  No lane padding and no
// scenario interleaving: those were rules of the TPU's DMA engine, not of
// this card.

#include <cuda_runtime.h>

#include "sweeps.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
group_solve_l_kernel(const float* __restrict__ Linv,
                     const float* __restrict__ C9,
                     const float* __restrict__ bvec, float* __restrict__ xout,
                     int K, int n) {
  extern __shared__ float sm[];
  float* r = sm;             // right-hand side of the row matvec
  float* y = sm + n;         // its result, input of the transposed matvec
  float* v = sm + 2 * n;     // w_{k-1} (forward) / x_{k+1} (backward)
  float* part = sm + 3 * n;
  const int b = blockIdx.x;
  const int n2 = n / 3;
  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Lb = Linv + static_cast<size_t>(b) * K * nsq;
  const float* bb = bvec + static_cast<size_t>(b) * K * n;
  float* xb = xout + static_cast<size_t>(b) * K * n;

  for (int k = 0; k < K; ++k) {
    const float* bk = bb + static_cast<size_t>(k) * n;
    const float* c = C9 + (k > 0 ? k - 1 : 0) * 9;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      r[j] = k == 0 ? bk[j] : bk[j] - sweeps::slot_b(c, v, j, n2);
    __syncthreads();
    const float* Lk = Lb + k * nsq;
    sweeps::matvec_rows(Lk, r, n, [&](int i, float d) { y[i] = d; });
    __syncthreads();
    float* wk = xb + static_cast<size_t>(k) * n;
    sweeps::matvec_cols(Lk, y, n, part, [&](int j, float d) {
      wk[j] = d;
      v[j] = d;
    });
  }

  for (int k = K - 2; k >= 0; --k) {
    const float* c = C9 + k * 9;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      r[j] = sweeps::slot_bt(c, v, j, n2);
    __syncthreads();
    const float* Lk = Lb + k * nsq;
    sweeps::matvec_rows(Lk, r, n, [&](int i, float d) { y[i] = d; });
    __syncthreads();
    float* xk = xb + static_cast<size_t>(k) * n;
    sweeps::matvec_cols(Lk, y, n, part, [&](int j, float d) {
      const float val = xk[j] - d;
      xk[j] = val;
      v[j] = val;
    });
  }
}

}  // namespace

extern "C" {

// Linv (B, K, n, n) inverted diagonal factors; C9 (K-1, 9) upper-triangular
// slot scalars; b and x (B, K, n).  All float32, contiguous.  Returns the
// CUDA error code of the launch.
int group_solve_l_f32(const float* Linv, const float* C9, const float* b,
                      float* x, int B, int K, int n, cudaStream_t stream) {
  if (B < 1 || K < 2 || n < 3 || n % 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (3 * static_cast<size_t>(n) + sweeps::cols_part_floats(kThreads))
      * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  group_solve_l_kernel<<<B, kThreads, smem, stream>>>(Linv, C9, b, x, K, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
