// Dense (Linv, Eb) block-tridiagonal sweep solve (one ADMM x-update), for
// Hopper.
//
// Replaces three Pallas TPU kernels that compute this one function and
// differ in their VMEM tiling only:
// ba_path_planning_tpu/ops/pallas/banded_solve.py _solve_kernel (a scenario
// per program, factors resident) and _solve_kernel_nb (the same, unbatched
// under vmap), and ba_path_planning_tpu/ops/pallas/group_solve.py
// _group_kernel (G scenarios per program, factors streamed).  Launched by
// solve_factorized_dense in ba_path_planning_torch/ops/banded_solve.py.  For
// every scenario it solves M x = b from the inverted diagonal factors Linv_k
// and the off-diagonal factors E_k:
//
//     forward   y_0 = Linv_0 b_0,  y_k = Linv_k (b_k - E_k y_{k-1})
//     backward  x_{K-1} = Linv_{K-1}^T y_{K-1}
//               x_k = Linv_k^T (y_k - E_{k+1}^T x_{k+1})
//
// What bounds it: memory bandwidth.  Each solve streams every Linv_k and
// E_k twice, 2 (2K - 1) n^2 4 bytes = 11.4 MB per scenario at N = 20,
// K = 50, against 2 flops per byte; the 4K - 2 matvecs of a scenario are
// serial.
//
// Design: one block of 1024 threads per scenario runs the steps in order
// (the path's batches have about as many scenarios as the card has SMs, so
// a block's own 32 warps have to hide the load latency of each step).  The
// forward sweep reads each block by rows, a warp per two rows with
// consecutive addresses across its lanes.  The
// backward sweep needs the transposes and reads the blocks by rows as well:
// each lane keeps partial sums of its columns and the warps' sums meet in
// shared memory (sweeps.cuh), so no load walks down a column.  y_k is kept
// in the output array and overwritten by x_k.  No lane padding, no group
// size and no resident copy: those were rules of the TPU's VMEM and DMA
// engine, not of this card.

#include <cuda_runtime.h>

#include "sweeps.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
banded_solve_kernel(const float* __restrict__ Linv,
                    const float* __restrict__ Eb,
                    const float* __restrict__ bvec, float* __restrict__ xout,
                    int K, int n) {
  extern __shared__ float sm[];
  float* r = sm;             // input of the matvec with Linv_k
  float* v = sm + n;         // y_{k-1} in the forward sweep
  float* u = sm + 2 * n;     // x_{k+1} in the backward sweep
  float* part = sm + 3 * n;
  const int b = blockIdx.x;
  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Lb = Linv + static_cast<size_t>(b) * K * nsq;
  const float* Ebb = Eb + static_cast<size_t>(b) * (K - 1) * nsq;
  const float* bb = bvec + static_cast<size_t>(b) * K * n;
  float* xb = xout + static_cast<size_t>(b) * K * n;

  for (int k = 0; k < K; ++k) {
    const float* bk = bb + static_cast<size_t>(k) * n;
    if (k == 0) {
      for (int j = threadIdx.x; j < n; j += blockDim.x) r[j] = bk[j];
    } else {
      sweeps::matvec_rows(Ebb + (k - 1) * nsq, v, n,
                          [&](int i, float d) { r[i] = bk[i] - d; });
    }
    __syncthreads();
    float* yk = xb + static_cast<size_t>(k) * n;
    sweeps::matvec_rows(Lb + k * nsq, r, n, [&](int i, float d) {
      yk[i] = d;
      v[i] = d;
    });
    __syncthreads();
  }

  for (int k = K - 1; k >= 0; --k) {
    float* xk = xb + static_cast<size_t>(k) * n;
    const float* t = v;      // y_{K-1}
    if (k < K - 1) {
      sweeps::matvec_cols(Ebb + k * nsq, u, n, part,
                          [&](int j, float d) { r[j] = xk[j] - d; });
      t = r;
    }
    sweeps::matvec_cols(Lb + k * nsq, t, n, part, [&](int j, float d) {
      xk[j] = d;
      u[j] = d;
    });
  }
}

}  // namespace

extern "C" {

// Linv (B, K, n, n) inverted diagonal factors; Eb (B, K-1, n, n) off-diagonal
// factors; b and x (B, K, n).  All float32, contiguous.  Returns the CUDA
// error code of the launch.
int banded_solve_f32(const float* Linv, const float* Eb, const float* b,
                     float* x, int B, int K, int n, cudaStream_t stream) {
  if (B < 1 || K < 2 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (3 * static_cast<size_t>(n) + sweeps::cols_part_floats(kThreads))
      * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  banded_solve_kernel<<<B, kThreads, smem, stream>>>(Linv, Eb, b, x, K, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
