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
//     forward   y_0 = Linv_0 b_0,  y_k = Linv_k (b_k - E_{k-1} y_{k-1})
//     backward  x_{K-1} = Linv_{K-1}^T y_{K-1}
//               x_k = Linv_k^T (y_k - E_k^T x_{k+1})
//
// What bounds it: memory bandwidth.  Each solve needs every Linv_k and E_k
// in both sweeps (Linv_{K-1} once), (4K - 3) n^2 4 bytes = 11.4 MB per
// scenario at N = 20, K = 50, against 2 flops per byte; the 4K - 3 steps of
// a scenario are serial.
//
// Design: the dense form of group_sweep.cuh, shared with the X-form and
// L-only sweeps.  A producer warp streams the blocks in the sweeps' fixed
// order (Linv_0, E_0, Linv_1, ..., Linv_{K-1}, then E_{K-2}, Linv_{K-2},
// ..., Linv_0), as bands of rows, through a ring of shared-memory stages
// (factor_ring.cuh) and runs ahead of the serial vector, across the turn
// between the sweeps too; 8 consumer warps take each step's product from
// the stages: by rows forward (stopping at the diagonal of Linv_k), as
// column partial sums in registers backward, both from one read of each
// band, and both at the turn, Linv_{K-1}.  The launcher's plan
// (ops/group_solve.py sweep_plan) gives a large batch one block per
// scenario, four to an SM, and a small one (up to 64 scenarios, the
// reference-compatible path's 64 and the SCP class's 1) a cluster of 2 or 4
// blocks per scenario, each streaming its share of the rows: forward steps
// exchange their rows of the result, backward steps their column partial
// sums, in distributed shared memory.  y_k is kept in the output array and
// overwritten by x_k.  No lane padding, no group size and no resident copy:
// those were rules of the TPU's VMEM and DMA engine, not of this card.

#include <cuda_runtime.h>

#include "group_sweep.cuh"

extern "C" {

// Linv (B, K, n, n) inverted diagonal factors, lower triangular (what lies
// above the diagonal is not read); Eb (B, K-1, n, n) off-diagonal factors;
// b and x (B, K, n).  All float32, contiguous, the factors 16-byte aligned,
// n even up to 1536.  (cluster, band_rows, stages,
// per_sm) is the plan of sweep_plan.  Returns the CUDA error code of the
// launch.
int banded_solve_f32(const float* Linv, const float* Eb, const float* b,
                     float* x, int B, int K, int n, int cluster,
                     int band_rows, int stages, int per_sm,
                     cudaStream_t stream) {
  return group_sweep::launch<group_sweep::kFormDense, float>(
      Linv, Eb, b, x, B, K, n, n, cluster, band_rows, stages, per_sm,
      stream);
}

// As banded_solve_f32 on bf16 factors Linv (B, K, n, ld) and
// Eb (B, K-1, n, ld), rows ld elements apart (ld >= n, a multiple of 8; the
// columns from n on are not read), widened to FP32 as they are read; b and
// x float32.
int banded_solve_bf16(const __nv_bfloat16* Linv, const __nv_bfloat16* Eb,
                      const float* b, float* x, int B, int K, int n, int ld,
                      int cluster, int band_rows, int stages,
                      int per_sm, cudaStream_t stream) {
  return group_sweep::launch<group_sweep::kFormDense, __nv_bfloat16>(
      Linv, Eb, b, x, B, K, n, ld, cluster, band_rows, stages, per_sm,
      stream);
}

}  // extern "C"
