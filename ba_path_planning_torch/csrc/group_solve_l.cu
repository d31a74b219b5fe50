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
// sweeps (Linv_{K-1} once): (2K - 1) n^2 4 bytes = 5.7 MB per scenario at
// N = 20, K = 50 as whole blocks, half of it below the diagonal, against
// 4 flops per byte of the triangle; the 2K - 1 steps of a scenario are
// serial.
//
// Design (group_sweep.cuh, shared with the X-form and dense sweeps): a
// producer warp streams Linv_k in the sweeps' order, as bands of whole
// rows, through a ring of shared-memory stages (factor_ring.cuh) and runs
// ahead of the serial vector; 8 consumer warps take both products of a
// step from one read of each band: a warp forms y_i for its rows and at
// once adds Linv_k[i, j] y_i into register partial sums of its lanes'
// columns, so Linv_k leaves HBM once a step (not once by rows and again for
// the transpose) and both products stop at the diagonal.  The launcher's
// plan (ops/group_solve.py sweep_plan) gives a large batch one block per
// scenario, four to an SM, and a small one (up to 64 scenarios, the
// reference-compatible path's 64 and the SCP class's 1) a cluster of 2 or 4
// blocks per scenario, each streaming its share of the rows, their column
// partial sums meeting in distributed shared memory with one cluster
// barrier a step.  w_k is kept in the output array and overwritten by x_k
// in the backward sweep.

#include <cuda_runtime.h>

#include "group_sweep.cuh"

extern "C" {

// Linv (B, K, n, n) inverted diagonal factors, lower triangular (what lies
// above the diagonal is not read); C9 (K-1, 9) upper-triangular slot
// scalars; b and x (B, K, n).  All float32, contiguous, Linv 16-byte
// aligned, n a multiple of 6 up to 6144.  (cluster, band_rows, stages) is the
// plan of sweep_plan.  Returns the CUDA error code of the launch.
int group_solve_l_f32(const float* Linv, const float* C9, const float* b,
                      float* x, int B, int K, int n, int cluster,
                      int band_rows, int stages, cudaStream_t stream) {
  return group_sweep::launch<group_sweep::kFormL>(Linv, C9, b, x, B, K, n,
                                                   cluster, band_rows, stages,
                                                   stream);
}

}  // extern "C"
