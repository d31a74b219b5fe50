// X-form block-tridiagonal sweep solve (one ADMM x-update), for Hopper.
//
// Replaces the Pallas TPU kernel
// ba_path_planning_tpu/ops/pallas/group_solve.py (_make_group_kernel_X,
// launched by solve_factorized_grouped_X).  For every scenario it solves
// M x = b from the symmetric block inverses X_k:
//
//     forward   w_0 = X_0 b_0,  w_k = X_k (b_k - B_k w_{k-1})
//     backward  x_{K-1} = w_{K-1},  x_k = w_k - X_k (B_{k+1}^T x_{k+1})
//
// B_k = C_{k-1} (x) I_2N with C upper triangular, applied as the six
// slot-scalar axpys of the Pallas kernel's b_apply / b_apply_t.
//
// What bounds it: memory bandwidth.  Each solve streams every X_k twice
// (X_{K-1} once), (2K - 1) n^2 4 bytes = 5.7 MB per scenario at N = 20,
// K = 50, against 2 flops per byte; the 2K - 1 matvecs of a scenario are
// serial, so a design that waits for each row of X_k in turn is bound by
// the latency of those loads instead.
//
// Design (group_sweep.cuh, shared with the L-only and dense sweeps): a
// producer warp streams X_k in the sweeps' order, as bands of rows, through
// a ring of shared-memory stages (factor_ring.cuh) and runs ahead of the
// serial vector; 8 consumer warps take one matvec a step from the stages
// (X_k is symmetric, so row i is also the column the backward sweep needs).
// The
// launcher's plan (ops/group_solve.py sweep_plan) gives a large batch one
// block per scenario, four to an SM, and a small one (up to 64 scenarios) a
// cluster of 2 or 4 blocks per scenario, each streaming its share of the
// rows, the result meeting in distributed shared memory with one cluster
// barrier a step.  No lane padding and no scenario interleaving: those were
// rules of the TPU's DMA engine, not of this card.

#include <cuda_runtime.h>

#include "group_sweep.cuh"

extern "C" {

// X (B, K, n, n) symmetric block inverses; C9 (K-1, 9) upper-triangular slot
// scalars; b and x (B, K, n).  All float32, contiguous, X 16-byte aligned,
// n a multiple of 6 up to 6144.  (cluster, band_rows, stages) is the plan of
// sweep_plan.  Returns the CUDA error code of the launch.
int group_solve_x_f32(const float* X, const float* C9, const float* b,
                      float* x, int B, int K, int n, int cluster,
                      int band_rows, int stages, cudaStream_t stream) {
  return group_sweep::launch<group_sweep::kFormX>(X, C9, b, x, B, K, n,
                                                   cluster, band_rows, stages,
                                                   stream);
}

}  // extern "C"
