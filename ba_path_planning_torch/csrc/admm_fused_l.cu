// One whole ADMM check interval with dense (Linv, Eb) factors, for Hopper.
//
// Replaces the Pallas TPU kernel
// ba_path_planning_tpu/ops/pallas/admm_fused.py _admm_kernel, launched by
// admm_interval_fused in ba_path_planning_torch/ops/admm_fused.py.  Each of
// the n_iters iterations is the ADMM body of banded.solve_qp_state:
//
//     b   = A^T (rho z - y) + sigma x
//     xt  = M^{-1} b          dense sweeps (banded.solve_factorized):
//                             y_k = Linv_k (b_k - E_k y_{k-1})
//                             xt_k = Linv_k^T (y_k - E_{k+1}^T xt_{k+1})
//     x   = alpha xt + (1 - alpha) x
//     zr  = alpha A xt + (1 - alpha) z
//     z   = clip(zr + y / rho, l, u);  collision rows: exact-penalty prox
//     y  += rho (zr - z)
//
// What bounds it: memory bandwidth.  Every iteration streams the scenario's
// factors Linv_k and E_k twice (forward and backward sweep),
// 2 (2K - 1) n^2 4 bytes = 11.4 MB at N = 20, K = 50, against 2 flops per
// byte.  The TPU kept both factor sets resident in VMEM for the whole
// interval, which is what capped that kernel at N = 20; an SM has 227 KB of
// shared memory, so here they are re-read at every sweep step, from L2
// where the batch's factors fit there and from HBM otherwise.  The 4K - 2
// matvecs of an iteration are serial.
//
// Design: one block of 1024 threads per scenario runs the whole interval
// in one launch.
//   * The forward sweep reads each factor block by rows, a warp per row
//     with consecutive addresses across its lanes.  The backward sweep
//     needs the transposes and reads the blocks by rows as well, each lane
//     keeping the partial sums of its columns (sweeps.cuh), so no load
//     walks down a column.
//   * Shared memory holds the sweep plane (K, n), which starts as b, is
//     overwritten by y_k in the forward sweep and by xt_k in the backward
//     sweep, one vector (n), the partial sums of the transposed matvec
//     (32 KB) and the pair table: 58 KB at N = 20, K = 50.  Where the plane
//     does not fit, the launcher puts it in a per-scenario global scratch.
//   * The elementwise phases and the row-plane layout are those of
//     admm_rows.cuh, shared with admm_fused_x.cu; hard collision rows
//     (lam = +inf) and disabled rows (lower bound -inf) need no case of
//     their own there.  Plain FP32.

#include <cuda_runtime.h>

#include "admm_rows.cuh"
#include "sweeps.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmemBytes = 232448;

__global__ void __launch_bounds__(kThreads, 1)
admm_fused_l_kernel(const float* __restrict__ fpar,
                    const float* __restrict__ Linv,
                    const float* __restrict__ Eb,
                    const float* __restrict__ eta,
                    const float* __restrict__ l_s,
                    const float* __restrict__ u_s,
                    const float* __restrict__ l_c,
                    const float* __restrict__ rho_s,
                    const float* __restrict__ rho_c, float* x, float* zs,
                    float* ys, float* zc, float* yc, float* plane, int K,
                    int N, int n_iters) {
  extern __shared__ float4 smem4[];
  const int n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  float* sm = reinterpret_cast<float*>(smem4);
  // (K, n) sweep plane, in shared memory unless the launcher gave a scratch
  float* xt = plane ? plane + static_cast<size_t>(b) * K * n : sm;
  float* r = plane ? sm : sm + K * n;            // (n) matvec input
  float* part = r + n;
  unsigned short* pi = reinterpret_cast<unsigned short*>(
      part + sweeps::cols_part_floats(kThreads));
  unsigned short* pj = pi + P;

  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Lb = Linv + static_cast<size_t>(b) * K * nsq;
  const float* Ebb = Eb + static_cast<size_t>(b) * (K - 1) * nsq;
  const size_t so = static_cast<size_t>(b) * K * 6 * n2;
  const size_t co = static_cast<size_t>(b) * K * P;
  const admm_rows::Scenario sc{
      eta + 2 * co, l_s + so, u_s + so, l_c + co, rho_s, rho_c,
      x + static_cast<size_t>(b) * K * n, zs + so, ys + so, zc + co, yc + co,
      fpar[0], fpar[1], fpar[2], fpar[3], K, N};

  admm_rows::fill_pair_table(pi, pj, N);

  for (int it = 0; it < n_iters; ++it) {
    admm_rows::build_rhs(sc, xt);
    __syncthreads();

    // ---- forward sweep: y_k = Linv_k (b_k - E_k y_{k-1}), over b_k
    for (int k = 0; k < K; ++k) {
      float* tk = xt + k * n;
      if (k == 0) {
        for (int j = tid; j < n; j += nthr) r[j] = tk[j];
      } else {
        sweeps::matvec_rows(Ebb + (k - 1) * nsq, tk - n, n,
                            [&](int i, float d) { r[i] = tk[i] - d; });
      }
      __syncthreads();
      sweeps::matvec_rows(Lb + k * nsq, r, n,
                          [&](int i, float d) { tk[i] = d; });
      __syncthreads();
    }

    // ---- backward sweep: xt_k = Linv_k^T (y_k - E_{k+1}^T xt_{k+1}),
    //      over y_k
    for (int k = K - 1; k >= 0; --k) {
      float* tk = xt + k * n;
      if (k == K - 1) {
        for (int j = tid; j < n; j += nthr) r[j] = tk[j];
        __syncthreads();
      } else {
        sweeps::matvec_cols(Ebb + k * nsq, tk + n, n, part,
                            [&](int j, float d) { r[j] = tk[j] - d; });
      }
      sweeps::matvec_cols(Lb + k * nsq, r, n, part,
                          [&](int j, float d) { tk[j] = d; });
    }

    admm_rows::update_rows(sc, xt, pi, pj);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// fpar (4,) = h, sigma, alpha, col_penalty; Linv (B, K, 6N, 6N) inverted
// diagonal factors; Eb (B, K-1, 6N, 6N) off-diagonal factors;
// eta (B, K, P, 2); l_s, u_s (B, K, 6, 2N) static-row bounds; l_c (B, K, P)
// collision lower bounds; rho_s (K, 6) and rho_c (K, P) batch-shared rho;
// x (B, K, 6N), zs, ys (B, K, 6, 2N) and zc, yc (B, K, P) are read and
// updated in place; plane (B, K, 6N) is scratch, used when the sweep plane
// does not fit in shared memory.  All float32, contiguous.  Returns the CUDA
// error code of the launch, or cudaErrorInvalidValue for arguments it cannot
// serve.
int admm_fused_l_f32(const float* fpar, const float* Linv, const float* Eb,
                     const float* eta, const float* l_s, const float* u_s,
                     const float* l_c, const float* rho_s, const float* rho_c,
                     float* x, float* zs, float* ys, float* zc, float* yc,
                     float* plane, int B, int K, int N, int n_iters,
                     cudaStream_t stream) {
  if (B < 1 || K < 2 || N < 1 || N > 65535 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n = 6L * N, P = static_cast<long>(N) * (N - 1) / 2;
  const long plane_bytes = K * n * static_cast<long>(sizeof(float));
  long smem = (n + sweeps::cols_part_floats(kThreads))
                  * static_cast<long>(sizeof(float))
              + admm_rows::pair_table_bytes(P);
  if (smem + plane_bytes <= kMaxSmemBytes) {
    smem += plane_bytes;
    plane = nullptr;
  } else if (plane == nullptr || smem > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      admm_fused_l_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_fused_l_kernel<<<B, kThreads, smem, stream>>>(
      fpar, Linv, Eb, eta, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc, yc,
      plane, K, N, n_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
