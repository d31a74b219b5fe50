// One whole ADMM check interval with X-form factors, for Hopper.
//
// Replaces the Pallas TPU kernels ba_path_planning_tpu/ops/pallas/admm_fused.py
// _admm_kernel_XG (G scenarios per program) and _admm_kernel_X (one scenario
// per program), launched by admm_interval_fused_X in
// ba_path_planning_torch/ops/admm_fused.py.  G-interleaving only changed the
// TPU's issue order; here a grid of blocks runs the scenarios side by side,
// so one kernel stands for both.  Each of the n_iters iterations is the
// ADMM body of banded.solve_qp_state:
//
//     b   = A^T (rho z - y) + sigma x
//     xt  = M^{-1} b          X-form sweeps (banded.solve_factorized_X)
//     x   = alpha xt + (1 - alpha) x
//     zr  = alpha A xt + (1 - alpha) z
//     z   = clip(zr + y / rho, l, u);  collision rows: exact-penalty prox
//     y  += rho (zr - z)
//
// What bounds it: memory bandwidth.  Every iteration streams the
// scenario's factors X_k twice (forward and backward sweep), 2 K n^2 4
// bytes: 12.96 MB at N = 30 and 23 MB at N = 40 (K = 50), against 2 flops
// per byte.  The TPU kept the factors resident in 128 MB of VMEM for the
// whole interval; an SM has 227 KB of shared memory, so here they are
// re-read from HBM at every sweep step.  The 2K matvecs of an iteration
// are serial.
//
// Design: one block of 1024 threads per scenario runs the whole interval
// in one launch (one launch per QP instead of thousands of small ones).
//   * Sweep matvecs: a warp owns rows i = warp, warp + 32, ... and takes
//     two rows at a time; its lanes read consecutive addresses of a row
//     (X_k is symmetric, so the backward sweep reads rows too) and reduce
//     with shuffles, as in group_solve_x.cu.
//   * Shared memory holds the sweep plane (K, n), which starts as b, is
//     overwritten by w_k in the forward sweep and by xt_k in the backward
//     sweep, one right-hand-side vector (n) and the pair table (P pairs).
//     At N = 40 and K = 50 that is 50.6 KB.  Where the plane does not fit
//     (long horizons: K > 319 at N = 30), the launcher puts it in a
//     per-scenario global scratch instead, which stays in L2.
//   * x, z, y, the bounds and eta stay in global memory (about 1 MB per
//     scenario at N = 40, L2 and HBM); every element is read and written by
//     one thread per phase, and a block barrier separates the phases.  The
//     elementwise phases and the row-plane layout are those of
//     admm_rows.cuh, shared with admm_fused_l.cu.  Plain FP32.

#include <cuda_runtime.h>

#include "admm_rows.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fn(i, X_k[i, :] . r) for every row i < n; a warp takes rows i and
// i + kWarps together, so each lane keeps two row loads in flight.
template <typename Fn>
__device__ __forceinline__ void matvec_rows(const float* __restrict__ Xk,
                                            const float* r, int n, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += 2 * kWarps) {
    const int i2 = i + kWarps;
    const float* row0 = Xk + static_cast<size_t>(i) * n;
    const float* row1 = Xk + static_cast<size_t>(i2 < n ? i2 : i) * n;
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

__global__ void __launch_bounds__(kThreads, 1)
admm_fused_x_kernel(const float* __restrict__ fpar,
                    const float* __restrict__ C9,
                    const float* __restrict__ X,
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
  float* r = plane ? sm : sm + K * n;            // (n) right-hand side
  unsigned short* pi = reinterpret_cast<unsigned short*>(r + n);
  unsigned short* pj = pi + P;

  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Xb = X + static_cast<size_t>(b) * K * nsq;
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

    // ---- forward sweep: w_k = X_k (b_k - B_k w_{k-1}), over b_k
    for (int k = 0; k < K; ++k) {
      float* tk = xt + k * n;
      if (k == 0) {
        for (int j = tid; j < n; j += nthr) r[j] = tk[j];
      } else {
        const float* c = C9 + (k - 1) * 9;
        const float* w = tk - n;
        for (int j = tid; j < n; j += nthr) {
          const int s = j / n2, qq = j % n2;
          const float wa = w[qq], wp = w[n2 + qq], wv = w[2 * n2 + qq];
          float bw;
          if (s == 0)
            bw = c[0] * wa + c[1] * wp + c[2] * wv;
          else if (s == 1)
            bw = c[4] * wp + c[5] * wv;
          else
            bw = c[8] * wv;
          r[j] = tk[j] - bw;
        }
      }
      __syncthreads();
      matvec_rows(Xb + k * nsq, r, n, [&](int i, float d) { tk[i] = d; });
      __syncthreads();
    }

    // ---- backward sweep: xt_{K-1} = w_{K-1};
    //      xt_k = w_k - X_k (B_{k+1}^T xt_{k+1}), over w_k
    for (int k = K - 2; k >= 0; --k) {
      const float* c = C9 + k * 9;
      const float* v = xt + (k + 1) * n;
      for (int j = tid; j < n; j += nthr) {
        const int s = j / n2, qq = j % n2;
        const float va = v[qq], vp = v[n2 + qq], vv = v[2 * n2 + qq];
        float btx;
        if (s == 0)
          btx = c[0] * va;
        else if (s == 1)
          btx = c[1] * va + c[4] * vp;
        else
          btx = c[2] * va + c[5] * vp + c[8] * vv;
        r[j] = btx;
      }
      __syncthreads();
      float* tk = xt + k * n;
      matvec_rows(Xb + k * nsq, r, n, [&](int i, float d) { tk[i] -= d; });
      __syncthreads();
    }

    admm_rows::update_rows(sc, xt, pi, pj);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// fpar (4,) = h, sigma, alpha, col_penalty; C9 (K-1, 9) upper-triangular
// slot scalars; X (B, K, 6N, 6N) symmetric block inverses; eta (B, K, P, 2);
// l_s, u_s (B, K, 6, 2N) static-row bounds; l_c (B, K, P) collision lower
// bounds; rho_s (K, 6) and rho_c (K, P) batch-shared rho; x (B, K, 6N),
// zs, ys (B, K, 6, 2N) and zc, yc (B, K, P) are read and updated in place;
// plane (B, K, 6N) is scratch, used when the sweep plane does not fit in
// shared memory.  All float32, contiguous.  Returns the CUDA error code of
// the launch, or cudaErrorInvalidValue for arguments it cannot serve.
int admm_fused_x_f32(const float* fpar, const float* C9, const float* X,
                     const float* eta, const float* l_s, const float* u_s,
                     const float* l_c, const float* rho_s, const float* rho_c,
                     float* x, float* zs, float* ys, float* zc, float* yc,
                     float* plane, int B, int K, int N, int n_iters,
                     cudaStream_t stream) {
  if (B < 1 || K < 2 || N < 1 || N > 65535 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n = 6L * N, P = static_cast<long>(N) * (N - 1) / 2;
  const long plane_bytes = K * n * static_cast<long>(sizeof(float));
  long smem = n * static_cast<long>(sizeof(float))
              + admm_rows::pair_table_bytes(P);
  if (smem + plane_bytes <= kMaxSmemBytes) {
    smem += plane_bytes;
    plane = nullptr;
  } else if (plane == nullptr || smem > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      admm_fused_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_fused_x_kernel<<<B, kThreads, smem, stream>>>(
      fpar, C9, X, eta, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc, yc, plane,
      K, N, n_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
