// The elementwise stages of the ADMM iteration on the routes that launch a
// sweep kernel per iteration (grouped_X, grouped_L, resident), and the
// whole check interval of the collision-free phase-1 QP ("channel"), for
// Hopper.  Launched by ba_path_planning_torch/ops/admm_steps.py.
//
// Replaces what XLA fuses around the Pallas sweep in the JAX package's
// ADMM loop body, admm_iter (ba_path_planning_tpu/solvers/banded.py:1319),
// which runs inside lax.fori_loop / lax.while_loop as one compiled
// program.  Run operator by operator, that body is ~177 PyTorch launches
// an iteration (banded.admm_iterations); here it is three launches beside
// the sweep kernel, or one launch an interval on the channel route:
//
//     admm_rhs     b  = A^T (rho z - y) + sigma x   (times 1 / rho of the
//                       lane where the grouped routes solve (M / rho) x)
//     (sweep)      xt = M^{-1} b
//     admm_update  x  = alpha xt + (1 - alpha) x
//                  zr = alpha A xt + (1 - alpha) z
//                  z  = clip(zr + y / rho, l, u); collision rows: the
//                       exact-penalty prox
//                  y += rho (zr - z)
//
// The arithmetic is that of admm_rows.cuh, which the fused interval
// kernels (admm_fused_x.cu, admm_fused_l.cu) run inside their loop; the
// rows lie as planes, as there: x (B, K, 6N), static rows (B, K, 6, 2N),
// collision rows (B, K, P).
//
// What bounds them: memory bandwidth.  Each stage reads every row of a
// lane once or twice (eta, the state, the bounds, rho) and writes b, or x,
// z and y, once, at about 1.3 flops a byte: at N = 20, K = 50, B = 512 the
// two stages move ~0.5 GB, ~0.15 ms at 3.35 TB/s, beside the sweep's
// ~1.1 ms.  Row k reads rows k - 1 .. k + 1 of its inputs and writes row k
// only, so the stages split k over blocks: a grid of (lane, k-tile)
// blocks (ops/admm_steps.py row_plan) fills the 132 SMs also at B = 1,
// where one block a lane would leave 131 of them idle.  The pair table of
// admm_update lies in shared memory, as in the fused kernels, filled a
// thread a pair; its static and collision rows start on different threads,
// so that both spread over the block.  A^T's column sum reads each pair's
// term from the threads of both vehicles; for one of them the threads of a
// warp read addresses about N floats apart, so admm_rhs moves more sectors
// than bytes (47% of its bound at N = 20, B = 512).
//
// The channel interval (one block a lane, n_iters iterations in one
// launch): build_rhs over the lane's rows by all threads, then the
// per-channel 3x3 forward and backward sweeps of
// banded.solve_factorized_channel on the (K, 3, 3) factors, one thread a
// channel column walking k, then update_rows.  The (K, 6N) plane lies in
// shared memory, or in a global scratch where it does not fit.  The
// collision rows are carried as admm_iterations carries them (phase 1
// disables them all with -inf lower bounds and eta = 0).  Plain FP32.
// Its time is that of the pair gather above, done by every lane at every
// iteration: at N = 20 one block alone takes ~0.12 ms an iteration, and
// the lanes of an SM share its load units.  Staging the terms in shared
// memory two steps at a time, the plane in global memory and a larger L1
// were each measured no faster (PERF.md).

#include <cuda_runtime.h>

#include "admm_rows.cuh"

namespace {

constexpr int kRowThreads = 256;      // admm_rhs, admm_update
constexpr int kChannelThreads = 256;  // admm_channel_interval
// channel blocks resident an SM that its register budget is set for:
// 4 took 16.1 ms at N=20, B=1024 against 21.4 for the compiler's choice
// and 20.3 for 8 (PERF.md)
constexpr int kChannelBlocksPerSm = 4;
constexpr long kSmemMax = 232448;

// Lane `lane`'s rows and the solver scalars fpar = (h, sigma, alpha, lam).
__device__ __forceinline__ admm_rows::Scenario lane_rows(
    const float* fpar, const float* eta, const float* l_s, const float* u_s,
    const float* l_c, const float* rho_s, const float* rho_c, float* x,
    float* zs, float* ys, float* zc, float* yc, int lane, int K, int N,
    int rho_s_stride, int rho_c_stride) {
  const size_t so = static_cast<size_t>(lane) * K * 12 * N;
  const size_t co = static_cast<size_t>(lane) * K * (N * (N - 1) / 2);
  return admm_rows::Scenario{
      eta + 2 * co, l_s ? l_s + so : nullptr, u_s ? u_s + so : nullptr,
      l_c ? l_c + co : nullptr,
      rho_s + static_cast<size_t>(lane) * rho_s_stride,
      rho_c + static_cast<size_t>(lane) * rho_c_stride,
      x + static_cast<size_t>(lane) * K * 6 * N, zs + so, ys + so, zc + co,
      yc + co, fpar[0], fpar[1], fpar[2], fpar[3], K, N};
}

__global__ void __launch_bounds__(kRowThreads)
    admm_rhs_kernel(const float* __restrict__ fpar,
                    const float* __restrict__ eta,
                    const float* __restrict__ rho_s,
                    const float* __restrict__ rho_c,
                    const float* __restrict__ inv_rho, const float* x,
                    const float* zs, const float* ys, const float* zc,
                    const float* yc, float* __restrict__ b, int K, int N,
                    int k_tile, int n_tiles, int rho_s_stride,
                    int rho_c_stride) {
  const int lane = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int n2 = 2 * N, k0 = tile * k_tile, k1 = min(K, k0 + k_tile);
  // the stage reads the state only
  const admm_rows::Scenario sc = lane_rows(
      fpar, eta, nullptr, nullptr, nullptr, rho_s, rho_c,
      const_cast<float*>(x), const_cast<float*>(zs), const_cast<float*>(ys),
      const_cast<float*>(zc), const_cast<float*>(yc), lane, K, N,
      rho_s_stride, rho_c_stride);
  admm_rows::build_rhs_rows(sc, b + static_cast<size_t>(lane) * K * 3 * n2,
                            k0 * n2, k1 * n2, threadIdx.x, blockDim.x,
                            inv_rho ? inv_rho[lane] : 1.f);
}

__global__ void __launch_bounds__(kRowThreads)
    admm_update_kernel(const float* __restrict__ fpar,
                       const float* __restrict__ eta,
                       const float* __restrict__ l_s,
                       const float* __restrict__ u_s,
                       const float* __restrict__ l_c,
                       const float* __restrict__ rho_s,
                       const float* __restrict__ rho_c,
                       const float* __restrict__ xt, float* x, float* zs,
                       float* ys, float* zc, float* yc, int K, int N,
                       int k_tile, int n_tiles, int rho_s_stride,
                       int rho_c_stride) {
  extern __shared__ unsigned short pair_table[];
  const int P = N * (N - 1) / 2, n2 = 2 * N, tid = threadIdx.x;
  unsigned short *pi = pair_table, *pj = pair_table + P;
  admm_rows::fill_pair_table(pi, pj, N);
  const int lane = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int k0 = tile * k_tile, k1 = min(K, k0 + k_tile);
  const admm_rows::Scenario sc =
      lane_rows(fpar, eta, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc, yc,
                lane, K, N, rho_s_stride, rho_c_stride);
  const float* t = xt + static_cast<size_t>(lane) * K * 3 * n2;
  __syncthreads();
  admm_rows::update_static_rows(sc, t, k0 * n2, k1 * n2, tid, blockDim.x);
  // the collision rows start on the threads after the static rows' last,
  // so that both kinds of rows spread over all threads
  const int shift = (k1 - k0) * n2 % blockDim.x;
  admm_rows::update_collision_rows(
      sc, t, pi, pj, k0 * P, k1 * P,
      (tid + blockDim.x - shift) % blockDim.x, blockDim.x);
}

// Forward and backward sweeps of one channel column (banded.py
// solve_factorized_channel) over the plane: col[k * 6N + s * 2N] is entry
// s of b_k on entry, of xt_k on exit.  L (K, 3, 3) and E (K - 1, 3, 3)
// row-major.
__device__ __forceinline__ void channel_sweeps(const float* __restrict__ L,
                                               const float* __restrict__ E,
                                               float* col, int K, int n2) {
  const int n = 3 * n2;
  float y0 = 0.f, y1 = 0.f, y2 = 0.f;
  for (int k = 0; k < K; ++k) {     // y_k = L_k (b_k - E_{k-1} y_{k-1})
    float* ck = col + static_cast<size_t>(k) * n;
    float r0 = ck[0], r1 = ck[n2], r2 = ck[2 * n2];
    if (k > 0) {
      const float* e = E + 9 * (k - 1);
      r0 -= e[0] * y0 + e[1] * y1 + e[2] * y2;
      r1 -= e[3] * y0 + e[4] * y1 + e[5] * y2;
      r2 -= e[6] * y0 + e[7] * y1 + e[8] * y2;
    }
    const float* l = L + 9 * k;
    y0 = l[0] * r0 + l[1] * r1 + l[2] * r2;
    y1 = l[3] * r0 + l[4] * r1 + l[5] * r2;
    y2 = l[6] * r0 + l[7] * r1 + l[8] * r2;
    ck[0] = y0;
    ck[n2] = y1;
    ck[2 * n2] = y2;
  }
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  for (int k = K - 1; k >= 0; --k) {  // x_k = L_k^T (y_k - E_k^T x_{k+1})
    float* ck = col + static_cast<size_t>(k) * n;
    float r0 = ck[0], r1 = ck[n2], r2 = ck[2 * n2];
    if (k < K - 1) {
      const float* e = E + 9 * k;
      r0 -= e[0] * x0 + e[3] * x1 + e[6] * x2;
      r1 -= e[1] * x0 + e[4] * x1 + e[7] * x2;
      r2 -= e[2] * x0 + e[5] * x1 + e[8] * x2;
    }
    const float* l = L + 9 * k;
    x0 = l[0] * r0 + l[3] * r1 + l[6] * r2;
    x1 = l[1] * r0 + l[4] * r1 + l[7] * r2;
    x2 = l[2] * r0 + l[5] * r1 + l[8] * r2;
    ck[0] = x0;
    ck[n2] = x1;
    ck[2 * n2] = x2;
  }
}

__global__ void __launch_bounds__(kChannelThreads, kChannelBlocksPerSm)
    admm_channel_kernel(const float* __restrict__ fpar,
                        const float* __restrict__ Linv,
                        const float* __restrict__ Eb,
                        const float* __restrict__ eta,
                        const float* __restrict__ l_s,
                        const float* __restrict__ u_s,
                        const float* __restrict__ l_c,
                        const float* __restrict__ rho_s,
                        const float* __restrict__ rho_c, float* x, float* zs,
                        float* ys, float* zc, float* yc, float* plane, int K,
                        int N, int n_iters, int rho_s_stride,
                        int rho_c_stride, int lane_factors) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const int lane = blockIdx.x, tid = threadIdx.x;
  float* xt = plane ? plane + static_cast<size_t>(lane) * K * n : sm;
  unsigned short* pi =
      reinterpret_cast<unsigned short*>(plane ? sm : sm + K * n);
  unsigned short* pj = pi + P;
  admm_rows::fill_pair_table(pi, pj, N);
  const admm_rows::Scenario sc =
      lane_rows(fpar, eta, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc, yc,
                lane, K, N, rho_s_stride, rho_c_stride);
  const float* L = Linv + (lane_factors ? static_cast<size_t>(lane) * 9 * K
                                        : 0);
  const float* E =
      Eb + (lane_factors ? static_cast<size_t>(lane) * 9 * (K - 1) : 0);
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    admm_rows::build_rhs(sc, xt);
    __syncthreads();
    for (int q = tid; q < n2; q += blockDim.x)
      channel_sweeps(L, E, xt + q, K, n2);
    __syncthreads();
    admm_rows::update_rows(sc, xt, pi, pj);
    __syncthreads();
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, long smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

bool row_args_ok(int B, int K, int N, int k_tile) {
  return B >= 1 && K >= 2 && N >= 1 && N <= 65535 && k_tile >= 1 &&
         admm_rows::pair_table_bytes(N * (N - 1L) / 2) <= kSmemMax;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of an admm_channel_interval block: the
// (K, 6N) plane where `plane` is 1, and the pair table.
long admm_channel_smem_bytes(int K, int N, int plane) {
  return 4L * K * 6 * N * plane +
         admm_rows::pair_table_bytes(N * (N - 1L) / 2);
}

// b (B, K, 6N) = A^T (rho z - y) + sigma x, times inv_rho[lane] where
// inv_rho (B,) is given (else null).  fpar (4,) = h, sigma, alpha,
// col_penalty; eta (B, K, P, 2); rho_s (K, 6) and rho_c (K, P) the rho of
// the first lane, the others' `rho_s_stride` and `rho_c_stride` floats
// apart (0: batch-shared); x (B, K, 6N), zs, ys (B, K, 6, 2N), zc, yc
// (B, K, P) are read.  Blocks of k_tile steps of one lane.  All float32,
// contiguous.  Returns the CUDA error code of the launch, or
// cudaErrorInvalidValue for arguments it cannot serve.
int admm_rhs_f32(const float* fpar, const float* eta, const float* rho_s,
                 const float* rho_c, const float* inv_rho, const float* x,
                 const float* zs, const float* ys, const float* zc,
                 const float* yc, float* b, int B, int K, int N, int k_tile,
                 int rho_s_stride, int rho_c_stride, cudaStream_t stream) {
  if (!row_args_ok(B, K, N, k_tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (K + k_tile - 1) / k_tile;
  admm_rhs_kernel<<<B * n_tiles, kRowThreads, 0, stream>>>(
      fpar, eta, rho_s, rho_c, inv_rho, x, zs, ys, zc, yc, b, K, N, k_tile,
      n_tiles, rho_s_stride, rho_c_stride);
  return static_cast<int>(cudaGetLastError());
}

// From the sweep's solution xt (B, K, 6N), update x (B, K, 6N), zs, ys
// (B, K, 6, 2N) and zc, yc (B, K, P) in place; l_s, u_s (B, K, 6, 2N) the
// static bounds, l_c (B, K, P) the collision lower bounds; the rest as in
// admm_rhs_f32.
int admm_update_f32(const float* fpar, const float* eta, const float* l_s,
                    const float* u_s, const float* l_c, const float* rho_s,
                    const float* rho_c, const float* xt, float* x, float* zs,
                    float* ys, float* zc, float* yc, int B, int K, int N,
                    int k_tile, int rho_s_stride, int rho_c_stride,
                    cudaStream_t stream) {
  if (!row_args_ok(B, K, N, k_tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const long smem = admm_rows::pair_table_bytes(N * (N - 1L) / 2);
  const int err = allow_smem(admm_update_kernel, smem);
  if (err != 0) return err;
  const int n_tiles = (K + k_tile - 1) / k_tile;
  admm_update_kernel<<<B * n_tiles, kRowThreads, smem, stream>>>(
      fpar, eta, l_s, u_s, l_c, rho_s, rho_c, xt, x, zs, ys, zc, yc, K, N,
      k_tile, n_tiles, rho_s_stride, rho_c_stride);
  return static_cast<int>(cudaGetLastError());
}

// n_iters ADMM iterations of the collision-free QP on the per-channel
// factors Linv (K, 3, 3) and Eb (K - 1, 3, 3), shared, or one set a lane
// where lane_factors is 1 ((B, K, 3, 3), (B, K - 1, 3, 3)); the rows and
// state as in admm_update_f32, x, zs, ys, zc, yc updated in place; plane
// (B, K, 6N) the scratch of the sweep plane, or null where it lies in
// shared memory (admm_channel_smem_bytes).  One block a lane.
int admm_channel_interval_f32(const float* fpar, const float* Linv,
                              const float* Eb, const float* eta,
                              const float* l_s, const float* u_s,
                              const float* l_c, const float* rho_s,
                              const float* rho_c, float* x, float* zs,
                              float* ys, float* zc, float* yc, float* plane,
                              int B, int K, int N, int n_iters,
                              int rho_s_stride, int rho_c_stride,
                              int lane_factors, cudaStream_t stream) {
  const long smem = admm_channel_smem_bytes(K, N, plane == nullptr);
  if (!row_args_ok(B, K, N, 1) || n_iters < 0 || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(admm_channel_kernel, smem);
  if (err != 0) return err;
  admm_channel_kernel<<<B, kChannelThreads, smem, stream>>>(
      fpar, Linv, Eb, eta, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc, yc,
      plane, K, N, n_iters, rho_s_stride, rho_c_stride, lane_factors);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
