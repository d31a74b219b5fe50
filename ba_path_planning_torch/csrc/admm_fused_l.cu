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
// matvecs of an iteration are serial in the vector, but the order of the
// factor blocks is fixed for the whole interval: L_0, E_0, L_1, ...,
// L_{K-1} forward and the same sequence backward, every iteration.
//
// Design: one block per scenario runs the whole interval in one launch,
// split into one producer warp and 16 consumer warps (factor_ring.cuh).
//   * The producer streams the factor blocks in that order, as bands of
//     rows, into a ring of shared-memory stages with 1-D bulk copies
//     (cp.async.bulk) that complete on mbarriers.  It waits only for a free
//     stage, so it runs ahead of the vector across blocks, across the turn
//     from the forward to the backward sweep and across iterations (also
//     while the consumers do the elementwise stages), and keeps up to
//     stages x band bytes in flight: 7 x 28.8 KB at N = 20.  Bands shrink
//     until at least four stages fit.
//   * Linv_k is lower triangular (banded.factorize): the matvecs stop at
//     its diagonal.  Its zero half is copied all the same, a band being
//     one contiguous bulk copy; copying each row up to its diagonal was
//     tried both as a bulk copy per row and as 16-byte cp.async copies of
//     the producer warp, and both cost more than the quarter of the bytes
//     they save (factor_ring.cuh).
//   * The consumers take both matvecs from shared memory: forward by rows
//     with warp reductions, transposed straight down the columns (a lane a
//     column and every fourth row, two shuffles), so the transposed matvec
//     needs no partial sums in shared memory and one barrier, as the
//     forward one.  Barriers between matvecs are named barriers of the
//     consumers only.
//   * Shared memory holds the barriers, the ring, the sweep plane (K, n),
//     which starts as b, is overwritten by y_k in the forward sweep and by
//     xt_k in the backward sweep, and one vector (n); a collision row finds
//     its pair in closed form (admm_rows.cuh pair_first).  Where
//     the plane takes more than half of the shared memory, the launcher
//     puts it in a per-scenario global scratch (admm_fused.cuh; the plan
//     is ops/admm_fused.py fused_plan).
//   * Two instantiations: a warp keeps 4 column octets of the transposed
//     products (n <= 512, every N the router sends here at K = 50) or 7
//     (n <= 896: N <= 149, what the router sends here at K = 2..5).
//   * The elementwise phases and the row-plane layout are those of
//     admm_rows.cuh, shared with admm_fused_x.cu; hard collision rows
//     (lam = +inf) and disabled rows (lower bound -inf) need no case of
//     their own there.  Plain FP32.
//   * The factors come as float or as bf16 (SolverConfig.factor_dtype,
//     the element type T: half the bytes of the stream, rows stored ld
//     elements apart, a multiple of 8); bf16 elements are widened to FP32
//     as the matvecs read them, and every sum and vector is FP32.  On bf16
//     both matvecs read each element once, as part of a __nv_bfloat162
//     widened once, so that a consumer's load moves as many bytes as on
//     float rows: by rows a lane takes the column pairs 64 m + 2 l and a
//     warp sums its four rows in one joint reduction; transposed a lane
//     takes a column pair of an octet and every eighth row (the bf16
//     overloads of factor_ring's matvec_rows and matvec_cols).

#include <cuda_runtime.h>

#include "admm_fused.cuh"
#include "admm_rows.cuh"
#include "factor_ring.cuh"

namespace {

using admm_fused::consumer_sync;
using admm_fused::kConsumers;
using admm_fused::kThreads;

// Column octets a consumer warp keeps in the transposed products: n <=
// 8 kOct kConsumers / 32.
constexpr int kNarrowOctets = 4;
constexpr int kWideOctets = 7;

// The factor block at place s of the sweep order L_0, E_0, L_1, ..., L_{K-1}
// (nsq elements a block).
template <typename T>
__device__ __forceinline__ const T* sweep_block(const T* Lb, const T* Ebb,
                                                int s, size_t nsq) {
  return (s & 1) ? Ebb + (s >> 1) * nsq : Lb + (s >> 1) * nsq;
}

template <int kOct, typename T>
__global__ void __launch_bounds__(kThreads, 1)
admm_fused_l_kernel(const float* __restrict__ fpar,
                    const T* __restrict__ Linv,
                    const T* __restrict__ Eb,
                    const float* __restrict__ eta,
                    const float* __restrict__ l_s,
                    const float* __restrict__ u_s,
                    const float* __restrict__ l_c,
                    const float* __restrict__ rho_s,
                    const float* __restrict__ rho_c, float* x, float* zs,
                    float* ys, float* zc, float* yc, float* plane, int K,
                    int N, int ld, int n_iters, int band_rows, int stages,
                    int rho_s_stride, int rho_c_stride) {
  extern __shared__ float4 smem4[];
  const int n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const int b = blockIdx.x, tid = threadIdx.x;
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem4);
  const factor_ring::RingOf<T> ring{
      reinterpret_cast<T*>(raw + factor_ring::kBarrierBytes),
      factor_ring::smem_addr(raw), stages, band_rows * ld, ld};
  float* sm = reinterpret_cast<float*>(
      ring.data + static_cast<size_t>(stages) * ring.stage_elems);
  // (K, n) sweep plane, in shared memory unless the launcher gave a scratch
  float* xt = plane ? plane + static_cast<size_t>(b) * K * n : sm;
  float* r = plane ? sm : sm + K * n;            // (n) matvec input

  const size_t nsq = static_cast<size_t>(n) * ld;   // elements of a block
  const T* Lb = Linv + static_cast<size_t>(b) * K * nsq;
  const T* Ebb = Eb + static_cast<size_t>(b) * (K - 1) * nsq;
  const int last = 2 * K - 2;                    // place of L_{K-1}

  if (tid == 0) factor_ring::init(ring, kConsumers / 32);
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: the factor stream, in the consumers' order
    factor_ring::Cursor cur{0, 0u};
    for (int it = 0; it < n_iters; ++it) {
      for (int s = 0; s <= last; ++s)
        factor_ring::produce_block(ring, cur, sweep_block(Lb, Ebb, s, nsq), 0,
                                   n, band_rows);
      for (int s = last; s >= 0; --s)
        factor_ring::produce_block(ring, cur, sweep_block(Lb, Ebb, s, nsq), 0,
                                   n, band_rows);
    }
    return;
  }

  // ---- consumer warps
  const size_t so = static_cast<size_t>(b) * K * 6 * n2;
  const size_t co = static_cast<size_t>(b) * K * P;
  const admm_rows::Scenario sc{
      eta + 2 * co, l_s + so, u_s + so, l_c + co,
      rho_s + static_cast<size_t>(b) * rho_s_stride,
      rho_c + static_cast<size_t>(b) * rho_c_stride,
      x + static_cast<size_t>(b) * K * n, zs + so, ys + so, zc + co, yc + co,
      fpar[0], fpar[1], fpar[2], fpar[3], K, N};
  const int warp = tid >> 5, nwarps = kConsumers / 32;
  factor_ring::Cursor cur{0, 0u};

  for (int it = 0; it < n_iters; ++it) {
    admm_rows::build_rhs(sc, xt, tid, kConsumers);
    consumer_sync();

    // ---- forward sweep: y_k = Linv_k (b_k - E_k y_{k-1}), over b_k
    for (int s = 0; s <= last; ++s) {
      float* tk = xt + ((s + 1) >> 1) * n;
      if (s & 1) {                               // E_{k-1}, k = (s + 1) / 2
        factor_ring::matvec_rows(ring, cur, tk - n, n, 0, n, band_rows, false,
                                 warp, nwarps,
                                 [&](int i, float d) { r[i] = tk[i] - d; });
      } else {                                   // Linv_k, k = s / 2
        if (s == 0) {
          for (int j = tid; j < n; j += kConsumers) r[j] = tk[j];
          consumer_sync();
        }
        factor_ring::matvec_rows(ring, cur, r, n, 0, n, band_rows, true,
                                 warp, nwarps,
                                 [&](int i, float d) { tk[i] = d; });
      }
      consumer_sync();
    }

    // ---- backward sweep: xt_k = Linv_k^T (y_k - E_{k+1}^T xt_{k+1}),
    //      over y_k
    for (int s = last; s >= 0; --s) {
      float* tk = xt + (s >> 1) * n;
      if (s & 1) {                               // E_{k+1}^T, k = (s - 1) / 2
        factor_ring::matvec_cols<kOct>(
            ring, cur, tk + n, n, band_rows, false, warp, nwarps,
            [&](int j, float d) { r[j] = tk[j] - d; });
      } else {                                   // Linv_k^T, k = s / 2
        if (s == last) {
          for (int j = tid; j < n; j += kConsumers) r[j] = tk[j];
          consumer_sync();
        }
        factor_ring::matvec_cols<kOct>(ring, cur, r, n, band_rows, true,
                                       warp, nwarps,
                                       [&](int j, float d) { tk[j] = d; });
      }
      consumer_sync();
    }

    admm_rows::update_rows(sc, xt, tid, kConsumers);
    consumer_sync();
  }
}

// Launch the kernel of factor type T on a checked plan; the factors' rows
// lie ld elements apart.
template <typename T>
int launch(const float* fpar, const T* Linv, const T* Eb, const float* eta,
           const float* l_s, const float* u_s, const float* l_c,
           const float* rho_s, const float* rho_c, float* x, float* zs,
           float* ys, float* zc, float* yc, float* plane, int B, int K, int N,
           int ld, int n_iters, int band_rows, int stages, int rho_s_stride,
           int rho_c_stride, cudaStream_t stream) {
  const long smem = admm_fused::plan_smem(
      B, K, N, n_iters, band_rows, stages, plane == nullptr, false, false,
      static_cast<int>(sizeof(T)) * ld);
  const bool narrow = 6 * N <= 8 * kNarrowOctets * (kConsumers / 32);
  if (smem < 0 || ld < 6 * N || 6 * N > 8 * kWideOctets * (kConsumers / 32) ||
      (reinterpret_cast<size_t>(Linv) | reinterpret_cast<size_t>(Eb)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = narrow ? admm_fused_l_kernel<kNarrowOctets, T>
                       : admm_fused_l_kernel<kWideOctets, T>;
  const int err = admm_fused::allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<B, kThreads, smem, stream>>>(
      fpar, Linv, Eb, eta, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc, yc,
      plane, K, N, ld, n_iters, band_rows, stages, rho_s_stride,
      rho_c_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fpar (4,) = h, sigma, alpha, col_penalty; Linv (B, K, 6N, 6N) inverted
// diagonal factors, lower triangular (what lies above the diagonal is not
// read); Eb (B, K-1, 6N, 6N) off-diagonal factors;
// eta (B, K, P, 2); l_s, u_s (B, K, 6, 2N) static-row bounds; l_c (B, K, P)
// collision lower bounds; rho_s (K, 6) and rho_c (K, P) the rho of the
// first scenario, the others' at `rho_s_stride` and `rho_c_stride` floats
// apart (0: batch-shared; K * 6 and K * P: per-lane planes (B, K, 6) and
// (B, K, P), adaptive rho); x (B, K, 6N), zs, ys (B, K, 6, 2N) and zc, yc
// (B, K, P) are read and updated in place; plane (B, K, 6N) is the scratch
// of the sweep plane, or null where the plan keeps the plane in shared
// memory; (band_rows, stages) is the ring of the plan (ops/admm_fused.py
// fused_plan).  All float32, contiguous, the factors 16-byte aligned.
// Serves 6N <= 896.  Returns the CUDA error code of the launch, or
// cudaErrorInvalidValue for arguments it cannot serve.
int admm_fused_l_f32(const float* fpar, const float* Linv, const float* Eb,
                     const float* eta, const float* l_s, const float* u_s,
                     const float* l_c, const float* rho_s, const float* rho_c,
                     float* x, float* zs, float* ys, float* zc, float* yc,
                     float* plane, int B, int K, int N, int n_iters,
                     int band_rows, int stages, int rho_s_stride,
                     int rho_c_stride, cudaStream_t stream) {
  return launch<float>(fpar, Linv, Eb, eta, l_s, u_s, l_c, rho_s, rho_c, x,
                       zs, ys, zc, yc, plane, B, K, N, 6 * N, n_iters,
                       band_rows, stages, rho_s_stride, rho_c_stride, stream);
}

// As admm_fused_l_f32 on bf16 factors Linv (B, K, 6N, ld) and
// Eb (B, K-1, 6N, ld), rows ld elements apart (ld >= 6N, a multiple of 8;
// the columns from 6N on are not read), widened to FP32 as they are read;
// everything else float32.
int admm_fused_l_bf16(const float* fpar, const __nv_bfloat16* Linv,
                      const __nv_bfloat16* Eb, const float* eta,
                      const float* l_s, const float* u_s, const float* l_c,
                      const float* rho_s, const float* rho_c, float* x,
                      float* zs, float* ys, float* zc, float* yc,
                      float* plane, int B, int K, int N, int ld, int n_iters,
                      int band_rows, int stages, int rho_s_stride,
                      int rho_c_stride, cudaStream_t stream) {
  return launch<__nv_bfloat16>(fpar, Linv, Eb, eta, l_s, u_s, l_c, rho_s,
                               rho_c, x, zs, ys, zc, yc, plane, B, K, N, ld,
                               n_iters, band_rows, stages, rho_s_stride,
                               rho_c_stride, stream);
}

}  // extern "C"
