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
//     xt  = M^{-1} b          X-form sweeps (banded.solve_factorized_X):
//                             w_k = X_k (b_k - B_k w_{k-1})
//                             xt_k = w_k - X_k (B_{k+1}^T xt_{k+1})
//     x   = alpha xt + (1 - alpha) x
//     zr  = alpha A xt + (1 - alpha) z
//     z   = clip(zr + y / rho, l, u);  collision rows: exact-penalty prox
//     y  += rho (zr - z)
//
// What bounds it: memory bandwidth, and the serial chain of its steps.
// Every iteration applies every X_k in both sweeps (X_{K-1} once), 2K - 1
// products with n x n blocks: 12.8 MB at N = 30 and 22.8 MB at N = 40
// (K = 50) of whole blocks, against 2 flops per byte.  The TPU kept the factors resident in 128 MB of VMEM for
// the whole interval; an SM has 227 KB of shared memory, so here they are
// re-read from HBM at every sweep step.  The 2K - 1 products of an
// iteration are serial in the vector, but the order of the factor blocks
// is fixed for the whole interval: X_0 .. X_{K-1}, then X_{K-2} .. X_0,
// every iteration.
//
// Design: the skeleton of admm_fused_l.cu (admm_fused.cuh): one block per
// scenario runs the whole interval in one launch, split into one producer
// warp and 16 consumer warps.
//   * The producer streams the blocks in that order, as bands of rows, into
//     a ring of shared-memory stages with 1-D bulk copies that complete on
//     mbarriers (factor_ring.cuh).  It waits only for a free stage, so it
//     runs ahead of the vector across blocks, across the turn between the
//     sweeps, across the elementwise stages and across iterations.
//   * Packed mode (n up to kPackedMaxN = 512, where the launcher's plan
//     chooses it: from N = 39, ops/admm_fused.py fused_plan): X_k is
//     symmetric, so X_k r = U r + (strict U)^T r for its upper triangle U,
//     and the launcher hands the kernel each X_k as its packed upper
//     triangle (ops/admm_fused.py pack_upper: row i from column
//     4 floor(i/4) on, so that every row starts 16-byte aligned): about
//     half the bytes of the whole block.  The bands are runs of packed rows
//     that fill a stage, each one bulk copy.  A warp takes four rows at a
//     time and, from one read of each entry, forms the row dots of U r with
//     a warp reduction and adds the entries right of the diagonal, times
//     r_i, into register partial sums of its lanes' columns (16 registers a
//     lane); after the block's last band the warps' partial sums meet in
//     shared memory and join the dots.  This is the L form's two products
//     from one read (group_sweep.cuh), on the upper triangle.
//   * Whole-band mode (the other N; up to N = 38 it times as fast or
//     faster on the H100: the packed mode's one more barrier and reduction
//     a step outweigh the bytes it saves): one matvec by rows a step from
//     whole row bands (X_k is symmetric, so row i is also the column the
//     backward sweep needs).
//   * B_k = C_{k-1} (x) I_2N is applied as the six slot-scalar axpys of
//     sweeps.cuh between the products.  Barriers between the steps are
//     named barriers of the consumers only.
//   * Shared memory holds the barriers, the ring, the sweep plane (K, n),
//     which starts as b, is overwritten by w_k in the forward sweep and by
//     xt_k in the backward sweep, one vector (n), the packed mode's partial
//     sums, dots and band table, the pair table and the slot scalars (read
//     at every step, so kept off the global-memory latency).  Where the plane takes
//     more than half of the shared memory (long horizons: K > 161 at
//     N = 30), the launcher puts it in a per-scenario global scratch, which
//     stays in L2.
//   * x, z, y, the bounds and eta stay in global memory (about 1 MB per
//     scenario at N = 40, L2 and HBM); the elementwise phases and the
//     row-plane layout are those of admm_rows.cuh, shared with
//     admm_fused_l.cu.  Plain FP32.

#include <cuda_runtime.h>

#include "admm_fused.cuh"
#include "admm_rows.cuh"
#include "factor_ring.cuh"
#include "sweeps.cuh"

namespace {

using admm_fused::consumer_sync;
using admm_fused::kConsumers;
using admm_fused::kThreads;
using admm_fused::kWarps;

// Column sums a lane keeps in the packed mode: n <= 32 kPackedRegs.
constexpr int kPackedRegs = admm_fused::kPackedMaxN / 32;

// Offset of row i in the packed upper triangle of a block (rows of
// R - 4 floor(i/4) floats from column 4 floor(i/4), R = n rounded up to a
// multiple of 4; ops/admm_fused.py pack_upper); packed_off(n, R) is the
// block's size.
__device__ __forceinline__ int packed_off(int i, int R) {
  const int g = i >> 2;
  return 4 * (g * R - 2 * g * (g - 1)) + (i & 3) * (R - 4 * g);
}

// One band [r0, r1) of packed rows at M: for each of its rows i,
// dots[i] = U[i, i:] . v, and acc[u] += U[i, j] v_i for the lane's columns
// j = 32 u + lane > i.  Warp `warp` takes rows r0 + warp, r0 + warp +
// kWarps, ..., kRows at a time, from one read of each entry.
__device__ __forceinline__ void packed_band(const float* M, int r0, int r1,
                                            int n, int R, const float* v,
                                            int warp, float* dots,
                                            float (&acc)[kPackedRegs]) {
  constexpr int kRows = factor_ring::kRows;
  const int lane = threadIdx.x & 31, base = packed_off(r0, R);
  for (int i = r0 + warp; i < r1; i += kRows * kWarps) {
    const float* row[kRows];
    int diag[kRows];
    float vi[kRows], d[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const bool ok = i + q * kWarps < r1;
      const int iq = ok ? i + q * kWarps : i;
      // row[q][j] is U[iq, j] for j from 4 floor(iq / 4) to n
      row[q] = M + (packed_off(iq, R) - base) - (iq & ~3);
      diag[q] = ok ? iq : n;        // a row beyond the band takes no column
      vi[q] = v[iq];
      d[q] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPackedRegs; ++u) {
      if (32 * u >= n) break;
      if (32 * u + 32 <= i) continue;    // left of every row's diagonal
      const int j = 32 * u + lane;
      const float vj = j < n ? v[j] : 0.f;
      // the loads are unconditional, so that they issue together: an entry
      // left of a row's diagonal or past the band reads a neighbour's
      // floats of the ring (never more than 31 away, so always inside
      // the block's shared memory) and is masked out
      float m[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) m[q] = row[q][j];
      float s = acc[u];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float mq = j >= diag[q] && j < n ? m[q] : 0.f;
        d[q] = fmaf(mq, vj, d[q]);
        s = fmaf(j > diag[q] ? mq : 0.f, vi[q], s);
      }
      acc[u] = s;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) d[q] = sweeps::warp_sum(d[q]);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (diag[q] < n) dots[diag[q]] = d[q];
    }
  }
}

template <bool kPacked>
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
                    int N, int n_iters, int band_rows, int stages) {
  extern __shared__ float4 smem4[];
  const int n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const int R = static_cast<int>(admm_fused::ring_width(n, kPacked));
  const int b = blockIdx.x, tid = threadIdx.x;
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem4);
  float* sm = reinterpret_cast<float*>(raw + factor_ring::kBarrierBytes);
  const factor_ring::Ring ring{sm, factor_ring::smem_addr(raw), stages,
                               band_rows * R};
  sm += static_cast<size_t>(stages) * ring.stage_floats;
  // (K, n) sweep plane, in shared memory unless the launcher gave a scratch
  float* xt = plane ? plane + static_cast<size_t>(b) * K * n : sm;
  float* r = plane ? sm : sm + K * n;            // (n) matvec input
  // packed mode: the warps' column partial sums, the row dots, the bands
  float* part = r + n;
  float* dots = part + (kPacked ? kWarps * n : 0);
  int* band_end = reinterpret_cast<int*>(dots + (kPacked ? n : 0));
  unsigned short* pi =
      reinterpret_cast<unsigned short*>(band_end +
                                        (kPacked ? admm_fused::kMaxBands : 0));
  unsigned short* pj = pi + P;
  float* c9s = reinterpret_cast<float*>(pj + P);  // the slot scalars

  // a block's floats: the packed triangle, or the whole block
  const size_t blk = kPacked ? static_cast<size_t>(packed_off(n, R))
                             : static_cast<size_t>(n) * n;
  const float* Xb = X + static_cast<size_t>(b) * K * blk;

  if (tid == 0) {
    factor_ring::init(ring, kWarps);
    if constexpr (kPacked) {
      // bands of whole packed rows that fill a stage (at least band_rows
      // rows each, so at most n / 2 <= kMaxBands of them)
      int nb = 0;
      for (int r0 = 0; r0 < n;) {
        int r1 = r0;
        while (r1 < n &&
               packed_off(r1 + 1, R) - packed_off(r0, R) <= ring.stage_floats)
          ++r1;
        band_end[nb++] = r1;
        r0 = r1;
      }
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: the factor stream, in the consumers' order
    factor_ring::Cursor cur{0, 0u};
    for (int it = 0; it < n_iters; ++it)
      for (int t = 0; t < 2 * K - 1; ++t) {
        const float* Xk = Xb + (t < K ? t : 2 * K - 2 - t) * blk;
        if constexpr (kPacked) {
          for (int bi = 0, r0 = 0; r0 < n; r0 = band_end[bi++])
            factor_ring::produce_span(
                ring, cur, Xk + packed_off(r0, R),
                packed_off(band_end[bi], R) - packed_off(r0, R));
        } else {
          factor_ring::produce_block(ring, cur, Xk, n, 0, n, band_rows);
        }
      }
    return;
  }

  // ---- consumer warps
  const size_t so = static_cast<size_t>(b) * K * 6 * n2;
  const size_t co = static_cast<size_t>(b) * K * P;
  const admm_rows::Scenario sc{
      eta + 2 * co, l_s + so, u_s + so, l_c + co, rho_s, rho_c,
      x + static_cast<size_t>(b) * K * n, zs + so, ys + so, zc + co, yc + co,
      fpar[0], fpar[1], fpar[2], fpar[3], K, N};
  const int warp = tid >> 5, lane = tid & 31;
  factor_ring::Cursor cur{0, 0u};

  // fn(i, (X_k r)_i) for every row i of the next block in the ring; fn's
  // writes need a barrier before they are read
  auto product = [&](auto fn) {
    if constexpr (kPacked) {
      float acc[kPackedRegs];
#pragma unroll
      for (int u = 0; u < kPackedRegs; ++u) acc[u] = 0.f;
      for (int bi = 0, r0 = 0; r0 < n; r0 = band_end[bi++]) {
        const float* M = factor_ring::acquire(ring, cur);
        packed_band(M, r0, band_end[bi], n, R, r, warp, dots, acc);
        factor_ring::release(ring, cur);
      }
#pragma unroll
      for (int u = 0; u < kPackedRegs; ++u) {
        if (32 * u >= n) break;
        if (32 * u + lane < n) part[warp * n + 32 * u + lane] = acc[u];
      }
      consumer_sync();
      for (int j = tid; j < n; j += kConsumers) {
        float s = dots[j];
        for (int w = 0; w < kWarps; ++w) s += part[w * n + j];
        fn(j, s);
      }
    } else {
      factor_ring::matvec_rows(ring, cur, r, n, 0, n, band_rows, false, warp,
                               kWarps, fn);
    }
  };

  admm_rows::fill_pair_table(pi, pj, N, tid, kConsumers);
  for (int i = tid; i < (K - 1) * 9; i += kConsumers) c9s[i] = C9[i];

  for (int it = 0; it < n_iters; ++it) {
    admm_rows::build_rhs(sc, xt, tid, kConsumers);
    consumer_sync();

    // ---- forward sweep: w_k = X_k (b_k - B_k w_{k-1}), over b_k
    for (int k = 0; k < K; ++k) {
      float* tk = xt + k * n;
      const float* c = c9s + (k > 0 ? k - 1 : 0) * 9;
      for (int j = tid; j < n; j += kConsumers)
        r[j] = k == 0 ? tk[j] : tk[j] - sweeps::slot_b(c, tk - n, j, n2);
      consumer_sync();
      product([&](int i, float d) { tk[i] = d; });
      consumer_sync();
    }

    // ---- backward sweep: xt_{K-1} = w_{K-1};
    //      xt_k = w_k - X_k (B_{k+1}^T xt_{k+1}), over w_k
    for (int k = K - 2; k >= 0; --k) {
      float* tk = xt + k * n;
      const float* c = c9s + k * 9;
      for (int j = tid; j < n; j += kConsumers)
        r[j] = sweeps::slot_bt(c, tk + n, j, n2);
      consumer_sync();
      product([&](int i, float d) { tk[i] -= d; });
      consumer_sync();
    }

    admm_rows::update_rows(sc, xt, pi, pj, tid, kConsumers);
    consumer_sync();
  }
}

}  // namespace

extern "C" {

// fpar (4,) = h, sigma, alpha, col_penalty; C9 (K-1, 9) upper-triangular
// slot scalars; X the symmetric block inverses: (B, K, 6N, 6N) whole, or,
// where `packed` is 1 (6N <= 512 only), their packed upper triangles
// (B, K, T) of ops/admm_fused.py pack_upper; eta (B, K, P, 2); l_s, u_s
// (B, K, 6, 2N) static-row bounds; l_c (B, K, P) collision lower bounds;
// rho_s (K, 6) and rho_c (K, P) batch-shared rho; x (B, K, 6N), zs, ys
// (B, K, 6, 2N) and zc, yc (B, K, P) are read and updated in place; plane
// (B, K, 6N) is the scratch of the sweep plane, or null where the plan
// keeps the plane in shared memory; (band_rows, stages) is the ring of the
// plan (ops/admm_fused.py fused_plan).  All float32, contiguous, X 16-byte
// aligned.  Returns the CUDA error code of the launch, or
// cudaErrorInvalidValue for arguments it cannot serve.
int admm_fused_x_f32(const float* fpar, const float* C9, const float* X,
                     const float* eta, const float* l_s, const float* u_s,
                     const float* l_c, const float* rho_s, const float* rho_c,
                     float* x, float* zs, float* ys, float* zc, float* yc,
                     float* plane, int B, int K, int N, int n_iters,
                     int band_rows, int stages, int packed,
                     cudaStream_t stream) {
  const long smem = admm_fused::plan_smem(B, K, N, n_iters, band_rows, stages,
                                          plane == nullptr, packed != 0,
                                          true);
  if (smem < 0 || (reinterpret_cast<size_t>(X) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = packed ? admm_fused_x_kernel<true>
                       : admm_fused_x_kernel<false>;
  const int err = admm_fused::allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<B, kThreads, smem, stream>>>(
      fpar, C9, X, eta, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc, yc, plane,
      K, N, n_iters, band_rows, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
