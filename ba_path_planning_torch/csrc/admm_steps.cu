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
// The rows lie as planes, as in the fused interval kernels
// (admm_fused_x.cu, admm_fused_l.cu, whose loop runs admm_rows.cuh): x
// (B, K, 6N), static rows (B, K, 6, 2N) in the slot order dyn_p, dyn_v,
// jerk, acc, vbox, pbox, collision rows (B, K, P).
//
// admm_rhs: bound by memory bandwidth (every row read once, b written
// once; at N = 20, K = 50, B = 512 0.17 GB, 0.051 ms at 3.35 TB/s).  A^T's
// collision term of vehicle v sums the N - 1 pair rows v belongs to; read
// where they lie, each pair term is read by the threads of both vehicles
// and both axes, and for half of them the threads of a warp read
// addresses about N floats apart.  So a block takes k_tile steps of one
// lane (ops/admm_steps.py rhs_plan: the static items fill its threads) in
// two phases around one barrier.  Phase A, a thread a collision row
// (k + 1, p) of the tile, coalesced along p: rho, z, y and eta read once,
// w = rho z - y formed once, the pair (i, j) in closed form, and the axis
// terms w eta written into a transposed pair table in shared memory, whose
// row (step, vehicle) holds the vehicle's N - 1 partner terms in ascending
// partner order: + in row i, - in row j.  Phase B, a thread a static row
// (k, q): the static rows read along q (rz of steps k - 1 .. k + 1, x), as
// admm_rows.cuh build_rhs_rows reads them, and the table row summed on
// consecutive entries in ascending partner order, the order and signs of
// build_rhs_rows' loop (no atomics: deterministic).  The table's rows lie
// an odd number of float2 apart, so the rows a warp reads at one slot fall
// on distinct banks.  Where one step's table does not fit shared memory (N
// > 170, up to the N = 1024 the grouped sweeps serve), the direct form runs
// on the same blocks: every thread of the block given static rows, the
// static part as the table form's, and the row's N - 1 pair terms read
// from global memory where they lie, summed in kRhsAcc interleaved partial
// sums joined pairwise.  In one serial sum the rounding of up to 1023
// terms left the grouped route at N = 1024 past 4x the plain version's
// distance from float64 (whose sum over the pairs is a blocked product);
// the partial sums also keep a chunk's loads of a thread in flight.
//
// admm_update: bound by memory bandwidth (each row read once or twice and
// written once, about 1 flop a byte; at N = 20, K = 50, B = 512 0.34 GB,
// 0.10 ms at 3.35 TB/s).  A block takes k_tile steps of one lane
// (ops/admm_steps.py update_plan) and a thread one item at a time: two
// neighbouring slots (k, s, q), (k, s, q + 1) of a static row, moved as
// float2, or a collision row (k, p), so that every thread does about the
// same few loads and stores, all of them coalesced along q or p.  The
// slots' thread computes their entries of A xt from xt's rows k - 1 ..
// k + 1 (the acc, vbox and pbox threads also relax their entries of x); a
// collision row's thread finds its pair (i, j) in closed form and reads
// the two positions at step k - 1.  No shared memory, no
// barrier; the reciprocals of rho instead of divisions, and the indices
// from a float reciprocal instead of integer division.  The rows are
// loaded and stored with the streaming cache hint: a call touches each
// once.
//
// admm_channel_interval: n_iters iterations of the collision-free phase-1
// QP in one launch.  Its route is defined by eta = 0 (JAX
// ba_path_planning_tpu/solvers/banded.py:1192-1202: phase 1 disables every
// collision row and keeps its loose rho through the k = 0 pattern with
// eta = 0), so for a finite state A's collision rows are exactly 0 and
// A^T's collision term is exactly 0: the kernel reads neither eta nor the
// pairs, and
//   * the static rows split into 2N B independent channels (lane, q), each
//     x (K, 3) and six static rows a step, on one shared 3x3
//     block-tridiagonal factor (Linv (K, 3, 3), Eb (K - 1, 3, 3), or one
//     set a lane under adaptive rho);
//   * each collision row is an elementwise recurrence with A xt = 0: zr =
//     (1 - alpha) z, the exact-penalty prox, y += rho (zr - z), read once
//     and written once, n_iters times in registers.
// What bounds it: operations.  25 iterations at N = 20, K = 50, B = 1024
// are 9.9 GFLOP in FP32, 0.15 ms at 67 TFLOP/s; the state read and written
// once, 0.58 GB with the collision rows, 0.17 ms.  Design: a warp a
// channel, its state held on the chip for the whole interval.  Thread t
// owns S consecutive steps (k = t S + j; S = 1 for K <= 32, 2 for K <= 64,
// in registers; above, S = ceil(K / 32) steps in shared memory, or in a
// global scratch where they do not fit: "the memory form", for the single
// CLI's K = 500 at B = 1).  Neighbouring steps come through warp shuffles.
// In the register form the two block sweeps are affine
// recurrences, y_k = M_k y_{k-1} + L_k b_k (M_k = -L_k E_{k-1}) forward and
// x_k = N_k x_{k+1} + L_k^T y_k (N_k = -L_k^T E_k^T) backward: each thread
// folds its own steps, a Kogge-Stone scan over the warp's 32 threads
// (5 levels) joins the folds, and each thread unfolds its steps from its
// neighbour's result.  The scan's matrices do not change within an
// interval, so a block builds them once (per lane under adaptive rho) into
// tables in shared memory, thread-fastest, beside L_k, M_k and N_k.  The
// memory form walks the sweeps serially in one thread a channel, as the
// plain version does: over its windows of up to 256 steps the scan
// reassociated too far (at K = 500 the y rows came 4.1x further from
// float64 than the plain float32 version's, against a bar of 4x).  A
// block holds W (4, 2 or 1) channels of one lane and loads and stores
// their planes through a staging buffer in shared memory, so that global
// accesses run along q; the grid is persistent (as many blocks as fit the
// SMs), taking the channel groups, then chunks of the collision rows.
// Plain FP32; the scans reassociate the sweeps' sums.

#include <cuda_runtime.h>

#include <algorithm>

#include "admm_rows.cuh"

namespace {

constexpr int kRowThreads = 256;      // admm_rhs, admm_update
constexpr long kSmemMax = 232448;
// admm_rhs and admm_update serve every N the grouped sweeps serve: n = 6N
// up to group_sweep.cuh kMaxNWide (ops/admm_steps.py ROW_STAGES_MAX_N)
constexpr int kRowStagesMaxN = 1024;
constexpr unsigned kFull = 0xffffffffu;

// i / d for 0 <= i < 2^22: the float quotient is within 1/2 of i / d, so
// truncating it and one correction give the integer quotient.
struct SmallDiv {
  int d;
  float inv;
  __device__ explicit SmallDiv(int d_)
      : d(d_), inv(1.f / static_cast<float>(d_)) {}
  __device__ __forceinline__ int operator()(int i) const {
    int q = __float2int_rz(static_cast<float>(i) * inv);
    const int r = i - q * d;
    return q + (r >= d) - (r < 0);
  }
};

// ---------------------------------------------------------------------------
// admm_rhs
// ---------------------------------------------------------------------------

// float2 entries between two rows of the transposed pair table: N - 1
// rounded up to an odd number (ops/admm_steps.py rhs_table_stride)
__host__ __device__ inline int rhs_table_stride(int N) {
  return N - (N - 1) % 2;
}

// Bytes of shared memory the table of k_tile steps takes (rhs_table_bytes)
__host__ __device__ inline long rhs_table_bytes(int k_tile, int N) {
  return 8L * k_tile * N * rhs_table_stride(N);
}

// What static row (k, q) adds to b before the collision term, in the order
// of build_rhs_rows' sums: b0 and b2 whole (scaled), b1 as (dp - dp_next +
// rz5) and sigma x apart, the collision term going between them.
struct RhsStatic {
  float b0, b1, sx1, b2;
};

__device__ __forceinline__ RhsStatic rhs_static(
    const float* __restrict__ rs, const float* __restrict__ zs,
    const float* __restrict__ ys, const float* __restrict__ xl, int k, int q,
    int K, int n2, float h, float sigma, float scale) {
  const float hh = 0.5f * h * h;
  auto rz = [&](int kk, int s) {
    const size_t o = (static_cast<size_t>(kk) * 6 + s) * n2 + q;
    return rs[kk * 6 + s] * zs[o] - ys[o];
  };
  const bool last = k == K - 1;
  const float dp = rz(k, 0), dv = rz(k, 1);
  const float jr = last ? 0.f : rz(k, 2);
  const float jr_prev = k > 0 ? rz(k - 1, 2) : 0.f;
  const float dp_next = last ? 0.f : rz(k + 1, 0);
  const float dv_next = last ? 0.f : rz(k + 1, 1);
  const float* xk = xl + static_cast<size_t>(k) * 3 * n2;
  RhsStatic st;
  st.b0 = (-hh * dp - h * dv + (jr_prev - jr) / h + rz(k, 3)
           + sigma * xk[q]) * scale;
  st.b1 = dp - dp_next + rz(k, 5);
  st.sx1 = sigma * xk[n2 + q];
  st.b2 = (-h * dp_next + dv - dv_next + rz(k, 4) + sigma * xk[2 * n2 + q])
          * scale;
  return st;
}

// The table form (the file's head): blocks of k_tile steps of one lane,
// the table of the tile's collision steps in dynamic shared memory.
__global__ void __launch_bounds__(kRowThreads)
    admm_rhs_table_kernel(const float* __restrict__ fpar,
                          const float* __restrict__ eta,
                          const float* __restrict__ rho_s,
                          const float* __restrict__ rho_c,
                          const float* __restrict__ inv_rho,
                          const float* __restrict__ x,
                          const float* __restrict__ zs,
                          const float* __restrict__ ys,
                          const float* __restrict__ zc,
                          const float* __restrict__ yc, float* __restrict__ b,
                          int K, int N, int k_tile, int n_tiles,
                          int rho_s_stride, int rho_c_stride) {
  extern __shared__ float2 rhs_table[];
  const int n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const int stride = rhs_table_stride(N);
  const int lane = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x - lane * n_tiles) * k_tile;
  const int steps = min(K, k0 + k_tile) - k0;
  // steps k of the tile with collision rows at k + 1
  const int col_steps = min(K - 1, k0 + k_tile) - k0;
  const float h = fpar[0], sigma = fpar[1];
  const float scale = inv_rho ? inv_rho[lane] : 1.f;
  const size_t so = static_cast<size_t>(lane) * K * 6 * n2;
  const float* rs = rho_s + static_cast<size_t>(lane) * rho_s_stride;
  const float* xl = x + static_cast<size_t>(lane) * K * n;
  float* bl = b + static_cast<size_t>(lane) * K * n;
  const int n_static = steps * n2;
  const SmallDiv by_n2(n2);
  // the static part of the thread's first row: its loads go out before
  // phase A's
  RhsStatic first{};
  if (threadIdx.x < n_static) {
    const int kk = by_n2(threadIdx.x);
    first = rhs_static(rs, zs + so, ys + so, xl, k0 + kk,
                       threadIdx.x - kk * n2, K, n2, h, sigma, scale);
  }
  // phase A: the collision rows (k0 + 1 .. k0 + col_steps, p), contiguous
  const size_t c0 = (static_cast<size_t>(lane) * K + k0 + 1) * P;
  const float* rc = rho_c + static_cast<size_t>(lane) * rho_c_stride
                    + static_cast<size_t>(k0 + 1) * P;
  const float2* et = reinterpret_cast<const float2*>(eta) + c0;
  const SmallDiv by_p(P > 0 ? P : 1);
  for (int c = threadIdx.x; c < col_steps * P; c += blockDim.x) {
    const float w = rc[c] * zc[c0 + c] - yc[c0 + c];
    const float2 e = et[c];
    const int kk = by_p(c), p = c - kk * P;
    const int i = admm_rows::pair_first(p, N);
    const int j = p - admm_rows::pair_base(i, N) + i + 1;
    float2* rows = rhs_table + static_cast<size_t>(kk) * N * stride;
    const float t0 = w * e.x, t1 = w * e.y;
    rows[i * stride + j - 1] = make_float2(t0, t1);
    rows[j * stride + i] = make_float2(-t0, -t1);
  }
  __syncthreads();
  // phase B: a thread a static row (k, q)
  for (int e = threadIdx.x; e < n_static; e += blockDim.x) {
    const int kk = by_n2(e), q = e - kk * n2, k = k0 + kk;
    const RhsStatic st =
        e == threadIdx.x ? first
                         : rhs_static(rs, zs + so, ys + so, xl, k, q, K, n2,
                                      h, sigma, scale);
    float col = 0.f;
    if (kk < col_steps) {
      // vehicle q / 2's row, axis q % 2
      const float* r = reinterpret_cast<const float*>(
                           rhs_table + (static_cast<size_t>(kk) * N + (q >> 1))
                                       * stride) + (q & 1);
#pragma unroll 4
      for (int s = 0; s < N - 1; ++s) col += r[2 * s];
    }
    float* bk = bl + static_cast<size_t>(k) * n;
    bk[q] = st.b0;
    bk[n2 + q] = (st.b1 + col + st.sx1) * scale;
    bk[2 * n2 + q] = st.b2;
  }
}

// The direct form's partial sums of a row's pair terms (a power of two;
// eight, with their operands staged, ran slower)
constexpr int kRhsAcc = 4;

// Vehicle v's collision term on axis c at one step: partners u < v (pair
// (u, v), sign -1) from u = 0 and partners u > v (pair (v, u), sign +1)
// from u = v + 1, each run's i-th term in partial sum i % kRhsAcc; the
// sums joined pairwise.  A run's whole chunks of kRhsAcc terms load all
// their operands before the sums take them (the loads issue together),
// its last chunk predicated.  rc, zc, yc: the step's collision rows (P),
// et its eta (P, 2).
__device__ __forceinline__ float rhs_pair_sum(const float* __restrict__ rc,
                                              const float* __restrict__ zc,
                                              const float* __restrict__ yc,
                                              const float* __restrict__ et,
                                              int v, int c, int N) {
  float acc[kRhsAcc] = {};
  auto below = [&](int u) { return admm_rows::pair_base(u, N) + v - u - 1; };
  const int pv = admm_rows::pair_base(v, N) - v - 1;
  float r[kRhsAcc], z[kRhsAcc], y[kRhsAcc], e[kRhsAcc];
  auto load = [&](int i, int p) {
    r[i] = rc[p]; z[i] = zc[p]; y[i] = yc[p]; e[i] = et[2 * p + c];
  };
  int u0 = 0;
  for (; u0 + kRhsAcc <= v; u0 += kRhsAcc) {
#pragma unroll
    for (int i = 0; i < kRhsAcc; ++i) load(i, below(u0 + i));
#pragma unroll
    for (int i = 0; i < kRhsAcc; ++i) acc[i] -= (r[i] * z[i] - y[i]) * e[i];
  }
#pragma unroll
  for (int i = 0; i < kRhsAcc; ++i)
    if (u0 + i < v) {
      load(i, below(u0 + i));
      acc[i] -= (r[i] * z[i] - y[i]) * e[i];
    }
  for (u0 = v + 1; u0 + kRhsAcc <= N; u0 += kRhsAcc) {
#pragma unroll
    for (int i = 0; i < kRhsAcc; ++i) load(i, pv + u0 + i);
#pragma unroll
    for (int i = 0; i < kRhsAcc; ++i) acc[i] += (r[i] * z[i] - y[i]) * e[i];
  }
#pragma unroll
  for (int i = 0; i < kRhsAcc; ++i)
    if (u0 + i < N) {
      load(i, pv + u0 + i);
      acc[i] += (r[i] * z[i] - y[i]) * e[i];
    }
#pragma unroll
  for (int w = kRhsAcc / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) acc[i] += acc[i + w];
  return acc[0];
}

// The direct form (170 < N <= 1024): blocks of k_tile steps of one lane, a
// thread a static row (k, q) at a time.
__global__ void __launch_bounds__(kRowThreads)
    admm_rhs_direct_kernel(const float* __restrict__ fpar,
                           const float* __restrict__ eta,
                           const float* __restrict__ rho_s,
                           const float* __restrict__ rho_c,
                           const float* __restrict__ inv_rho,
                           const float* __restrict__ x,
                           const float* __restrict__ zs,
                           const float* __restrict__ ys,
                           const float* __restrict__ zc,
                           const float* __restrict__ yc,
                           float* __restrict__ b, int K, int N, int k_tile,
                           int n_tiles, int rho_s_stride, int rho_c_stride) {
  const int n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const int lane = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x - lane * n_tiles) * k_tile;
  const int steps = min(K, k0 + k_tile) - k0;
  const float h = fpar[0], sigma = fpar[1];
  const float scale = inv_rho ? inv_rho[lane] : 1.f;
  const size_t so = static_cast<size_t>(lane) * K * 6 * n2;
  const size_t co = static_cast<size_t>(lane) * K * P;
  const float* rs = rho_s + static_cast<size_t>(lane) * rho_s_stride;
  const float* rcl = rho_c + static_cast<size_t>(lane) * rho_c_stride;
  const float* xl = x + static_cast<size_t>(lane) * K * n;
  float* bl = b + static_cast<size_t>(lane) * K * n;
  for (int e = threadIdx.x; e < steps * n2; e += blockDim.x) {
    const int kk = e / n2, q = e - kk * n2, k = k0 + kk;
    const RhsStatic st = rhs_static(rs, zs + so, ys + so, xl, k, q, K, n2, h,
                                    sigma, scale);
    float col = 0.f;
    if (k < K - 1) {
      // the collision rows at k + 1
      const size_t kp = static_cast<size_t>(k + 1) * P;
      col = rhs_pair_sum(rcl + kp, zc + co + kp, yc + co + kp,
                         eta + 2 * (co + kp), q >> 1, q & 1, N);
    }
    float* bk = bl + static_cast<size_t>(k) * n;
    bk[q] = st.b0;
    bk[n2 + q] = (st.b1 + col + st.sx1) * scale;
    bk[2 * n2 + q] = st.b2;
  }
}

// ---------------------------------------------------------------------------
// admm_update
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// the same with the streaming (evict-first) cache hint: admm_update touches
// each row once a call
__device__ __forceinline__ float2 ldcs2(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ void stcs2(float* p, float2 v) {
  __stcs(reinterpret_cast<float2*>(p), v);
}

__global__ void __launch_bounds__(kRowThreads)
    admm_update_kernel(const float* __restrict__ fpar,
                       const float* __restrict__ eta,
                       const float* __restrict__ l_s,
                       const float* __restrict__ u_s,
                       const float* __restrict__ l_c,
                       const float* __restrict__ rho_s,
                       const float* __restrict__ rho_c,
                       const float* __restrict__ xt, float* __restrict__ x,
                       float* __restrict__ zs, float* __restrict__ ys,
                       float* __restrict__ zc, float* __restrict__ yc, int K,
                       int N, int k_tile, int n_tiles, int rho_s_stride,
                       int rho_c_stride) {
  const int n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const int lane = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x - lane * n_tiles) * k_tile;
  const int steps = min(K, k0 + k_tile) - k0;
  const float h = fpar[0], alpha = fpar[2], lam = fpar[3];
  const float oma = 1.f - alpha, hh = 0.5f * h * h, ih = 1.f / h;
  // the block's rows: k0 .. k0 + steps - 1 of the lane's planes
  const size_t so = (static_cast<size_t>(lane) * K + k0) * 6 * n2;
  const size_t co = (static_cast<size_t>(lane) * K + k0) * P;
  const float* xl = xt + static_cast<size_t>(lane) * K * n;
  float* xb = x + static_cast<size_t>(lane) * K * n;
  const float* rs = rho_s + static_cast<size_t>(lane) * rho_s_stride;
  const float* rc = rho_c + static_cast<size_t>(lane) * rho_c_stride;
  const SmallDiv by_n(N), by_p(P > 0 ? P : 1);
  // a static item is a pair of slots (k, s, q), (k, s, q + 1), q even
  const int n_static = steps * 6 * N, n_all = n_static + steps * P;
  for (int e = threadIdx.x; e < n_all; e += blockDim.x) {
    if (e < n_static) {
      const int r = by_n(e), q = 2 * (e - r * N), kk = r / 6, s = r - 6 * kk;
      const int k = k0 + kk;
      if (s == 2 && k == K - 1) continue;   // no jerk row at K - 1
      const float* t = xl + static_cast<size_t>(k) * n;
      const float2 zero = make_float2(0.f, 0.f);
      float2 ax, xv = zero;
      int xs = -1;                          // the slot of x to relax
      switch (s) {
        case 0: {
          const float2 pp = k > 0 ? ld2(t + n2 + q - n) : zero;
          const float2 vp = k > 0 ? ld2(t + 2 * n2 + q - n) : zero;
          const float2 pt = ld2(t + n2 + q), at = ld2(t + q);
          ax.x = pt.x - pp.x - h * vp.x - hh * at.x;
          ax.y = pt.y - pp.y - h * vp.y - hh * at.y;
          break;
        }
        case 1: {
          const float2 vp = k > 0 ? ld2(t + 2 * n2 + q - n) : zero;
          const float2 vt = ld2(t + 2 * n2 + q), at = ld2(t + q);
          ax.x = vt.x - vp.x - h * at.x;
          ax.y = vt.y - vp.y - h * at.y;
          break;
        }
        case 2: {
          const float2 an = ld2(t + n + q), at = ld2(t + q);
          ax.x = (an.x - at.x) * ih;
          ax.y = (an.y - at.y) * ih;
          break;
        }
        case 3:
          ax = xv = ld2(t + q);
          xs = 0;
          break;
        case 4:
          ax = xv = ld2(t + 2 * n2 + q);
          xs = 2;
          break;
        default:
          ax = xv = ld2(t + n2 + q);
          xs = 1;
      }
      const size_t o = so + 2 * e;
      const float rho = rs[k * 6 + s], irho = __frcp_rn(rho);
      const float2 z = ldcs2(zs + o), y = ldcs2(ys + o);
      const float2 lo = ldcs2(l_s + o), hi = ldcs2(u_s + o);
      const float zr0 = alpha * ax.x + oma * z.x;
      const float zr1 = alpha * ax.y + oma * z.y;
      const float zn0 = fminf(fmaxf(zr0 + y.x * irho, lo.x), hi.x);
      const float zn1 = fminf(fmaxf(zr1 + y.y * irho, lo.y), hi.y);
      stcs2(ys + o, make_float2(y.x + rho * (zr0 - zn0),
                                y.y + rho * (zr1 - zn1)));
      stcs2(zs + o, make_float2(zn0, zn1));
      if (xs >= 0) {
        float* xo = xb + static_cast<size_t>(k) * n + xs * n2 + q;
        const float2 xp = ld2(xo);
        st2(xo, make_float2(alpha * xv.x + oma * xp.x,
                            alpha * xv.y + oma * xp.y));
      }
    } else {
      // collision row (k, p)
      const int c = e - n_static, kk = by_p(c), p = c - kk * P;
      const int k = k0 + kk;
      const size_t o = co + c;
      float colv = 0.f;
      if (k > 0) {
        const float* pos = xl + static_cast<size_t>(k - 1) * n + n2;
        const int i = admm_rows::pair_first(p, N);
        const int j = p - admm_rows::pair_base(i, N) + i + 1;
        const float2 et = ldcs2(eta + 2 * o);
        colv = et.x * (pos[2 * i] - pos[2 * j])
               + et.y * (pos[2 * i + 1] - pos[2 * j + 1]);
      }
      const float rho = __ldcs(rc + k * P + p), irho = __frcp_rn(rho);
      const float zr = alpha * colv + oma * __ldcs(zc + o);
      const float yv = __ldcs(yc + o);
      const float w = zr + yv * irho;
      const float lb = __ldcs(l_c + o);
      const float zn = w >= lb ? w : fminf(w + lam * irho, lb);
      __stcs(yc + o, yv + rho * (zr - zn));
      __stcs(zc + o, zn);
    }
  }
}

// ---------------------------------------------------------------------------
// admm_channel_interval
// ---------------------------------------------------------------------------

namespace chan {

constexpr int kWarp = 32;
constexpr int kLevels = 5;          // the warp scans' levels, log2(32)
constexpr int kColItems = 8;        // collision rows a thread of a chunk
// Fields of one step of a thread's channel: x (a, p, v); the six static
// rows' z, y, lower and upper bounds, rho and 1 / rho; the sweep vector v
// (b, then the forward sweep's y, then xt).
enum { FX = 0, FZ = 3, FY = 9, FL = 15, FU = 21, FR = 27, FI = 33, FV = 39,
       NF = 42 };
// The tables hold 3x3 matrices, row-major, a thread's entries 0-7 as two
// float4 and its entry 8 apart: L_k, M_k, N_k a step, then the forward and
// backward scans' matrices, one a level each.
constexpr int kTabStep = 3, kTabScan = 2 * kLevels;

// A thread's steps in registers (S steps; every loop over them unrolls).
template <int S_>
struct RegSteps {
  static constexpr int S = S_;
  static constexpr bool kScan = true;     // the sweeps by the warp scan
  float f[S_][NF];
  __device__ __forceinline__ float& operator()(int j, int e) {
    return f[j][e];
  }
};

// ... or in memory: this thread's first float, the warp's 32 threads
// side by side so that a warp's access falls on 32 banks.
struct MemSteps {
  static constexpr bool kScan = false;    // the sweeps serial, by thread 0
  float* p;
  int S;
  __device__ __forceinline__ float& operator()(int j, int e) {
    return p[(j * NF + e) * kWarp];
  }
};

// The block's tables of nm matrices: matrix m of this thread has its
// entries 0-7 at q[2 kWarp m] and q[2 kWarp m + kWarp] (a warp's loads of
// one float4 fall on all banks) and entry 8 at e[kWarp m].
struct Mat {
  float4* q;
  float* e;
};

struct Tab {
  float4* q;     // this thread's first float4
  float* e;      // this thread's first entry 8
  int S;
  __device__ __forceinline__ Mat at(int m) const {
    return Mat{q + 2 * kWarp * m, e + kWarp * m};
  }
  __device__ __forceinline__ Mat L(int j) const { return at(kTabStep * j); }
  __device__ __forceinline__ Mat M(int j) const {
    return at(kTabStep * j + 1);
  }
  __device__ __forceinline__ Mat Nm(int j) const {
    return at(kTabStep * j + 2);
  }
  __device__ __forceinline__ Mat Af(int l) const {
    return at(kTabStep * S + l);
  }
  __device__ __forceinline__ Mat Ab(int l) const {
    return at(kTabStep * S + kLevels + l);
  }
};

struct Args {
  const float *fpar, *Linv, *Eb, *l_s, *u_s, *l_c, *rho_s, *rho_c;
  float *x, *zs, *ys, *zc, *yc, *scratch;
  int B, K, N, n_iters, rho_s_stride, rho_c_stride, lane_factors;
  int W, lw;                 // channels (warps) a block, log2 W
  int groups_per_lane, chan_groups, col_groups;
  long region_floats;        // tables + staging (+ the memory form's steps)
};

// A 3x3 matrix of the tables, row-major in registers.
struct M3 {
  float a[9];
};

__device__ __forceinline__ M3 ldm(const Mat& m) {
  const float4 q0 = m.q[0], q1 = m.q[kWarp];
  return M3{{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, m.e[0]}};
}

__device__ __forceinline__ void stm(const float* a, const Mat& m) {
  m.q[0] = make_float4(a[0], a[1], a[2], a[3]);
  m.q[kWarp] = make_float4(a[4], a[5], a[6], a[7]);
  m.e[0] = a[8];
}

// o = m v + a
__device__ __forceinline__ void mv_add(const M3& m, const float* v,
                                       const float* a, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = m.a[3 * r] * v[0] + m.a[3 * r + 1] * v[1] + m.a[3 * r + 2] * v[2]
           + a[r];
}

// o = m v
__device__ __forceinline__ void mv(const M3& m, const float* v, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = m.a[3 * r] * v[0] + m.a[3 * r + 1] * v[1] + m.a[3 * r + 2] * v[2];
}

// o = m^T v
__device__ __forceinline__ void mtv(const M3& m, const float* v, float* o) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[c] = m.a[c] * v[0] + m.a[3 + c] * v[1] + m.a[6 + c] * v[2];
}

// o = a b, 3x3 row-major in registers (o may not alias a or b)
__device__ __forceinline__ void mm(const float* a, const float* b, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[3 * r + c] = a[3 * r] * b[c] + a[3 * r + 1] * b[3 + c]
                     + a[3 * r + 2] * b[6 + c];
}

// The tables of one set of factors (L (K, 3, 3), E (K - 1, 3, 3)), by the
// 32 threads of one warp.  Steps past K - 1 pass their input through
// (L = 0, M = N = I), so that every thread folds S steps.
__device__ void build_tables(const Tab& tb, const float* __restrict__ L,
                             const float* __restrict__ E, int K, int t) {
  for (int j = 0; j < tb.S; ++j) {
    const int k = t * tb.S + j;
    float l[9], m[9], nm[9];
    if (k < K) {
#pragma unroll
      for (int e = 0; e < 9; ++e) l[e] = L[9 * k + e];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float mr = 0.f, nr = 0.f;
          if (k > 0) {               // M_k = -L_k E_{k-1}
            const float* ep = E + 9 * (k - 1);
            mr = -(l[3 * r] * ep[c] + l[3 * r + 1] * ep[3 + c]
                   + l[3 * r + 2] * ep[6 + c]);
          }
          if (k < K - 1) {           // N_k = -L_k^T E_k^T
            const float* en = E + 9 * k;
            nr = -(l[r] * en[3 * c] + l[3 + r] * en[3 * c + 1]
                   + l[6 + r] * en[3 * c + 2]);
          }
          m[3 * r + c] = mr;
          nm[3 * r + c] = nr;
        }
    } else {
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        l[e] = 0.f;
        m[e] = nm[e] = (e % 4 == 0) ? 1.f : 0.f;
      }
    }
    stm(l, tb.L(j));
    stm(m, tb.M(j));
    stm(nm, tb.Nm(j));
  }
  __syncwarp();
  // forward: the thread's map A = M_last ... M_first, then the scan's
  float a[9], p[9], o[9];
  M3 q = ldm(tb.M(0));
#pragma unroll
  for (int e = 0; e < 9; ++e) a[e] = q.a[e];
  for (int j = 1; j < tb.S; ++j) {
    q = ldm(tb.M(j));
    mm(q.a, a, o);
#pragma unroll
    for (int e = 0; e < 9; ++e) a[e] = o[e];
  }
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const int off = 1 << lv;
#pragma unroll
    for (int e = 0; e < 9; ++e) p[e] = __shfl_up_sync(kFull, a[e], off);
    stm(a, tb.Af(lv));
    if (t >= off) {
      mm(a, p, o);
#pragma unroll
      for (int e = 0; e < 9; ++e) a[e] = o[e];
    }
  }
  // backward: N_first ... N_last, then the scan's
  q = ldm(tb.Nm(tb.S - 1));
#pragma unroll
  for (int e = 0; e < 9; ++e) a[e] = q.a[e];
  for (int j = tb.S - 2; j >= 0; --j) {
    q = ldm(tb.Nm(j));
    mm(q.a, a, o);
#pragma unroll
    for (int e = 0; e < 9; ++e) a[e] = o[e];
  }
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const int off = 1 << lv;
#pragma unroll
    for (int e = 0; e < 9; ++e) p[e] = __shfl_down_sync(kFull, a[e], off);
    stm(a, tb.Ab(lv));
    if (t + off < kWarp) {
      mm(a, p, o);
#pragma unroll
      for (int e = 0; e < 9; ++e) a[e] = o[e];
    }
  }
}

// rho z - y of step j, slot s
template <class St>
__device__ __forceinline__ float rz(St& st, int j, int s) {
  return st(j, FR + s) * st(j, FZ + s) - st(j, FY + s);
}

struct Scalars {
  float h, sigma, alpha, oma, hh, ih;
};

// The warp's suffix scan of the backward maps x_first = B_t x_after + d
// (B_t the thread's N_first ... N_last, then the tables' windows), on d.
__device__ __forceinline__ void backward_scan(const Tab& tb, int t,
                                              float* d) {
  float u[3], o[3];
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const int off = 1 << lv;
#pragma unroll
    for (int r = 0; r < 3; ++r) u[r] = __shfl_down_sync(kFull, d[r], off);
    if (t + off < kWarp) {
      mv_add(ldm(tb.Ab(lv)), u, d, o);
      d[0] = o[0], d[1] = o[1], d[2] = o[2];
    }
  }
}

// The sweeps by the warp scan (the register form): b in v on entry, xt =
// M^{-1} b on exit.  The backward boundaries are refined once: the
// inconsistency of each thread's first step, computed from its
// neighbour's boundary, with its own boundary is scanned with the same
// maps and the steps corrected, so that neighbouring steps agree to the
// rounding of a serial sweep (A xt takes their differences).
template <class St>
__device__ __forceinline__ void scan_sweeps(St& st, const Tab& tb, int t) {
  const int S = st.S;
  float d[3], u[3], o[3];
  // c = L b
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float bj[3] = {st(j, FV), st(j, FV + 1), st(j, FV + 2)};
    mv(ldm(tb.L(j)), bj, o);
    st(j, FV) = o[0];
    st(j, FV + 1) = o[1];
    st(j, FV + 2) = o[2];
  }
  // forward sweep y_k = M_k y_{k-1} + c_k: fold, scan, unfold
  d[0] = st(0, FV), d[1] = st(0, FV + 1), d[2] = st(0, FV + 2);
#pragma unroll
  for (int j = 1; j < S; ++j) {
    const float cj[3] = {st(j, FV), st(j, FV + 1), st(j, FV + 2)};
    mv_add(ldm(tb.M(j)), d, cj, o);
    d[0] = o[0], d[1] = o[1], d[2] = o[2];
  }
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const int off = 1 << lv;
#pragma unroll
    for (int r = 0; r < 3; ++r) u[r] = __shfl_up_sync(kFull, d[r], off);
    if (t >= off) {
      mv_add(ldm(tb.Af(lv)), u, d, o);
      d[0] = o[0], d[1] = o[1], d[2] = o[2];
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u[r] = __shfl_up_sync(kFull, d[r], 1);
    if (t == 0) u[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float cj[3] = {st(j, FV), st(j, FV + 1), st(j, FV + 2)};
    mv_add(ldm(tb.M(j)), u, cj, o);
    // g = L^T y
    mtv(ldm(tb.L(j)), o, u);
    st(j, FV) = u[0];
    st(j, FV + 1) = u[1];
    st(j, FV + 2) = u[2];
    u[0] = o[0], u[1] = o[1], u[2] = o[2];
  }
  // backward sweep x_k = N_k x_{k+1} + g_k: fold, scan, unfold
  d[0] = st(S - 1, FV), d[1] = st(S - 1, FV + 1), d[2] = st(S - 1, FV + 2);
#pragma unroll
  for (int j = S - 2; j >= 0; --j) {
    const float gj[3] = {st(j, FV), st(j, FV + 1), st(j, FV + 2)};
    mv_add(ldm(tb.Nm(j)), d, gj, o);
    d[0] = o[0], d[1] = o[1], d[2] = o[2];
  }
  backward_scan(tb, t, d);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u[r] = __shfl_down_sync(kFull, d[r], 1);
    if (t == kWarp - 1) u[r] = 0.f;
  }
#pragma unroll
  for (int j = S - 1; j >= 0; --j) {
    const float gj[3] = {st(j, FV), st(j, FV + 1), st(j, FV + 2)};
    mv_add(ldm(tb.Nm(j)), u, gj, o);
    st(j, FV) = o[0];
    st(j, FV + 1) = o[1];
    st(j, FV + 2) = o[2];
    u[0] = o[0], u[1] = o[1], u[2] = o[2];
  }
  // refinement: the first step's excess over the boundary, scanned
#pragma unroll
  for (int r = 0; r < 3; ++r) d[r] = u[r] - d[r];
  backward_scan(tb, t, d);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u[r] = __shfl_down_sync(kFull, d[r], 1);
    if (t == kWarp - 1) u[r] = 0.f;
  }
#pragma unroll
  for (int j = S - 1; j >= 0; --j) {
    mv(ldm(tb.Nm(j)), u, o);
    st(j, FV) += o[0];
    st(j, FV + 1) += o[1];
    st(j, FV + 2) += o[2];
    u[0] = o[0], u[1] = o[1], u[2] = o[2];
  }
}

// The sweeps of the memory form: thread 0 walks k as
// banded.solve_factorized_channel does (a scan over windows of up to
// K / 2 steps lost accuracy at K = 500), y_k = L_k (b_k - E_{k-1} y_{k-1}),
// x_k = L_k^T (y_k - E_k^T x_{k+1}), on the factors L (K, 3, 3), E
// (K - 1, 3, 3) of the lane; v of step k = t S + j belongs to thread t.
__device__ __forceinline__ void serial_sweeps(MemSteps& st, int t, int K,
                                              const float* __restrict__ L,
                                              const float* __restrict__ E) {
  __syncwarp();
  if (t == 0) {
    float* p0 = st.p;               // thread 0's floats; thread t's at + t
    const int S = st.S;
    float y0 = 0.f, y1 = 0.f, y2 = 0.f;
    for (int k = 0; k < K; ++k) {
      float* v = p0 + ((k % S) * NF + FV) * kWarp + k / S;
      float r0 = v[0], r1 = v[kWarp], r2 = v[2 * kWarp];
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
      v[0] = y0;
      v[kWarp] = y1;
      v[2 * kWarp] = y2;
    }
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    for (int k = K - 1; k >= 0; --k) {
      float* v = p0 + ((k % S) * NF + FV) * kWarp + k / S;
      float r0 = v[0], r1 = v[kWarp], r2 = v[2 * kWarp];
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
      v[0] = x0;
      v[kWarp] = x1;
      v[2 * kWarp] = x2;
    }
  }
  __syncwarp();
}

// One ADMM iteration of the warp's channel (thread t, steps t S + j); L, E
// the lane's factors (read by the memory form's sweeps).
template <class St>
__device__ __forceinline__ void iterate(St& st, const Tab& tb, int t, int K,
                                        const Scalars& c,
                                        const float* __restrict__ L,
                                        const float* __restrict__ E) {
  const int S = st.S;
  // b = A^T (rho z - y) + sigma x into v
  const float jr_in = __shfl_up_sync(kFull, rz(st, S - 1, 2), 1);
  const float dp_in = __shfl_down_sync(kFull, rz(st, 0, 0), 1);
  const float dv_in = __shfl_down_sync(kFull, rz(st, 0, 1), 1);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = t * S + j;
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
    if (k < K) {
      const bool last = k == K - 1;
      const float dp = rz(st, j, 0), dv = rz(st, j, 1);
      const float jr = last ? 0.f : rz(st, j, 2);
      const float jr_prev = k == 0 ? 0.f : j > 0 ? rz(st, j - 1, 2) : jr_in;
      const float dp_next = last ? 0.f : j + 1 < S ? rz(st, j + 1, 0) : dp_in;
      const float dv_next = last ? 0.f : j + 1 < S ? rz(st, j + 1, 1) : dv_in;
      b0 = -c.hh * dp - c.h * dv + (jr_prev - jr) * c.ih + rz(st, j, 3)
           + c.sigma * st(j, FX);
      b1 = dp - dp_next + rz(st, j, 5) + c.sigma * st(j, FX + 1);
      b2 = -c.h * dp_next + dv - dv_next + rz(st, j, 4)
           + c.sigma * st(j, FX + 2);
    }
    st(j, FV) = b0;
    st(j, FV + 1) = b1;
    st(j, FV + 2) = b2;
  }
  if constexpr (St::kScan)
    scan_sweeps(st, tb, t);
  else
    serial_sweeps(st, t, K, L, E);
  // relaxation, A xt, clip and dual step on the static rows; x relaxed
  const float p_in = __shfl_up_sync(kFull, st(S - 1, FV + 1), 1);
  const float v_in = __shfl_up_sync(kFull, st(S - 1, FV + 2), 1);
  const float a_in = __shfl_down_sync(kFull, st(0, FV), 1);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int k = t * S + j;
    if (k >= K) continue;
    const float at = st(j, FV), pt = st(j, FV + 1), vt = st(j, FV + 2);
    const float pp = k == 0 ? 0.f : j > 0 ? st(j - 1, FV + 1) : p_in;
    const float vp = k == 0 ? 0.f : j > 0 ? st(j - 1, FV + 2) : v_in;
    const float an = j + 1 < S ? st(j + 1, FV) : a_in;
    float ax[6];
    ax[0] = pt - pp - c.h * vp - c.hh * at;
    ax[1] = vt - vp - c.h * at;
    ax[2] = k < K - 1 ? (an - at) * c.ih : 0.f;
    ax[3] = at;
    ax[4] = vt;
    ax[5] = pt;
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      if (s == 2 && k == K - 1) continue;     // no jerk row at K-1
      const float zr = c.alpha * ax[s] + c.oma * st(j, FZ + s);
      const float yv = st(j, FY + s);
      const float zn = fminf(fmaxf(zr + yv * st(j, FI + s), st(j, FL + s)),
                             st(j, FU + s));
      st(j, FY + s) = yv + st(j, FR + s) * (zr - zn);
      st(j, FZ + s) = zn;
    }
    st(j, FX) = c.alpha * at + c.oma * st(j, FX);
    st(j, FX + 1) = c.alpha * pt + c.oma * st(j, FX + 1);
    st(j, FX + 2) = c.alpha * vt + c.oma * st(j, FX + 2);
  }
}

// Rows (k, s) of the block's W channels q0 .. q0 + nq - 1 of one plane
// (rows of n2 floats, NS of them a step) through the staging buffer:
// rows of W floats, one float of padding a step.
template <int NS>
__device__ __forceinline__ int stage_at(int k, int s, int w, int W) {
  return k * (NS * W + 1) + s * W + w;
}

template <int F, int NS, class St>
__device__ __forceinline__ void load_plane(St& st, const float* src,
                                           float* stage, const Args& a,
                                           int q0, int nq, int w, int t) {
  const int n2 = 2 * a.N, rows = a.K * NS;
  __syncthreads();
  for (int i = threadIdx.x; i < (rows << a.lw); i += blockDim.x) {
    const int cq = i & (a.W - 1), r = i >> a.lw;
    if (cq < nq) {
      const int k = r / NS;
      stage[stage_at<NS>(k, r - k * NS, cq, a.W)] =
          src[static_cast<size_t>(r) * n2 + q0 + cq];
    }
  }
  __syncthreads();
  if (w >= nq) return;
#pragma unroll
  for (int j = 0; j < st.S; ++j) {
    const int k = t * st.S + j;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      st(j, F + s) = k < a.K ? stage[stage_at<NS>(k, s, w, a.W)] : 0.f;
  }
}

template <int F, int NS, class St>
__device__ __forceinline__ void store_plane(St& st, float* dst, float* stage,
                                            const Args& a, int q0, int nq,
                                            int w, int t) {
  const int n2 = 2 * a.N, rows = a.K * NS;
  __syncthreads();
  if (w < nq) {
#pragma unroll
    for (int j = 0; j < st.S; ++j) {
      const int k = t * st.S + j;
      if (k >= a.K) continue;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        stage[stage_at<NS>(k, s, w, a.W)] = st(j, F + s);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (rows << a.lw); i += blockDim.x) {
    const int cq = i & (a.W - 1), r = i >> a.lw;
    if (cq < nq) {
      const int k = r / NS;
      dst[static_cast<size_t>(r) * n2 + q0 + cq] =
          stage[stage_at<NS>(k, r - k * NS, cq, a.W)];
    }
  }
}

// One group: the block's W channels of lane `lane` for the whole interval.
template <class St>
__device__ __forceinline__ void run_group(St& st, const Tab& tb,
                                          float* stage, const Args& a,
                                          const Scalars& c, int lane, int q0,
                                          int nq, int w, int t) {
  const size_t lf = a.lane_factors ? lane : 0;
  const float* L = a.Linv + lf * 9 * a.K;
  const float* E = a.Eb + lf * 9 * (a.K - 1);
  const size_t xo = static_cast<size_t>(lane) * a.K * 6 * a.N;
  const size_t so = 2 * xo;
  load_plane<FX, 3>(st, a.x + xo, stage, a, q0, nq, w, t);
  load_plane<FZ, 6>(st, a.zs + so, stage, a, q0, nq, w, t);
  load_plane<FY, 6>(st, a.ys + so, stage, a, q0, nq, w, t);
  load_plane<FL, 6>(st, a.l_s + so, stage, a, q0, nq, w, t);
  load_plane<FU, 6>(st, a.u_s + so, stage, a, q0, nq, w, t);
  if (w < nq) {
    const float* rs = a.rho_s + static_cast<size_t>(lane) * a.rho_s_stride;
#pragma unroll
    for (int j = 0; j < st.S; ++j) {
      const int k = t * st.S + j;
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const float r = k < a.K ? rs[6 * k + s] : 1.f;
        st(j, FR + s) = r;
        st(j, FI + s) = 1.f / r;
      }
    }
    for (int it = 0; it < a.n_iters; ++it)
      iterate(st, tb, t, a.K, c, L, E);
  }
  store_plane<FX, 3>(st, a.x + xo, stage, a, q0, nq, w, t);
  store_plane<FZ, 6>(st, a.zs + so, stage, a, q0, nq, w, t);
  store_plane<FY, 6>(st, a.ys + so, stage, a, q0, nq, w, t);
}

// Chunk `chunk` of the collision rows (B, K, P), flattened: each row's
// n_iters steps of the prox and dual update with A xt = 0.
__device__ __forceinline__ void collision_chunk(const Args& a, int chunk,
                                                float oma, float lam) {
  const int KP = a.K * (a.N * (a.N - 1) / 2), total = a.B * KP;
  const int base = chunk * blockDim.x * kColItems + threadIdx.x;
  for (int i = 0; i < kColItems; ++i) {
    const int idx = base + i * blockDim.x;
    if (idx >= total) return;
    const int lane = idx / KP;
    const float rho = a.rho_c[static_cast<size_t>(lane) * a.rho_c_stride
                              + (idx - lane * KP)];
    const float irho = 1.f / rho, lr = lam * irho, lb = a.l_c[idx];
    float z = a.zc[idx], y = a.yc[idx];
    for (int it = 0; it < a.n_iters; ++it) {
      const float zr = oma * z, w = zr + y * irho;
      const float zn = w >= lb ? w : fminf(w + lr, lb);
      y = y + rho * (zr - zn);
      z = zn;
    }
    a.zc[idx] = z;
    a.yc[idx] = y;
  }
}

// S > 0: S steps a thread in registers (K <= 32 S), the tables and the
// staging buffer in shared memory; S = 0: the memory form, ceil(K / 32)
// steps a thread and the staging buffer in the block's region (no tables),
// which lies in shared memory, or in a.scratch (a region a block) where it
// does not fit.
template <int S>
__global__ void __launch_bounds__(256, 2) admm_channel_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* region = reinterpret_cast<float*>(smem4);
  if constexpr (S == 0) {
    if (a.scratch) region = a.scratch + blockIdx.x * a.region_floats;
  }
  const int Sd = S > 0 ? S : (a.K + kWarp - 1) / kWarp;
  const int t = threadIdx.x & (kWarp - 1), w = threadIdx.x / kWarp;
  // the register form's tables: nm matrices, 8 floats each a thread, then
  // their entries 8
  const int nm = kTabStep * Sd + kTabScan;
  const Tab tb{reinterpret_cast<float4*>(region) + t, region + 8 * kWarp * nm
               + t, Sd};
  float* stage = region + (S > 0 ? 9 * kWarp * nm : 0);
  const float h = a.fpar[0], alpha = a.fpar[2];
  const Scalars c{h, a.fpar[1], alpha, 1.f - alpha, 0.5f * h * h, 1.f / h};
  int tab_lane = -1;
  for (int g = blockIdx.x; g < a.chan_groups + a.col_groups;
       g += gridDim.x) {
    if (g >= a.chan_groups) {
      collision_chunk(a, g - a.chan_groups, c.oma, a.fpar[3]);
      continue;
    }
    const int lane = g / a.groups_per_lane;
    const int q0 = (g - lane * a.groups_per_lane) * a.W;
    const int nq = min(a.W, 2 * a.N - q0);
    if constexpr (S > 0) {
      if (tab_lane < 0 || (a.lane_factors && lane != tab_lane)) {
        __syncthreads();        // the table's readers are done
        if (w == 0) {
          const size_t lf = a.lane_factors ? lane : 0;
          build_tables(tb, a.Linv + lf * 9 * a.K, a.Eb + lf * 9 * (a.K - 1),
                       a.K, t);
        }
        tab_lane = lane;        // load_plane's barrier publishes it
      }
      RegSteps<S> st;
      run_group(st, tb, stage, a, c, lane, q0, nq, w, t);
    } else {
      float* mem = stage + a.K * (6 * a.W + 1);
      MemSteps st{mem + w * Sd * NF * kWarp + t, Sd};
      run_group(st, tb, stage, a, c, lane, q0, nq, w, t);
    }
  }
}

}  // namespace chan

template <typename Kernel>
int allow_smem(Kernel kernel, long smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The shapes admm_rhs and admm_update serve (ops/admm_steps.py
// row_stages_serve): N up to kRowStagesMaxN, and a lane's K (6N + P)
// static slots and collision rows within int indexing (k * P + p, k * n,
// a block's row indices; K <= 4052 at N = 1024).
bool row_args_ok(int B, int K, int N, int k_tile) {
  return B >= 1 && K >= 2 && N >= 1 && N <= kRowStagesMaxN && k_tile >= 1 &&
         K * (6L * N + N * (N - 1L) / 2) < (1L << 31);
}

// Floats of one admm_channel_interval block's region: the staging buffer
// and the tables of the register form (steps 1, 2), or the staging buffer
// and the steps of its `warps` channels in the memory form (steps 0).
long admm_channel_region_floats(int K, int warps, int steps) {
  const long stage = static_cast<long>(K) * (6 * warps + 1);
  if (steps > 0)
    return stage + 9 * chan::kWarp * (chan::kTabStep * steps + chan::kTabScan);
  const long Sd = (K + chan::kWarp - 1) / chan::kWarp;
  return stage + static_cast<long>(warps) * chan::kWarp * chan::NF * Sd;
}

// The persistent grid of the channel kernel S: as many blocks as fit the
// SMs, at most `max_blocks` and the groups.
template <int S>
int launch_channel(const chan::Args& a, long smem, int max_blocks,
                   cudaStream_t stream) {
  auto kernel = chan::admm_channel_kernel<S>;
  int err = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, chan::kWarp * a.W, smem));
  if (err) return err;
  const long groups = static_cast<long>(a.chan_groups) + a.col_groups;
  const long fit = std::max(1L, 1L * per_sm * sms);
  const long grid = std::min(groups, std::min(1L * max_blocks, fit));
  kernel<<<static_cast<int>(grid), chan::kWarp * a.W, a.scratch ? 0 : smem,
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// b (B, K, 6N) = A^T (rho z - y) + sigma x, times inv_rho[lane] where
// inv_rho (B,) is given (else null).  fpar (4,) = h, sigma, alpha,
// col_penalty; eta (B, K, P, 2), 8-byte aligned; rho_s (K, 6) and rho_c
// (K, P) the rho of the first lane, the others' `rho_s_stride` and
// `rho_c_stride` floats apart (0: batch-shared); x (B, K, 6N), zs, ys
// (B, K, 6, 2N), zc, yc (B, K, P) are read.  The plan (ops/admm_steps.py
// rhs_plan): blocks of k_tile steps of one lane, `table` 1 for the table
// form (its table of rhs_table_bytes(k_tile, N) in shared memory), 0 for
// the direct form.  All float32, contiguous.  Returns the CUDA error code
// of the launch, or cudaErrorInvalidValue for arguments it cannot serve.
int admm_rhs_f32(const float* fpar, const float* eta, const float* rho_s,
                 const float* rho_c, const float* inv_rho, const float* x,
                 const float* zs, const float* ys, const float* zc,
                 const float* yc, float* b, int B, int K, int N, int k_tile,
                 int table, int rho_s_stride, int rho_c_stride,
                 cudaStream_t stream) {
  const long smem = table ? rhs_table_bytes(k_tile, N) : 0;
  if (!row_args_ok(B, K, N, k_tile) || smem > kSmemMax ||
      (reinterpret_cast<size_t>(eta) & 7) ||
      static_cast<long>(k_tile) * (2L * N + N * (N - 1L) / 2) >= (1L << 22))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (K + k_tile - 1) / k_tile;
  if (!table) {
    admm_rhs_direct_kernel<<<B * n_tiles, kRowThreads, 0, stream>>>(
        fpar, eta, rho_s, rho_c, inv_rho, x, zs, ys, zc, yc, b, K, N,
        k_tile, n_tiles, rho_s_stride, rho_c_stride);
    return static_cast<int>(cudaGetLastError());
  }
  // the largest table allowed so far on each device (the attribute is per
  // device)
  constexpr int kDevices = 64;
  static long allowed[kDevices] = {};
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err && (dev >= kDevices || smem > allowed[dev])) {
    err = allow_smem(admm_rhs_table_kernel, smem);
    if (!err && dev < kDevices) allowed[dev] = smem;
  }
  if (err) return err;
  admm_rhs_table_kernel<<<B * n_tiles, kRowThreads, smem, stream>>>(
      fpar, eta, rho_s, rho_c, inv_rho, x, zs, ys, zc, yc, b, K, N, k_tile,
      n_tiles, rho_s_stride, rho_c_stride);
  return static_cast<int>(cudaGetLastError());
}

// From the sweep's solution xt (B, K, 6N), update x (B, K, 6N), zs, ys
// (B, K, 6, 2N) and zc, yc (B, K, P) in place; l_s, u_s (B, K, 6, 2N) the
// static bounds, l_c (B, K, P) the collision lower bounds; the rest as in
// admm_rhs_f32 (blocks of k_tile steps of one lane, ops/admm_steps.py
// update_plan).
int admm_update_f32(const float* fpar, const float* eta, const float* l_s,
                    const float* u_s, const float* l_c, const float* rho_s,
                    const float* rho_c, const float* xt, float* x, float* zs,
                    float* ys, float* zc, float* yc, int B, int K, int N,
                    int k_tile, int rho_s_stride, int rho_c_stride,
                    cudaStream_t stream) {
  // a block's element indices stay below 2^22 (SmallDiv)
  if (!row_args_ok(B, K, N, k_tile) ||
      static_cast<long>(k_tile) * (12L * N + N * (N - 1L) / 2) >= (1L << 22))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (K + k_tile - 1) / k_tile;
  admm_update_kernel<<<B * n_tiles, kRowThreads, 0, stream>>>(
      fpar, eta, l_s, u_s, l_c, rho_s, rho_c, xt, x, zs, ys, zc, yc, K, N,
      k_tile, n_tiles, rho_s_stride, rho_c_stride);
  return static_cast<int>(cudaGetLastError());
}

// n_iters ADMM iterations of the collision-free QP (eta = 0: eta and the
// pairs are not read) on the per-channel factors Linv (K, 3, 3) and Eb
// (K - 1, 3, 3), shared, or one set a lane where lane_factors is 1
// ((B, K, 3, 3), (B, K - 1, 3, 3)); l_s, u_s, l_c, rho_s, rho_c and the
// state x, zs, ys, zc, yc as in admm_update_f32, the state updated in
// place.  The plan (ops/admm_steps.py channel_plan): `steps` 1 or 2 (the
// steps a thread in registers, K <= 32 steps) or 0 (the memory form),
// `warps` the channels a block (1, 2 or 4; 1 in the memory form);
// scratch null (each block's region in shared memory) or, in the memory
// form only, max_blocks regions of admm_channel_region_floats floats, one
// a block.
int admm_channel_interval_f32(const float* fpar, const float* Linv,
                              const float* Eb, const float* l_s,
                              const float* u_s, const float* l_c,
                              const float* rho_s, const float* rho_c,
                              float* x, float* zs, float* ys, float* zc,
                              float* yc, float* scratch, int B, int K, int N,
                              int n_iters, int rho_s_stride,
                              int rho_c_stride, int lane_factors, int steps,
                              int warps, int max_blocks,
                              cudaStream_t stream) {
  int lw = 0;
  while ((1 << lw) < warps) ++lw;
  const long P = N * (N - 1L) / 2;
  const long region = admm_channel_region_floats(K, warps, steps);
  const long smem = 4 * region;
  const bool ok =
      B >= 1 && K >= 2 && N >= 1 && n_iters >= 0 && max_blocks >= 1 &&
      (1 << lw) == warps && warps <= 4 && steps >= 0 && steps <= 2 &&
      (steps == 0 ? warps == 1 : K <= chan::kWarp * steps && !scratch) &&
      (scratch || smem <= kSmemMax) &&
      1L * B * K * P < (1L << 31) && 2L * B * N < (1L << 31);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  chan::Args a{fpar, Linv, Eb, l_s, u_s, l_c, rho_s, rho_c, x, zs, ys, zc,
               yc, scratch, B, K, N, n_iters, rho_s_stride, rho_c_stride,
               lane_factors, warps, lw};
  a.groups_per_lane = (2 * N + warps - 1) / warps;
  a.chan_groups = B * a.groups_per_lane;
  const long chunk = 1L * chan::kWarp * warps * chan::kColItems;
  a.col_groups = static_cast<int>((B * K * P + chunk - 1) / chunk);
  a.region_floats = region;
  if (steps == 1) return launch_channel<1>(a, smem, max_blocks, stream);
  if (steps == 2) return launch_channel<2>(a, smem, max_blocks, stream);
  return launch_channel<0>(a, scratch ? 0 : smem, max_blocks, stream);
}

}  // extern "C"
