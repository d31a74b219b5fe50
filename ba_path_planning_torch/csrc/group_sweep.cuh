// The grouped sweep solve of one ADMM x-update, for Hopper: the kernel
// template of group_solve_x.cu (symmetric block inverses X_k) and
// group_solve_l.cu (inverted diagonal Cholesky factors Linv_k).  For every
// scenario it solves M x = b, with B_k = C_{k-1} (x) I_2N applied as the six
// slot-scalar axpys of sweeps.cuh:
//
//   X form  forward   w_k = X_k (b_k - B_k w_{k-1})
//           backward  x_{K-1} = w_{K-1},  x_k = w_k - X_k (B_{k+1}^T x_{k+1})
//   L form  forward   w_k = Linv_k^T Linv_k (b_k - B_k w_{k-1})
//           backward  x_{K-1} = w_{K-1}
//                     x_k = w_k - Linv_k^T Linv_k (B_{k+1}^T x_{k+1})
//
// The 2K - 1 steps of a scenario are serial in the vector, but the order of
// the factor blocks is fixed: 0 .. K-1, then K-2 .. 0.  So the blocks are
// streamed through factor_ring.cuh: one producer warp fills a ring of
// shared-memory stages with bulk copies of row bands, in that order, and
// runs ahead across blocks and across the turn between the sweeps (it
// skips block K-1 on the way back, as the sweeps do); 8 consumer warps take
// each step's matvecs from the stages.
//   * X form: X_k is symmetric, so one matvec by rows serves both sweeps.
//   * L form: both products from one read of each band (matvec_rows_cols):
//     a warp forms y_i = Linv_k[i, :i+1] . r for its rows and at once adds
//     Linv_k[i, j] y_i into register partial sums of its lanes' columns;
//     Linv_k leaves HBM once per step, and both stop at the diagonal.
//
// Occupancy is the launcher's plan (ops/group_solve.py sweep_plan): large
// batches run one block per scenario, as many to an SM as the batch needs
// (up to four); small ones (up to 64 scenarios) a thread-block cluster of 2
// or 4 blocks per scenario, so that the scenario's stream spreads over as
// many SMs.  Two instantiations serve the sizes: n up to 512 (every
// production N, in 56 registers so that four blocks share an SM) and n up to
// 1536 (N <= 256, the L form's column sums in 48 registers a lane, launch
// bounds for one block an SM).  Each block of a cluster streams and solves
// the rows [lo, hi) of every block (even bounds, so the bands stay 16-byte
// aligned), and the vector of each step meets across the cluster in
// distributed shared memory: every block stores its part (X: its rows of the
// result; L: its column partial sums of Linv_k^T y, plus w_k of its rows in
// the backward sweep) into its own exchange buffer and, with asynchronous
// stores that count their bytes on the receiver's mbarrier (st.async ...
// complete_tx), into every other block's; a block reads the step's vector
// once its barrier has the bytes of the step and its own stores are behind a
// block barrier.  No fence and no remote arrival is on the chain.  The buffer
// has two halves, one per step parity, and one barrier each: a block stores
// into the half of step t + 2 only after it has the whole vector of step
// t + 1, which every block sends after its last read of that half.  A plan of
// one block is a cluster of one and runs the same code.  w_k is kept in the
// output array (each block its rows) and overwritten by x_k in the backward
// sweep.  Plain FP32; the order of the sums is not the plain version's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "factor_ring.cuh"
#include "sweeps.cuh"

namespace group_sweep {

namespace cg = cooperative_groups;

constexpr int kConsumers = 256;               // 8 consumer warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kNarrowN = 512;   // n of the instantiation for production N
constexpr int kMaxN = 1536;     // n of the wide one, the most a launch serves
constexpr int kMaxCluster = 4;
constexpr int kMaxBandRows = factor_ring::kRows * kWarps;
// the ring's barriers, then the exchange barriers xfull[2]
constexpr int kBarrierBytes = factor_ring::kBarrierBytes + 16;
constexpr long kSmemMax = 232448;

// First row that rank c of a cluster of `cluster` blocks streams and
// solves: shares of whole row pairs, so every bound is even.
__host__ __device__ inline int row_lo(int c, int cluster, int n) {
  return 2 * (c * (n / 2) / cluster);
}

// Dynamic shared memory of a plan: the barriers, the ring, then r, wk, the
// exchange buffer (2 halves of `cluster` slots of n) and the L form's warp
// partial sums (kWarps x n).  ops/group_solve.py sweep_plan mirrors it, and
// tests/test_torch_sweep_plan.py holds the two copies to each other.
__host__ __device__ inline long smem_bytes(int n, int cluster, int band_rows,
                                           int stages) {
  return kBarrierBytes + 4L * n * (static_cast<long>(stages) * band_rows +
                                   2 + 2 * cluster + kWarps);
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Store v at `addr` of another block of the cluster; the store counts its
// 4 bytes on that block's mbarrier `bar` when it lands.
__device__ __forceinline__ void store_async(unsigned addr, float v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

// Named barrier of the consumer warps.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The vector of the last finished step as a block reads it from its half of
// the exchange buffer: X form, one slot holding every rank's rows; L form,
// the sum of the ranks' column partials (rank q's cover the columns below
// its last row, hi[q]).
template <bool kL>
struct Exchanged {
  const float* slots;
  int n, cluster;
  int hi[kMaxCluster];
  __device__ float operator[](int j) const {
    if constexpr (!kL) {
      return slots[j];
    } else {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < cluster && hi[q] > j) s += slots[q * n + j];
      return s;
    }
  }
};

// F (B, K, n, n): X_k (kL false) or Linv_k (kL true, lower triangular: what
// lies above the diagonal is not read), n <= kTierN.  A grid of B clusters
// of cluster.num_blocks() blocks of kThreads threads.
template <bool kL, int kTierN>
__global__ void __launch_bounds__(kThreads, kTierN > kNarrowN ? 1 : 4)
sweep_kernel(const float* __restrict__ F, const float* __restrict__ C9,
             const float* __restrict__ bvec, float* xout, int K, int n,
             int band_rows, int stages) {
  constexpr int kColRegs = kTierN / 32;       // L form: columns of a lane
  constexpr int kPre = kTierN / kConsumers;   // vector entries of a thread
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / nc, tid = threadIdx.x;
  const int lo = row_lo(rank, nc, n), hi = row_lo(rank + 1, nc, n);
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem4);
  const unsigned bars = factor_ring::smem_addr(raw);
  const unsigned xfull = bars + factor_ring::kBarrierBytes;
  float* sm = reinterpret_cast<float*>(raw + kBarrierBytes);
  const factor_ring::Ring ring{sm, bars, stages, band_rows * n};
  sm += static_cast<size_t>(stages) * ring.stage_floats;
  float* r = sm;                 // right-hand side of the step's matvec
  float* wk = sm + n;            // w_k of this block's rows (backward)
  float* xch = sm + 2 * n;       // exchange: [2][slots][n]
  float* part = xch + 2 * nc * n;  // L form: [kWarps][n]
  const int slots = kL ? nc : 1;
  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Fb = F + static_cast<size_t>(b) * K * nsq;
  const float* bb = bvec + static_cast<size_t>(b) * K * n;
  float* xb = xout + static_cast<size_t>(b) * K * n;
  const int steps = 2 * K - 1;   // forward k = t, backward k = 2K - 2 - t

  if (tid == 0) {
    for (int p = 0; p < 2; ++p) factor_ring::mbar_init(xfull + 8 * p, 1);
    factor_ring::init(ring, kWarps);
  }
  // every block of the cluster has its barriers before anyone stores
  cluster.sync();

  if (tid >= kConsumers) {
    // ---- producer warp: this block's rows of every step's block
    factor_ring::Cursor cur{0, 0u};
    for (int t = 0; t < steps; ++t) {
      const int k = t < K ? t : 2 * K - 2 - t;
      factor_ring::produce_block(ring, cur, Fb + k * nsq, n, lo, hi,
                                 band_rows);
    }
    __syncwarp();
    cluster.sync();
    return;
  }

  // ---- consumer warps
  const int warp = tid >> 5, n2 = n / 3;
  // bytes the other blocks send a step: X their rows, L their partials
  Exchanged<kL> v{xch, n, nc, {}};
  unsigned incoming = 0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    v.hi[q] = row_lo(q + 1, nc, n);
    if (q < nc && q != rank)
      incoming += 4u * (v.hi[q] - (kL ? 0 : row_lo(q, nc, n)));
  }
  factor_ring::Cursor cur{0, 0u};
  for (int t = 0; t <= steps; ++t) {
    const bool fwd = t < K;
    const int k = fwd ? t : 2 * K - 2 - t;
    // the barrier of step t is in its phase: this thread waited for step
    // t - 2 on it at the start of step t - 1
    if (tid == 0 && t < steps) {
      if (incoming)
        factor_ring::mbar_arrive_expect_tx(xfull + 8 * (t & 1), incoming);
      else
        factor_ring::mbar_arrive(xfull + 8 * (t & 1));
    }
    // what the step reads of b_k, or of w_k in its rows, does not wait for
    // the chain: load it before the wait
    float pre[kPre];
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int j = tid + u * kConsumers;
      pre[u] = 0.f;
      if (t < steps && j < n) {
        if (fwd)
          pre[u] = __ldg(bb + k * n + j);
        else if (j >= lo && j < hi)
          pre[u] = xb[k * n + j];
      }
    }
    v.slots = xch + ((t - 1) & 1) * slots * n;
    if (t > 0)
      factor_ring::mbar_wait(xfull + 8 * ((t - 1) & 1), ((t - 1) >> 1) & 1);
    const int kprev = fwd ? k - 1 : k + 1;     // the block of v
    const int ck = fwd ? k - 1 : k;           // B_k = C_{k-1} (x) I
    const float* c = C9 + (ck > 0 ? ck : 0) * 9;
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int j = tid + u * kConsumers;
      if (j >= n) break;
      // L form: this block's rows of the finished vector
      if (kL && t > 0 && j >= lo && j < hi) xb[kprev * n + j] = v[j];
      if (t == steps) continue;
      if (fwd) {
        r[j] = k == 0 ? pre[u] : pre[u] - sweeps::slot_b(c, v, j, n2);
      } else {
        r[j] = sweeps::slot_bt(c, v, j, n2);
        wk[j] = pre[u];
      }
    }
    if (t == steps) break;
    consumer_sync();

    float* half = xch + (t & 1) * slots * n;
    const unsigned bar = xfull + 8 * (t & 1);
    // this block's part of the step's vector, into every block's half
    auto send = [&](int at, float val) {
      half[at] = val;
      const unsigned a = factor_ring::smem_addr(half + at);
      for (int q = 0; q < nc; ++q)
        if (q != rank) store_async(map_rank(a, q), val, map_rank(bar, q));
    };
    if constexpr (!kL) {
      factor_ring::matvec_rows(
          ring, cur, r, n, lo, hi, band_rows, false, warp, kWarps,
          [&](int i, float d) {
            const float val = fwd ? d : wk[i] - d;
            xb[k * n + i] = val;
            send(i, val);
          });
    } else {
      float acc[kColRegs];
#pragma unroll
      for (int u = 0; u < kColRegs; ++u) acc[u] = 0.f;
      factor_ring::matvec_rows_cols(ring, cur, r, n, lo, hi, band_rows, warp,
                                    kWarps, acc);
      const int lane = tid & 31;
#pragma unroll
      for (int u = 0; u < kColRegs; ++u) {
        if (32 * u >= hi) break;
        if (32 * u + lane < hi) part[warp * n + 32 * u + lane] = acc[u];
      }
      consumer_sync();
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int j = tid + u * kConsumers;
        if (j >= hi) break;
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += part[w * n + j];
        send(rank * n + j, fwd ? s : (j >= lo ? wk[j] : 0.f) - s);
      }
    }
    // this block's own part is read by all its warps at the next step
    consumer_sync();
  }
  // no block leaves while another may still store into it
  cluster.sync();
}

// Launch one instantiation on a checked plan.
template <bool kL, int kTierN>
int launch_tier(const float* F, const float* C9, const float* b, float* x,
                int B, int K, int n, int cluster, int band_rows, int stages,
                long smem, cudaStream_t stream) {
  // the largest size set so far on each device (the attribute is per device)
  constexpr int kDevices = 64;
  static long allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(sweep_kernel<kL, kTierN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sweep_kernel<kL, kTierN>, F, C9, b, x, K, n,
                           band_rows, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch the sweeps of B scenarios on the plan (cluster, band_rows,
// stages), on the narrow instantiation where n allows; returns a CUDA error
// code, cudaErrorInvalidValue for arguments or a plan it cannot serve.
template <bool kL>
int launch(const float* F, const float* C9, const float* b, float* x, int B,
           int K, int n, int cluster, int band_rows, int stages,
           cudaStream_t stream) {
  if (B < 1 || K < 2 || n < 6 || n % 6 || n > kMaxN ||
      (cluster != 1 && cluster != 2 && cluster != 4) || band_rows < 2 ||
      band_rows % 2 || band_rows > kMaxBandRows || stages < 2 ||
      stages > factor_ring::kMaxStages ||
      (reinterpret_cast<size_t>(F) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long smem = smem_bytes(n, cluster, band_rows, stages);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return n <= kNarrowN
             ? launch_tier<kL, kNarrowN>(F, C9, b, x, B, K, n, cluster,
                                         band_rows, stages, smem, stream)
             : launch_tier<kL, kMaxN>(F, C9, b, x, B, K, n, cluster,
                                      band_rows, stages, smem, stream);
}

}  // namespace group_sweep
