// The sweep solve of one ADMM x-update, for Hopper: the kernel template of
// group_solve_x.cu (symmetric block inverses X_k), group_solve_l.cu
// (inverted diagonal Cholesky factors Linv_k) and banded_solve.cu (Linv_k
// beside dense off-diagonal factors E_k).  For every scenario it solves
// M x = b; in the first two forms B_k = C_{k-1} (x) I_2N is applied as the
// six slot-scalar axpys of sweeps.cuh:
//
//   X form  forward   w_k = X_k (b_k - B_k w_{k-1})
//           backward  x_{K-1} = w_{K-1},  x_k = w_k - X_k (B_{k+1}^T x_{k+1})
//   L form  forward   w_k = Linv_k^T Linv_k (b_k - B_k w_{k-1})
//           backward  x_{K-1} = w_{K-1}
//                     x_k = w_k - Linv_k^T Linv_k (B_{k+1}^T x_{k+1})
//   dense   forward   y_0 = Linv_0 b_0,  y_k = Linv_k (b_k - E_{k-1} y_{k-1})
//           backward  x_{K-1} = Linv_{K-1}^T y_{K-1}
//                     x_k = Linv_k^T (y_k - E_k^T x_{k+1})
//
// The steps of a scenario are serial in the vector, but the order of the
// factor blocks is fixed: 0 .. K-1, then K-2 .. 0 (dense: Linv_0, E_0,
// Linv_1, ..., E_{K-2}, Linv_{K-1}, then E_{K-2}, Linv_{K-2}, ..., Linv_0).
// So the blocks are streamed through factor_ring.cuh: one producer warp
// fills a ring of shared-memory stages with bulk copies of row bands, in
// that order, and runs ahead across blocks and across the turn between the
// sweeps (it streams block K-1 once, as the sweeps read it once); 8
// consumer warps take each step's matvecs from the stages.
//   * X form: X_k is symmetric, so one matvec by rows serves both sweeps.
//   * L form: both products from one read of each band (matvec_rows_cols):
//     a warp forms y_i = Linv_k[i, :i+1] . r for its rows and at once adds
//     Linv_k[i, j] y_i into register partial sums of its lanes' columns;
//     Linv_k leaves HBM once per step, and both stop at the diagonal.
//   * dense form: two blocks a step of k.  Forward steps take row products
//     (to the diagonal on Linv_k); backward steps the transposed products
//     as column partial sums in registers from the same one read of each
//     band; the turn, Linv_{K-1}, takes both from one read, as the L form.
//   * On bf16 factors every product reads a lane's columns in pairs, one
//     __nv_bfloat162 widened once: the row products of the X and dense
//     forms (factor_ring's matvec_rows on a bf16 ring, a warp's rows
//     summed in one joint reduction) and the column products of the L and
//     dense forms (matvec_rows_cols_bf16: a lane owns column pairs).
//
// Occupancy is the launcher's plan (ops/group_solve.py sweep_plan): large
// batches run one block per scenario, as many to an SM as the batch needs
// and blocks_per_sm allows; small ones (up to 64 scenarios) a thread-block
// cluster of 2 or 4 blocks per scenario, so that the scenario's stream
// spreads over as many SMs.  The instantiations: n up to 512 (every
// production N, in 56 registers so that four blocks share an SM; on bf16
// factors the L form, and the dense form at small batches, in 112, two
// blocks an SM: blocks_per_sm) and, with launch bounds for one block an
// SM, n up to 1536 (N <= 256: the column
// sums of the L and dense forms, 48 registers a lane) and up to 6144 (the
// X form, which keeps no column sums; the L form, whose threads then
// all take every row of a band, as on the wide tier, and add their column
// pairs' register sums into one row of shared memory every kFlushRows
// rows).  Each block of a cluster streams and solves the rows [lo, hi) of
// every block (even bounds, so the bands stay 16-byte aligned), and the
// vector of each step meets across the cluster in
// distributed shared memory: every block stores its part (a row step: its
// rows of the result; a column step: its column partial sums, in the L form
// plus w_k of its rows in the backward sweep) into its own exchange buffer
// and, with asynchronous stores that count their bytes on the receiver's
// mbarrier (st.async ... complete_tx), into every other block's; a block
// reads the step's vector once its barrier has the bytes of the step and
// its own stores are behind a block barrier.  No fence and no remote
// arrival is on the chain.  The buffer has two halves, one per step parity,
// and one barrier each: a block stores into the half of step t + 2 only
// after it has the whole vector of step t + 1, which every block sends after
// its last read of that half.  A plan of one block is a cluster of one and
// runs the same code.  w_k (dense: y_k) is kept in the output array (each
// block its rows) and overwritten by x_k in the backward sweep.  The factor
// blocks come as float or as bf16 (the element type T; rows ld apart, a
// multiple of 8 elements in bf16, so that every row is 16-byte aligned);
// bf16 elements are widened to FP32 as the matvecs read them, and the
// sums, the vectors and the slot scalars are FP32; the order of the sums
// is not the plain version's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "factor_ring.cuh"
#include "sweeps.cuh"

namespace group_sweep {

namespace cg = cooperative_groups;

// The forms of the template.
constexpr int kFormX = 0;       // symmetric X_k, slot-scalar off-diagonals
constexpr int kFormL = 1;       // lower triangular Linv_k, slot scalars
constexpr int kFormDense = 2;   // Linv_k beside dense off-diagonal E_k

constexpr int kConsumers = 256;               // 8 consumer warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kNarrowN = 512;   // n of the instantiation for production N
constexpr int kMaxN = 1536;     // the most column sums in registers serve
constexpr int kMaxNWide = 6144;  // the most the X and L forms serve
constexpr int kMaxCluster = 4;
constexpr int kMaxBandRows = factor_ring::kRows * kWarps;
// the ring's barriers, then the exchange barriers xfull[2]
constexpr int kBarrierBytes = factor_ring::kBarrierBytes + 16;
constexpr long kSmemMax = 232448;

// Blocks an SM that the launch bounds of the instantiation serving a plan
// of per_sm blocks an SM leave registers for: four in the narrow tier (56
// registers a thread), two there for the L form on bf16 factors (112: under
// 56 its per-step chain spilled, and it was no faster than on float32
// factors wherever that chain sets the time) and for the dense form on
// bf16 factors where the plan puts at most two blocks on an SM (every batch
// up to 264, where that chain sets the time; above, four, so that the
// batch runs in one wave), one in the wide tiers.  ops/group_solve.py
// sweep_blocks_per_sm mirrors it, and tests/test_torch_sweep_plan.py holds
// the two copies to each other.
__host__ __device__ constexpr int blocks_per_sm(int form, int tier_n,
                                                int esize, int per_sm) {
  return tier_n > kNarrowN ? 1
         : esize == 2 && (form == kFormL ||
                          (form == kFormDense && per_sm <= 2)) ? 2
                                                               : 4;
}

// First row that rank c of a cluster of `cluster` blocks streams and
// solves: shares of whole row pairs, so every bound is even.
__host__ __device__ inline int row_lo(int c, int cluster, int n) {
  return 2 * (c * (n / 2) / cluster);
}

// Rows of n floats of partial sums a form keeps at n: the warps' column
// sums of the L and dense forms, or, in the L form above kMaxN, the block's
// one row of them, added in shared memory; the X form has none.
__host__ __device__ inline int part_rows(int form, int n) {
  return form == kFormX ? 0 : n > kMaxN ? 1 : kWarps;
}

// The L form above kMaxN: y of a band's rows and each consumer warp's sums
// of them (FP32 words after its row of partial sums), and the rows whose
// column products a thread sums in registers before it adds them into
// that row.
constexpr int kBandSums = kMaxBandRows * (kWarps + 1);
constexpr int kFlushRows = 64;

// Dynamic shared memory of a plan: the barriers, the ring (`stages` stages
// of `band_rows` rows of `row_bytes` bytes: 4 n for float factors, 2 ld for
// bf16 ones), then r, wk, the exchange buffer (2 halves of `cluster` slots
// of n), `part` rows of partial sums (part_rows) and with one row (the L
// form above kMaxN) kBandSums words, all FP32.  ops/group_solve.py
// sweep_plan mirrors it, and tests/test_torch_sweep_plan.py holds the two
// copies to each other.
__host__ __device__ inline long smem_bytes(int n, int cluster, int band_rows,
                                           int stages, int part,
                                           int row_bytes) {
  return kBarrierBytes + (static_cast<long>(stages) * band_rows * row_bytes +
                          4L * (n * (2 + 2 * cluster + part) +
                                (part == 1) * kBandSums));
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

// How a step's vector crosses the cluster: a row step's result, one slot
// holding every rank's rows; a column step's partial sums, one slot a rank,
// rank q's covering the columns below its last row, hi[q] (triangular
// blocks), or every column (dense blocks).
constexpr int kRowsOut = 0;
constexpr int kTriOut = 1;
constexpr int kDenseOut = 2;

// The vector of the last finished step as a block reads it from its half of
// the exchange buffer: the slot of a row step, or the sum of the ranks'
// column partials.
template <int kOut>
struct Exchanged {
  const float* slots;
  int n, cluster;
  int hi[kMaxCluster];
  __device__ float operator[](int j) const {
    if constexpr (kOut == kRowsOut) {
      return slots[j];
    } else {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < cluster && (kOut == kDenseOut || hi[q] > j))
          s += slots[q * n + j];
      return s;
    }
  }
};

// A warp's column partial sums of a bf16 product (lane l: the pairs
// 64 m + 2 l and + 1, factor_ring::matvec_rows_cols_bf16) into its row of
// partials, the columns below `cover` (even, so a pair lies below it
// whole).
template <int U>
__device__ __forceinline__ void store_pair_sums(float* row,
                                                const float (&acc)[U],
                                                int cover, int lane) {
#pragma unroll
  for (int m = 0; m < U / 2; ++m) {
    const int j = 64 * m + 2 * lane;
    if (64 * m >= cover) break;
    if (j < cover)
      *reinterpret_cast<float2*>(row + j) =
          make_float2(acc[2 * m], acc[2 * m + 1]);
  }
}

// The type of the kernel's second operand: the FP32 slot scalars C9 of the
// X and L forms, or the dense form's off-diagonal factors, of type T.
template <int kForm, typename T>
using Second = std::conditional_t<kForm == kFormDense, T, float>;

// The L form's column pairs of a consumer thread in band_cols, the
// blocks above kMaxN (the one-block and cluster tiers there, and the wide
// tier)
constexpr int kWidePairs = kMaxNWide / 2 / kConsumers;

// The L form's row products of the band [r0, r1) at M (rows ld apart,
// lower triangular: what lies right of the diagonal is taken as 0) with r
// (shared, n): consumer thread tid sums M[i, j] r_j + M[i, j + 1] r_{j+1}
// over its column pairs j = 2 tid + 2 kConsumers m for kRows rows at a
// time, warp_sum_rows adds a warp's lanes, and red[warp * stride + i - r0]
// holds each warp's sum of row i (the caller adds the warps in order).
template <typename T>
__device__ __forceinline__ void band_dots_wide(const T* M, int r0, int r1,
                                               int ld, const float* r,
                                               int tid, float* red,
                                               int stride) {
  constexpr int kSpan = 32 / factor_ring::kRows;   // lanes a row's sum
  const int lane = tid & 31, warp = tid >> 5;
  for (int i0 = r0; i0 < r1; i0 += factor_ring::kRows) {
    const int last = i0 + factor_ring::kRows < r1 ? i0 + factor_ring::kRows
                                                   : r1;
    float a[factor_ring::kRows];
#pragma unroll
    for (int q = 0; q < factor_ring::kRows; ++q) a[q] = 0.f;
#pragma unroll
    for (int m = 0; m < kWidePairs; ++m) {
      if (2 * kConsumers * m >= last) break;   // no row of the group here
      const int j = 2 * tid + 2 * kConsumers * m;
      const float2 rj = j < last ? *reinterpret_cast<const float2*>(r + j)
                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < factor_ring::kRows; ++q) {
        const int i = i0 + q;
        const float2 e = factor_ring::pair_below(M + (i - r0) * ld, j,
                                                 i < r1 ? i + 1 : 0);
        a[q] = fmaf(e.y, rj.y, fmaf(e.x, rj.x, a[q]));
      }
    }
    const float sum = factor_ring::warp_sum_rows(a, lane);
    const int i = i0 + lane / kSpan;
    if (lane % kSpan == 0 && i < r1) red[warp * stride + i - r0] = sum;
  }
}

// The L form's column products of the band [r0, r1) at M (rows ld apart,
// lower triangular: what lies right of the diagonal is taken as 0) with
// the band's y (shared): acc[m] += (M[i, j], M[i, j + 1]) y_i over the
// band's rows i in order, for the column pairs j = 2 tid + 2 kConsumers m of
// consumer thread tid.  A warp's lanes read consecutive pairs of a row.
template <typename T>
__device__ __forceinline__ void band_cols(const T* M, int r0, int r1, int ld,
                                          const float* y, int tid,
                                          float2 (&acc)[kWidePairs]) {
#pragma unroll
  for (int m = 0; m < kWidePairs; ++m) {
    if (2 * kConsumers * m >= r1) break;   // the band reaches no column here
    const int j = 2 * tid + 2 * kConsumers * m;
    float2 s = acc[m];
#pragma unroll 4
    for (int i = r0; i < r1; ++i) {
      const float2 e = factor_ring::pair_below(M + (i - r0) * ld, j, i + 1);
      const float yi = y[i - r0];
      s.x = fmaf(e.x, yi, s.x);
      s.y = fmaf(e.y, yi, s.y);
    }
    acc[m] = s;
  }
}

// F (B, K, n, ld): X_k (X form), Linv_k (L and dense forms, lower
// triangular: what lies above the diagonal is not read), each row's
// columns n.. ld-1 unread; G: the slot scalars C9 (K-1, 9) (X and L forms)
// or E (B, K-1, n, ld) (dense form); n <= kTierN.  A grid of B clusters of
// cluster.num_blocks() blocks of kThreads threads, kBlocks an SM
// (blocks_per_sm).
template <int kForm, int kTierN, typename T, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
sweep_kernel(const T* __restrict__ F,
             const Second<kForm, T>* __restrict__ G,
             const float* __restrict__ bvec, float* xout, int K, int n,
             int ld, int band_rows, int stages) {
  constexpr bool kL = kForm == kFormL;
  constexpr bool kDense = kForm == kFormDense;
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  // column sums of a lane, or (the L form's widest instantiation) of a
  // thread's column pairs, added into one shared row
  constexpr bool kSharedCols = kTierN > kMaxN;
  constexpr int kColRegs = kSharedCols ? 1 : kTierN / 32;
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
  const factor_ring::RingOf<T> ring{
      reinterpret_cast<T*>(raw + kBarrierBytes), bars, stages, band_rows * ld,
      ld};
  float* sm = reinterpret_cast<float*>(
      ring.data + static_cast<size_t>(stages) * ring.stage_elems);
  float* r = sm;                 // right-hand side of the step's matvec
  float* wk = sm + n;            // w_k (dense: b_k, y_k) of this block's rows
  float* xch = sm + 2 * n;       // exchange: [2][slots][n]
  float* part = xch + 2 * nc * n;  // L, dense: [part_rows][n]
  const int slots = kForm == kFormX ? 1 : nc;
  const size_t nsq = static_cast<size_t>(n) * ld;   // elements of a block
  const T* Fb = F + static_cast<size_t>(b) * K * nsq;
  const float* bb = bvec + static_cast<size_t>(b) * K * n;
  float* xb = xout + static_cast<size_t>(b) * K * n;
  // X, L: forward k = t, backward k = 2K - 2 - t.  Dense: place p of the
  // ring order (p = t forward, 4K - 4 - t backward): Linv_{p/2} for even
  // p, E_{(p-1)/2} for odd p; the turn is p = 2K - 2.
  const int turn = 2 * K - 2;
  const int steps = kDense ? 4 * K - 3 : 2 * K - 1;

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
      const T* blk;
      if constexpr (kDense) {
        const int p = t <= turn ? t : 2 * turn - t;
        blk = (p & 1) ? G + (static_cast<size_t>(b) * (K - 1) + p / 2) * nsq
                      : Fb + (p / 2) * nsq;
      } else {
        blk = Fb + (t < K ? t : 2 * K - 2 - t) * nsq;
      }
      factor_ring::produce_block(ring, cur, blk, lo, hi, band_rows);
    }
    __syncwarp();
    cluster.sync();
    return;
  }

  const int warp = tid >> 5;
  // this block's part of step t's vector, into every block's half t & 1:
  // at `at` of the half, here and, with stores that count their bytes on
  // the receiver's barrier, in every other block of the cluster
  auto send = [&](int t, int at, float val) {
    float* half = xch + (t & 1) * slots * n;
    const unsigned bar = xfull + 8 * (t & 1);
    half[at] = val;
    const unsigned a = factor_ring::smem_addr(half + at);
    for (int q = 0; q < nc; ++q)
      if (q != rank) store_async(map_rank(a, q), val, map_rank(bar, q));
  };

  if constexpr (kDense) {
    // ---- consumer warps of the dense form
    // bytes the other blocks send a step, by the kind of its vector
    unsigned in_rows = 0, in_tri = 0, in_dense = 0;
    Exchanged<kRowsOut> vr{xch, n, nc, {}};
    Exchanged<kTriOut> vt{xch, n, nc, {}};
    Exchanged<kDenseOut> vd{xch, n, nc, {}};
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      vt.hi[q] = row_lo(q + 1, nc, n);
      if (q < nc && q != rank) {
        in_rows += 4u * (vt.hi[q] - row_lo(q, nc, n));
        in_tri += 4u * vt.hi[q];
        in_dense += 4u * n;
      }
    }
    factor_ring::Cursor cur{0, 0u};
    for (int t = 0; t <= steps; ++t) {
      const int p = t <= turn ? t : 2 * turn - t;
      const bool on_l = (p & 1) == 0;          // Linv_{p/2}, else E_{p/2}
      const int k = p >> 1;
      // the kind of the step's vector: rows forward, column sums from the
      // turn on (dense ones from the E blocks)
      const int out = t < turn ? kRowsOut : on_l ? kTriOut : kDenseOut;
      if (tid == 0 && t < steps) {
        const unsigned in = out == kRowsOut ? in_rows
                            : out == kTriOut ? in_tri : in_dense;
        if (in)
          factor_ring::mbar_arrive_expect_tx(xfull + 8 * (t & 1), in);
        else
          factor_ring::mbar_arrive(xfull + 8 * (t & 1));
      }
      // what the step reads of b or of y_k does not wait for the chain:
      // b_0; b_{k+1} of this block's rows (E_k forward); y_k of its rows
      // (Linv_k backward)
      float pre[kPre];
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int j = tid + u * kConsumers;
        const bool own = j >= lo && j < hi;
        pre[u] = 0.f;
        if (t == 0 && j < n)
          pre[u] = __ldg(bb + j);
        else if (t < turn && !on_l && own)
          pre[u] = __ldg(bb + (k + 1) * n + j);
        else if (t > turn && t < steps && on_l && own)
          pre[u] = xb[k * n + j];
      }
      const float* half = xch + ((t - 1) & 1) * slots * n;
      vr.slots = vt.slots = vd.slots = half;
      if (t > 0)
        factor_ring::mbar_wait(xfull + 8 * ((t - 1) & 1), ((t - 1) >> 1) & 1);
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int j = tid + u * kConsumers;
        if (j >= n) break;
        const bool own = j >= lo && j < hi;
        if (t == 0) {
          r[j] = pre[u];
        } else if (t <= turn) {
          // forward: the exchanged rows of y_{k-1} (E step) or of
          // b_k - E_{k-1} y_{k-1} (Linv step)
          r[j] = vr[j];
          if (!on_l && own) wk[j] = pre[u];
        } else if (!on_l || t == steps) {
          // x_{k+1} is whole (x_0 at the end): this block's rows of it into
          // the output, and the input of E_k^T
          const float xj = vt[j];
          if (own) xb[(t == steps ? 0 : k + 1) * n + j] = xj;
          r[j] = xj;
        } else if (own) {
          r[j] = pre[u] - vd[j];              // y_k - E_k^T x_{k+1}
        }
      }
      if (t == steps) break;
      consumer_sync();

      if (t < turn) {
        factor_ring::matvec_rows(
            ring, cur, r, n, lo, hi, band_rows, on_l, warp, kWarps,
            [&](int i, float d) {
              if (on_l) xb[k * n + i] = d;   // y_k, read again backward
              send(t, i, on_l ? d : wk[i] - d);
            });
      } else {
        float acc[kColRegs];
#pragma unroll
        for (int u = 0; u < kColRegs; ++u) acc[u] = 0.f;
        if constexpr (kBf16) {
          // bf16: a lane owns the column pairs 64 m + 2 lane, + 1; the turn
          // keeps no pair in registers, which the dense form's registers
          // have no room for
          if (t == turn)
            factor_ring::matvec_rows_cols_bf16<kColRegs, true, 0>(
                ring, cur, r, n, lo, hi, band_rows, true, warp, kWarps, acc);
          else
            factor_ring::matvec_rows_cols_bf16<kColRegs, false>(
                ring, cur, r, n, lo, hi, band_rows, on_l, warp, kWarps, acc);
        } else {
          if (t == turn)
            factor_ring::matvec_rows_cols<kColRegs, true>(
                ring, cur, r, n, lo, hi, band_rows, true, warp, kWarps, acc);
          else
            factor_ring::matvec_rows_cols<kColRegs, false>(
                ring, cur, r, n, lo, hi, band_rows, on_l, warp, kWarps, acc);
        }
        const int cover = on_l ? hi : n;     // the columns of the partials
        const int lane = tid & 31;
        if constexpr (kBf16) {
          store_pair_sums(part + warp * n, acc, cover, lane);
        } else {
#pragma unroll
          for (int u = 0; u < kColRegs; ++u) {
            if (32 * u >= cover) break;
            if (32 * u + lane < cover) part[warp * n + 32 * u + lane] = acc[u];
          }
        }
        consumer_sync();
#pragma unroll
        for (int u = 0; u < kPre; ++u) {
          const int j = tid + u * kConsumers;
          if (j >= cover) break;
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += part[w * n + j];
          send(t, rank * n + j, s);
        }
      }
      // this block's own part is read by all its warps at the next step
      consumer_sync();
    }
  } else {
    // ---- consumer warps of the X and L forms
    const int n2 = n / 3;
    // bytes the other blocks send a step: X their rows, L their partials
    Exchanged<kL ? kTriOut : kRowsOut> v{xch, n, nc, {}};
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
      const float* c = G + (ck > 0 ? ck : 0) * 9;
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

      if constexpr (!kL) {
        factor_ring::matvec_rows(
            ring, cur, r, n, lo, hi, band_rows, false, warp, kWarps,
            [&](int i, float d) {
              const float val = fwd ? d : wk[i] - d;
              xb[k * n + i] = val;
              send(t, i, val);
            });
      } else if constexpr (kSharedCols) {
        // every thread on every row of a band, as on the wide tier: y of
        // the band's rows (band_dots_wide, the warps' sums added in order),
        // then the block's column sums of its pairs in registers
        // (band_cols), added into the shared row `part` every kFlushRows
        // rows, so every sum has a fixed order and no chain is long
        float* ysh = part + n;             // y of a band's rows
        float* red = ysh + kMaxBandRows;   // [kWarps][kMaxBandRows]
        float2 acc[kWidePairs];
#pragma unroll
        for (int m = 0; m < kWidePairs; ++m) acc[m] = make_float2(0.f, 0.f);
        bool first = true;
        int held = 0;                      // rows summed in acc
        for (int r0 = lo; r0 < hi; r0 += band_rows) {
          const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
          const T* M = factor_ring::acquire(ring, cur);
          band_dots_wide(M, r0, r1, ld, r, tid, red, kMaxBandRows);
          consumer_sync();
          if (tid < r1 - r0) {
            float y = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) y += red[w * kMaxBandRows + tid];
            ysh[tid] = y;
          }
          consumer_sync();
          band_cols(M, r0, r1, ld, ysh, tid, acc);
          factor_ring::release(ring, cur);
          held += r1 - r0;
          if (held < kFlushRows && r1 < hi) continue;
          // the pairs j of this thread below hi (j and hi even)
#pragma unroll
          for (int m = 0; m < kWidePairs; ++m) {
            const int j = 2 * tid + 2 * kConsumers * m;
            float2* pj = reinterpret_cast<float2*>(part + j);
            if (j < hi)
              *pj = first ? acc[m]
                          : make_float2(pj->x + acc[m].x, pj->y + acc[m].y);
            acc[m] = make_float2(0.f, 0.f);
          }
          first = false;
          held = 0;
        }
        consumer_sync();
#pragma unroll
        for (int u = 0; u < kPre; ++u) {
          const int j = tid + u * kConsumers;
          if (j >= hi) break;
          const float s = part[j];
          send(t, rank * n + j, fwd ? s : (j >= lo ? wk[j] : 0.f) - s);
        }
      } else {
        float acc[kColRegs];
#pragma unroll
        for (int u = 0; u < kColRegs; ++u) acc[u] = 0.f;
        const int lane = tid & 31;
        if constexpr (kBf16) {
          // bf16: a lane owns the column pairs 64 m + 2 lane, + 1
          factor_ring::matvec_rows_cols_bf16<kColRegs, true>(
              ring, cur, r, n, lo, hi, band_rows, true, warp, kWarps, acc);
          store_pair_sums(part + warp * n, acc, hi, lane);
        } else {
          factor_ring::matvec_rows_cols<kColRegs, true>(
              ring, cur, r, n, lo, hi, band_rows, true, warp, kWarps, acc);
#pragma unroll
          for (int u = 0; u < kColRegs; ++u) {
            if (32 * u >= hi) break;
            if (32 * u + lane < hi) part[warp * n + 32 * u + lane] = acc[u];
          }
        }
        consumer_sync();
#pragma unroll
        for (int u = 0; u < kPre; ++u) {
          const int j = tid + u * kConsumers;
          if (j >= hi) break;
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += part[w * n + j];
          send(t, rank * n + j, fwd ? s : (j >= lo ? wk[j] : 0.f) - s);
        }
      }
      // this block's own part is read by all its warps at the next step
      consumer_sync();
    }
  }
  // no block leaves while another may still store into it
  cluster.sync();
}

// Launch one instantiation on a checked plan.
template <int kForm, int kTierN, typename T, int kBlocks>
int launch_tier(const T* F, const Second<kForm, T>* G, const float* b,
                float* x, int B, int K, int n, int ld, int cluster,
                int band_rows, int stages, long smem, cudaStream_t stream) {
  // the largest size set so far on each device (the attribute is per device)
  constexpr int kDevices = 64;
  static long allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(sweep_kernel<kForm, kTierN, T, kBlocks>,
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
  err = cudaLaunchKernelEx(&cfg, sweep_kernel<kForm, kTierN, T, kBlocks>, F,
                           G, b, x, K, n, ld, band_rows, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch the sweeps of B scenarios on the plan (cluster, band_rows,
// stages, per_sm), on the narrow instantiation where n allows (the one of
// blocks_per_sm for per_sm), else the wide one (the L form above kMaxN: its
// column sums in one shared row); returns a CUDA error code,
// cudaErrorInvalidValue for arguments or a plan it cannot serve.  n is a
// multiple of 6 (X, L: the slot scalars) or of 2 (dense), up to kMaxNWide
// (X, L) or kMaxN (dense); the factors' rows lie ld >= n elements apart,
// with a pair of rows a multiple of 16 bytes (float: ld even; bf16: a
// multiple of 4).
template <int kForm, typename T>
int launch(const T* F, const Second<kForm, T>* G, const float* b, float* x,
           int B, int K, int n, int ld, int cluster, int band_rows,
           int stages, int per_sm, cudaStream_t stream) {
  constexpr int kWideN = kForm == kFormDense ? kMaxN : kMaxNWide;
  constexpr int kEsize = static_cast<int>(sizeof(T));
  const int unit = kForm == kFormDense ? 2 : 6;
  const int row_bytes = static_cast<int>(sizeof(T)) * ld;
  if (B < 1 || K < 2 || n < unit || n % unit || n > kWideN || ld < n ||
      (2 * row_bytes) % 16 ||
      (cluster != 1 && cluster != 2 && cluster != 4) || band_rows < 2 ||
      band_rows % 2 || band_rows > kMaxBandRows || stages < 2 ||
      stages > factor_ring::kMaxStages ||
      (reinterpret_cast<size_t>(F) & 15) ||
      (kForm == kFormDense && (reinterpret_cast<size_t>(G) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long smem = smem_bytes(n, cluster, band_rows, stages,
                               part_rows(kForm, n), row_bytes);
  const int tier = n <= kNarrowN                   ? kNarrowN
                   : kForm == kFormL && n <= kMaxN ? kMaxN
                                                   : kWideN;
  const int blocks = blocks_per_sm(kForm, tier, kEsize, per_sm);
  if (smem > kSmemMax || per_sm < 1 || per_sm > blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tier == kNarrowN) {
    // the narrow instantiations: two blocks an SM (bf16: the L form, the
    // dense form at small batches), four (the others)
    constexpr bool kTwo = kEsize == 2 && kForm != kFormX;
    constexpr bool kFour = !(kEsize == 2 && kForm == kFormL);
    if constexpr (kTwo)
      if (blocks == 2)
        return launch_tier<kForm, kNarrowN, T, 2>(
            F, G, b, x, B, K, n, ld, cluster, band_rows, stages, smem, stream);
    if constexpr (kFour)
      return launch_tier<kForm, kNarrowN, T, 4>(
          F, G, b, x, B, K, n, ld, cluster, band_rows, stages, smem, stream);
  }
  if constexpr (kForm == kFormL)
    if (tier == kMaxN)
      return launch_tier<kForm, kMaxN, T, 1>(F, G, b, x, B, K, n, ld, cluster,
                                             band_rows, stages, smem, stream);
  return launch_tier<kForm, kWideN, T, 1>(F, G, b, x, B, K, n, ld, cluster,
                                          band_rows, stages, smem, stream);
}


// ---- The wide tier of the X and L forms: one scenario over many SMs.
//
// A scenario's sweeps are 2K - 1 serial matvecs; on a cluster of at most 4
// blocks a small batch streams its factors on 2 to 8 of the 132 SMs (at
// n = 2052, B = 2, 1.1% of the stream bound for X, 0.6% for L).  The wide
// tier gives each scenario `spread` blocks of a cooperative grid (the whole
// card between the batch's scenarios): each block streams rows [lo, hi) of
// every factor block through its ring (the producer warp runs ahead across
// steps), and the step's vector lives in global memory, double-buffered
// (vbuf: 2 x B x n floats, one half a step parity), which a block reads
// from L2 after a barrier in global memory.
//   * X form: the consumers form the block's rows of the step's vector
//     (factor_ring's matvec_rows, as on the cluster tiers, so every row is
//     summed in the same order) and store them into the output and into
//     the vector; one barrier a step.
//   * L form: a step is w = Linv_k^T (Linv_k r).  A block holds few rows, so
//     every consumer thread works on every row of a band, on its column pairs
//     j = 2 tid + 2 kConsumers m: it forms its part of
//     y_i = Linv_k[i, :i+1] . r for the band's rows, kRows at a time, the
//     warps' sums meet in shared memory and are added in warp order
//     (band_dots_wide); then it adds Linv_k[i, j] y_i over the band's rows,
//     in row order, into register sums of the same pairs (band_cols).  So
//     both products come from one read of each band (in one warp a row and
//     then a block barrier, the dots set a band's time) and the block holds
//     the partials of Linv_k[lo:hi, :hi]^T y for the columns below hi.
//     They meet in a reduce-scatter: each block stores them (backward: w_k
//     of its own rows minus them) into scratch after the vectors in vbuf
//     (spread rows of n a scenario), the scenario's blocks meet at a
//     barrier, block g sums its own rows' partials over the
//     blocks g' >= g (the only ones whose rows reach them), warp w those
//     of g + w, g + w + kWarps, ... and then the warps in turn, stores the
//     rows into the output and the vector, and the scenario's blocks meet
//     again before the next step reads it.  (Every block summing the whole
//     vector itself after the first barrier instead, one barrier a step,
//     reads about spread n / 2 floats from L2 a block a step, and took
//     twice as long at n = 2052, B = 2.)  Every sum's order is fixed, so
//     two launches agree bit for bit (not with the cluster tiers, which sum
//     in another order).
// The barriers are words of the launch's own, after the scratch in vbuf, which
// the launcher zeroes on the launch's stream, so launches on other streams
// keep apart and a CUDA graph may replay the kernel.  The scenarios of a batch
// are independent, so a barrier joins only a scenario's blocks: one word a
// scenario counts their arrivals and is never reset (its p-th barrier is
// passed when it reaches p spread), so the last arrival itself lets the blocks
// pass.  Which (B, n) take this tier is the plan's choice (ops/group_solve.py
// sweep_wide); the launcher serves any plan it gets.
constexpr int kWideBarrierBytes = factor_ring::kBarrierBytes;
constexpr int kWideBlocksPerSm = 2;   // the launch bounds' blocks an SM
constexpr int kWideSlots = kMaxNWide / 3 / kConsumers;  // slot triples a thread

// The most rows any of `spread` blocks owns (row_lo's shares).
__host__ __device__ inline int wide_rows(int n, int spread) {
  return 2 * ((n / 2 + spread - 1) / spread);
}

// Dynamic shared memory of a wide plan: the ring's barriers, the ring (`stages`
// stages of `band_rows` rows of `row_bytes` bytes), then r (n) and w_k of the
// block's rows (`rows`), and in the L form y of a band and each warp's sums of
// a band's or the block's rows, all FP32.  ops/group_solve.py
// sweep_wide_smem_bytes mirrors it, and tests/test_torch_sweep_plan.py holds
// the two copies to each other.
__host__ __device__ inline long wide_smem_bytes(int n, int rows,
                                                int band_rows, int stages,
                                                int row_bytes, int form) {
  return (kWideBarrierBytes +
          (static_cast<long>(stages) * band_rows * row_bytes +
           4L * (n + rows +
                 (form != kFormX) * (kMaxBandRows + kWarps * rows))));
}

// FP32 words of a wide launch's vbuf: the step vectors (2, B, n); in the L
// form the blocks' column partials (B, spread, n); then the barriers' words,
// one a scenario.  ops/group_solve.py sweep_wide_vbuf_floats mirrors it.
__host__ __device__ inline long wide_vbuf_floats(int B, int n, int spread,
                                                 int form) {
  return (2L * B * n + (form != kFormX) * static_cast<long>(B) * spread * n +
          B);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The barrier of one scenario's `spread` blocks of a wide launch (here and
// in admm_fused_x.cu), on its word `word` (arrivals, never reset), in two
// halves: arrive() puts this block's stores behind a block barrier and
// adds its arrival; wait() waits until all spread blocks have arrived as
// often as this one has.  Called by every consumer thread.
struct ScenarioBarrier {
  unsigned* word;
  unsigned spread;
  unsigned passed;                     // barriers this block has passed
  __device__ void arrive() {
    consumer_sync();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(word, 1u);
    }
  }
  __device__ void wait() {
    if (threadIdx.x == 0) {
      ++passed;
      while (load_acquire(word) < passed * spread) {
      }
    }
    consumer_sync();
  }
};

// The three entries q, n2 + q, 2 n2 + q of a vector, as sweeps::slot_b and
// slot_bt index them (selects, so the three stay in registers).
struct SlotTriple {
  float a, p, v;
  int n2;
  __device__ float operator[](int j) const {
    return j < n2 ? a : j < 2 * n2 ? p : v;
  }
};

// F (B, K, n, ld) the X_k (X form) or Linv_k (L form); C9 (K-1, 9); b and x
// (B, K, n); vbuf wide_vbuf_floats(B, n, spread, kForm) words, the step
// vectors and the L form's partials; bar the barriers' words (a scenario's
// arrivals), zero at the launch.  A
// cooperative grid of B x spread blocks of kThreads threads, scenario
// blockIdx / spread, rows [lo, hi) of share blockIdx % spread.
template <int kForm, typename T>
__global__ void __launch_bounds__(kThreads, kWideBlocksPerSm)
sweep_kernel_wide(const T* __restrict__ F, const float* __restrict__ C9,
                  const float* __restrict__ bvec, float* xout, float* vbuf,
                  unsigned* bar, int K, int n, int ld, int spread,
                  int band_rows, int stages) {
  constexpr bool kL = kForm == kFormL;
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x / spread, g = blockIdx.x % spread;
  const int B = gridDim.x / spread, tid = threadIdx.x;
  const int lo = row_lo(g, spread, n), hi = row_lo(g + 1, spread, n);
  const int rows = wide_rows(n, spread);
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem4);
  const factor_ring::RingOf<T> ring{
      reinterpret_cast<T*>(raw + kWideBarrierBytes),
      factor_ring::smem_addr(raw), stages, band_rows * ld, ld};
  float* r = reinterpret_cast<float*>(
      ring.data + static_cast<size_t>(stages) * ring.stage_elems);
  float* wk = r + n;                   // w_k of rows lo .. hi-1
  float* ysh = wk + rows;              // L: y of a band's rows
  float* red = ysh + kMaxBandRows;     // L: [kWarps][rows], warps' row sums
  const size_t nsq = static_cast<size_t>(n) * ld;
  const T* Fb = F + static_cast<size_t>(b) * K * nsq;
  const float* bb = bvec + static_cast<size_t>(b) * K * n;
  float* xb = xout + static_cast<size_t>(b) * K * n;
  // L: the column partials of scenario b's blocks, spread rows of n
  float* part = kL ? vbuf + 2 * static_cast<size_t>(B) * n +
                         static_cast<size_t>(b) * spread * n
                   : nullptr;
  const int steps = 2 * K - 1;
  if (tid == 0) factor_ring::init(ring, kWarps);
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: this block's rows of every step's block
    factor_ring::Cursor cur{0, 0u};
    for (int t = 0; t < steps; ++t)
      factor_ring::produce_block(ring, cur,
                                 Fb + (t < K ? t : 2 * K - 2 - t) * nsq, lo,
                                 hi, band_rows);
    return;
  }

  // ---- consumer warps
  const int warp = tid >> 5, lane = tid & 31, n2 = n / 3;
  ScenarioBarrier barrier{bar + b, static_cast<unsigned>(spread), 0u};
  factor_ring::Cursor cur{0, 0u};
  for (int t = 0; t < steps; ++t) {
    const bool fwd = t < K;
    const int k = fwd ? t : 2 * K - 2 - t;
    // what the step reads of b_k, or of w_k in its rows, does not wait for
    // the vector: load it before the barrier
    float pre[kWideSlots][3];
#pragma unroll
    for (int u = 0; u < kWideSlots; ++u) {
      const int q = tid + u * kConsumers;
#pragma unroll
      for (int s = 0; s < 3; ++s)
        pre[u][s] = fwd && q < n2 ? __ldg(bb + k * n + s * n2 + q) : 0.f;
    }
    if (!fwd)
      for (int i = lo + tid; i < hi; i += kConsumers)
        wk[i - lo] = xb[k * n + i];
    // every block's rows of step t - 1 are in vbuf
    if (t > 0) barrier.wait();
    const float* v = vbuf + (static_cast<size_t>((t + 1) & 1) * B + b) * n;
    const int ck = fwd ? k - 1 : k;           // B_k = C_{k-1} (x) I
    const float* c = C9 + (ck > 0 ? ck : 0) * 9;
#pragma unroll
    for (int u = 0; u < kWideSlots; ++u) {
      const int q = tid + u * kConsumers;
      if (q >= n2) break;
      if (t == 0) {
#pragma unroll
        for (int s = 0; s < 3; ++s) r[s * n2 + q] = pre[u][s];
        continue;
      }
      // read from L2: other blocks wrote it
      const SlotTriple vq{__ldcg(v + q), __ldcg(v + n2 + q),
                          __ldcg(v + 2 * n2 + q), n2};
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int j = s * n2 + q;
        r[j] = fwd ? pre[u][s] - sweeps::slot_b(c, vq, j, n2)
                   : sweeps::slot_bt(c, vq, j, n2);
      }
    }
    consumer_sync();
    float* vo = vbuf + (static_cast<size_t>(t & 1) * B + b) * n;
    if constexpr (!kL) {
      factor_ring::matvec_rows(
          ring, cur, r, n, lo, hi, band_rows, false, warp, kWarps,
          [&](int i, float d) {
            const float val = fwd ? d : wk[i - lo] - d;
            xb[k * n + i] = val;
            vo[i] = val;
          });
      if (t + 1 < steps) barrier.arrive();
    } else {
      // ---- L: both products from one read of each band
      float2 acc[kWidePairs];
#pragma unroll
      for (int m = 0; m < kWidePairs; ++m) acc[m] = make_float2(0.f, 0.f);
      for (int r0 = lo; r0 < hi; r0 += band_rows) {
        const int r1 = r0 + band_rows < hi ? r0 + band_rows : hi;
        const T* M = factor_ring::acquire(ring, cur);
        band_dots_wide(M, r0, r1, ld, r, tid, red, rows);
        consumer_sync();
        if (tid < r1 - r0) {
          float y = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) y += red[w * rows + tid];
          ysh[tid] = y;
        }
        consumer_sync();
        band_cols(M, r0, r1, ld, ysh, tid, acc);
        factor_ring::release(ring, cur);
      }
      // the block's partials of the columns below hi; backward, w_k of its
      // own rows minus them (j and hi even: a pair lies below hi whole)
      float* mine = part + static_cast<size_t>(g) * n;
#pragma unroll
      for (int m = 0; m < kWidePairs; ++m) {
        if (2 * kConsumers * m >= hi) break;
        const int j = 2 * tid + 2 * kConsumers * m;
        if (j >= hi) continue;
        float2 s = acc[m];
        if (!fwd) {
          const bool own = j >= lo;
          s.x = (own ? wk[j - lo] : 0.f) - s.x;
          s.y = (own ? wk[j + 1 - lo] : 0.f) - s.y;
        }
        *reinterpret_cast<float2*>(mine + j) = s;
      }
      barrier.arrive();
      barrier.wait();
      // reduce-scatter: this block's rows, over the blocks g' >= g
      for (int i = lo + lane; i < hi; i += 32) {
        float s = 0.f;
#pragma unroll 4
        for (int q = g + warp; q < spread; q += kWarps)
          s += __ldcg(part + static_cast<size_t>(q) * n + i);
        red[warp * rows + i - lo] = s;
      }
      consumer_sync();
      for (int i = lo + tid; i < hi; i += kConsumers) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w * rows + i - lo];
        xb[k * n + i] = s;
        vo[i] = s;
      }
      if (t + 1 < steps) barrier.arrive();
    }
  }
}

// Launch the wide tier of form kForm (X or L) on its plan (spread, band_rows,
// stages, per_sm) as one cooperative grid, which the runtime refuses (an error
// code, no launch) where its blocks cannot all be resident at once; vbuf
// wide_vbuf_floats FP32 words, the last B the barriers', zeroed
// here on `stream`.  Returns a CUDA error code, cudaErrorInvalidValue for
// arguments or a plan it cannot serve.
template <int kForm, typename T>
int launch_wide(const T* F, const float* C9, const float* b, float* x,
                float* vbuf, int B, int K, int n, int ld, int spread,
                int band_rows, int stages, int per_sm, cudaStream_t stream) {
  static_assert(kForm == kFormX || kForm == kFormL, "no wide dense form");
  const int row_bytes = static_cast<int>(sizeof(T)) * ld;
  if (B < 1 || K < 2 || n < 6 || n % 6 || n > kMaxNWide || ld < n ||
      (2 * row_bytes) % 16 || spread < 1 || 2 * spread > n ||
      band_rows < 2 || band_rows % 2 || band_rows > kMaxBandRows ||
      stages < 2 || stages > factor_ring::kMaxStages || per_sm < 1 ||
      per_sm > kWideBlocksPerSm || (reinterpret_cast<size_t>(F) & 15) ||
      (reinterpret_cast<size_t>(vbuf) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const long smem = wide_smem_bytes(n, wide_rows(n, spread), band_rows,
                                    stages, row_bytes, kForm);
  if (smem > kSmemMax || per_sm * (smem + 1024) > kSmemMax + 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kDevices = 64;
  static long allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(sweep_kernel_wide<kForm, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) allowed[dev] = smem;
  }
  unsigned* bar = reinterpret_cast<unsigned*>(
      vbuf + wide_vbuf_floats(B, n, spread, kForm) - B);
  err = cudaMemsetAsync(bar, 0, B * sizeof(unsigned), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * spread));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sweep_kernel_wide<kForm, T>, F, C9, b, x,
                           vbuf, bar, K, n, ld, spread, band_rows, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace group_sweep
