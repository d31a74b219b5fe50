// Interior Newton-Schulz chain of the X-form block factorization, for Hopper.
//
// Replaces the Pallas TPU kernel ba_path_planning_tpu/ops/pallas/ns_chain.py
// (_ns_chain_kernel, launched by factorize_X_chain_batched in
// ba_path_planning_torch/ops/ns_chain.py).  For every scenario b
// and interior step k = k_begin .. k_end-1 it computes
//
//     S_k = D_k - (C_k (x) I) X_{k-1} (C_k (x) I)^T
//     X  <- X_{k-1};  repeat ns_iters times:  X <- 2 X - X (S_k X)
//     X_k = (X + X^T) / 2
//
// with C_k the 3x3 slot scalars of the off-diagonal block, read from a
// (K-1, 9) table at row k-1.
//
// What bounds it: compute.  Each NS iteration is two n x n matrix products,
// T' = X S whole (2 n^3 flops) and the symmetric update on and above the
// diagonal (n (n + 1)^2); with S_k's 13 n^2 a step, at n = 6N = 120 and 2
// iterations that is 10.6 MFLOP per step and about 0.49 GFLOP per scenario
// over the 46 interior steps of K = 50 (3.9 GFLOP at N = 40;
// utils/profiling.ns_chain_interior_flops).  The chain is serial in k.
// Two tiers, chosen by the plan from (B, n) (ops/ns_chain.py
// ns_chain_plan, which passes its tile to ns_chain_interior_f32):
//   * one block a scenario (large batches, the production chunks): the
//     parallelism is the batch; a block walks k serially (the TPU grid's k
//     axis becomes a loop; nothing carries between blocks on this card);
//   * the wide tier (a batch too small to fill the card, say one scenario
//     at N = 40 or two at N = 342, where one block a scenario used 2 of 132
//     SMs): each step is spread over the card, one launch for S_k (a
//     thread a slot pair) and one for each product, a block an output tile
//     of 64 x 64, 128 x 128 or 192 x 192, whichever fills the card in the
//     least time by the plan's wave cost.  The product depth stays whole
//     in a block, so every element is summed in the order of the one-block
//     tier, bit for bit; X ping-pongs between two buffers of the streamed
//     layout's scratch, since other blocks still read X while the update
//     is written.
//     1 + 2 ns_iters launches a step (231 a call at K = 50, ns_iters = 2).
//
// Two precisions, as SolverStatic.ns_precision names them, in one kernel:
// the tiling, the layouts, the symmetry and the epilogues below are shared,
// and only the inner product of a warp's panel differs.
//
// "high" (the production solver): the products run on the tensor cores.
//   * Tensor-core operation: mma.sync.aligned.m16n8k8 with TF32 operands
//     and FP32 accumulators, run by 16 warps (four warpgroups) a block,
//     fragments fetched with ldmatrix.  wgmma was not taken: it reads both
//     operands of a pass from shared memory, so hi and lo would each need
//     a copy there, and at n = 120 shared memory holds X, S and T' once,
//     not twice; nor can its descriptors and swizzled layouts be rehearsed
//     without the card.
//   * Split: every FP32 operand is a = hi + lo with hi = a rounded to TF32
//     (10 mantissa bits, ties away from zero) and lo = a - hi, of which the
//     tensor core reads the leading TF32 bits; a product is the three
//     passes lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 relative, is dropped).
//     This is the card's counterpart of JAX's "high".  Both products of an
//     iteration take the full split: a single TF32 pass leaves the chain
//     outside its 1e-4 tolerance (tests/test_torch_ns_precision.py).  The
//     split is done in registers when a fragment is loaded (three
//     integer/FP32 operations an element): at n = 120 shared memory
//     holds X, S and T once, not a hi and a lo copy of each.
//   * Sums: the tensor core adds into its accumulator by truncation, and
//     over the 15 to 30 steps of a product that bias made X 2.5 times as
//     far from float64 as FP32 FMAs do (and an SCP step 2.8 times).  So
//     the three passes of each 8-deep step start from zero and the steps
//     are summed by FP32 adds in registers: then the chain is closer to
//     float64 than the FP32 path, for 8-16% more time.
//   * Both operands K-major without a transpose: S and X are symmetric, so
//     T' = X S (= (S X)^T) is computed first, and X (S X) = X T'^T reads
//     T' by rows as the "col" operand.
//   * Symmetry: only the warp tiles on or above the diagonal of X T'^T are
//     computed; the epilogue forms 2X - X T'^T there and stores it to (i, j)
//     and (j, i), which is the symmetrize step, and on the last iteration
//     to X_k as well.  The warps are laid over the 4 x 4 tile grid so that
//     every SM sub-partition keeps at most three of the ten live tiles.
//   * S_k is built in one pass, a thread per (i mod n/3, j mod n/3) pair
//     forming its 3 x 3 slot block C Xs C^T: no division per element.
//   * Layouts, from n.  Resident (n <= 128, N <= 21): X, S, T' as 128-row
//     tiles in shared memory, row strides of 4 mod 8 floats so that
//     fragment loads are free of bank conflicts; one 128 x 128 output tile,
//     32 x 32 a warp; the update is written in place after a barrier.
//     Hybrid (n <= 192, N <= 32): X stays in shared memory as the first
//     operand of both products and is updated in place; S and T' live in a
//     per-scenario global scratch (L2-sized for a batch of 128) and come in
//     as the second operand in 16-deep panels through a four-stage
//     shared-memory ring filled by cp.async, three panels in flight ahead
//     of the one in use; one 192 x 192 output tile, 48 x 48 a warp.
//     Streamed (n > 192): X no longer fits beside the ring, so S, T' and
//     two X buffers live in the scratch and both operands come through the
//     ring; output tiles of 128 rows, up to 256 wide (N = 40: 240 in two
//     row tiles, 32 x 64 a warp).  Ragged edges are zero-filled on the way
//     in and masked on the way out.  Beyond n = 192 the kernel is bound by
//     the traffic of the scratch (0.9 MB a scenario, 118 MB at B = 128,
//     more than the L2 holds), not by the tensor cores.
//
// "highest": the exact-FP32 witness that the checks hold "high" against.
//   The same warp tiles, filled by FP32 FMAs on the CUDA cores: each lane
//   keeps the entries that the tensor-core fragments would give it and
//   reads its rows of both operands from shared memory four columns at a
//   time.  No production path runs it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;            // 16 warps as a 4 x 4 grid of tiles
constexpr int kKP = 16;                  // streamed operands: panel depth
constexpr int kKPad = kKP + 4;           // panel row in shared memory
constexpr int kStages = 4;               // ring of panels
// warp -> cell (4 row + column) of the 4 x 4 grid, one nibble a warp: warps
// w, w + 4, w + 8, w + 12 share a sub-partition, and each of these sets
// holds at most three cells on or above the diagonal.
constexpr unsigned long long kWarpCells = 0xe984dc7b6321fa50ULL;

// Where the operands of a product live.
enum Layout {
  kResident,   // X, S, T' in shared memory (n <= 128)
  kHybrid,     // X in shared memory, S and T' streamed (n <= 192)
  kStreamed    // X, S, T' streamed from the global scratch
};

// a = hi + lo: hi is a rounded to TF32 (ties away from zero, as cvt.rna),
// lo the exact remainder, of which the tensor core reads the leading TF32
// bits (at most 2^-21 |a| is lost).
__device__ __forceinline__ void split_tf32(unsigned a, unsigned& hi,
                                           unsigned& lo) {
  hi = (a + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(a) - __uint_as_float(hi));
}

// Four 8 x 4 blocks of 32-bit words from shared memory, one row address a
// lane: lane l gets word l % 4 of row l / 4 of each block.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d = a b for a 16 x 8 (row) and b 8 x 8 (col) TF32 fragments.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c += a b for a 16 x 8 (row) and b 8 x 8 (col) TF32 fragments.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// acc += As Bs^T over `kdepth` columns for one warp: As is the warp's
// (16 MT) x kdepth rows (stride lda) and Bs its (8 nt) x kdepth rows of the
// K-major second operand (stride ldb, rows up to 8 NT readable), both in
// shared memory with 16-byte aligned rows and strides of 4 mod 8 floats, so
// that the eight rows of an ldmatrix block fall on distinct banks.  Each
// fragment is split as it is loaded and used for the three passes of its
// 8-deep step; the steps are summed in FP32 registers.  NT is even.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_panel(const float* As, int lda,
                                               const float* Bs, int ldb,
                                               int kdepth, int nt,
                                               float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, blk = lane >> 3, r8 = lane & 7;
  // A: blocks (rows 0-7, k 0-3), (rows 8-15, k 0-3), (rows 0-7, k 4-7),
  // (rows 8-15, k 4-7) = a0..a3; B: (n 0-7, k 0-3), (n 0-7, k 4-7) = b0, b1
  // of one 8-column tile, then the same of the next tile
  const float* pa = As + (r8 + (blk & 1) * 8) * lda + (blk >> 1) * 4;
  const float* pb = Bs + (r8 + (blk >> 1) * 8) * ldb + (blk & 1) * 4;
  for (int k0 = 0; k0 < kdepth; k0 += 8) {
    unsigned ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      unsigned raw[4];
      ldmatrix_x4(raw, pa + m * 16 * lda + k0);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(raw[e], ah[m][e], al[m][e]);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        unsigned raw[4], bh[4], bl[4];
        ldmatrix_x4(raw, pb + j * 8 * ldb + k0);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(raw[e], bh[e], bl[e]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (j + jj < nt) {
            // the three passes of this 8-deep step start from zero and
            // are added to the running sum by an FP32 add: the tensor
            // core's own accumulation truncates, which biases a long sum
            float part[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              mma_tf32_zero(part[m], al[m], bh[2 * jj], bh[2 * jj + 1]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              mma_tf32(part[m], ah[m], bl[2 * jj], bl[2 * jj + 1]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              mma_tf32(part[m], ah[m], bh[2 * jj], bh[2 * jj + 1]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][j + jj][e] += part[m][e];
          }
        }
      }
    }
  }
}

// The same sum by FP32 FMAs, for "highest": lane 4 g + t keeps rows g and
// g + 8 and columns 2 t and 2 t + 1 of every 16 x 8 tile, as in the
// tensor-core fragments, and reads its rows of As and Bs as float4.
template <int MT, int NT>
__device__ __forceinline__ void warp_fma_panel(const float* As, int lda,
                                               const float* Bs, int ldb,
                                               int kdepth, int nt,
                                               float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
  const float* pa = As + (lane >> 2) * lda;
  const float* pb = Bs + 2 * (lane & 3) * ldb;
  for (int k0 = 0; k0 < kdepth; k0 += 4) {
    float4 a[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[m][h] = *reinterpret_cast<const float4*>(
            pa + (m * 16 + h * 8) * lda + k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        float4 b[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          b[c] = *reinterpret_cast<const float4*>(pb + (j * 8 + c) * ldb + k0);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float v = acc[m][j][2 * h + c];
              v = fmaf(a[m][h].x, b[c].x, v);
              v = fmaf(a[m][h].y, b[c].y, v);
              v = fmaf(a[m][h].z, b[c].z, v);
              v = fmaf(a[m][h].w, b[c].w, v);
              acc[m][j][2 * h + c] = v;
            }
      }
    }
  }
}

template <int MT, int NT, bool kTensor>
__device__ __forceinline__ void warp_panel(const float* As, int lda,
                                           const float* Bs, int ldb,
                                           int kdepth, int nt,
                                           float (&acc)[MT][NT][4]) {
  if constexpr (kTensor)
    warp_mma_panel<MT, NT>(As, lda, Bs, ldb, kdepth, nt, acc);
  else
    warp_fma_panel<MT, NT>(As, lda, Bs, ldb, kdepth, nt, acc);
}

// epi.prepare and then epi.store (i, j, v0, v1) for (A Bt^T)[i, j] and
// [i, j + 1], j even, over the output tile at (r0, c0) of n x n matrices of
// row strides lda and ldb; with `upper` only the warp tiles that reach the
// diagonal or lie above it.  Output tiles are (64 MT) x (up to 32 NT), a
// warp owning (16 MT) x (8 nt) of each.  An operand in shared memory (both
// when kResident, A when kHybrid) is a tile of 64 MT rows, zero beyond n up
// to the next multiple of kKP.  A streamed operand is in global memory
// (columns n .. ld-1 zero, ld a multiple of 4) and comes through `ring` in
// panels of kKP columns, rows beyond n zero-filled.  Every thread of the
// block must call it: it synchronizes, and all of the block's reads of A
// and Bt are done before the first call of epi.  Each element is summed
// over k in the same order whatever the tile's shape or place.
template <int MT, int NT, Layout kLayout, bool kTensor, typename Epi>
__device__ __forceinline__ void product_tile(const float* A, int lda,
                                             const float* Bt, int ldb, int n,
                                             bool upper, int r0, int c0,
                                             float* ring, Epi epi) {
  constexpr int TM = 4 * MT * 16, TN = 4 * NT * 8;
  constexpr int kRingA = kLayout == kStreamed ? TM : 0;   // A rows of a stage
  constexpr int kStageFloats = (kRingA + TN) * kKPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cell = static_cast<int>(kWarpCells >> (4 * warp)) & 15;
  const int wr = cell >> 2, wc = cell & 3;
  const int width = n - c0 < TN ? n - c0 : TN;
  const int nt = (width + 31) / 32;          // 8-column tiles a warp
  const int row_w = r0 + wr * MT * 16, col_w = c0 + wc * nt * 8;
  const bool active = row_w < n && col_w < n &&
                      !(upper && col_w + nt * 8 <= row_w);
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  if (kLayout == kResident) {
    if (active)
      warp_panel<MT, NT, kTensor>(A + row_w * lda, lda,
                                  Bt + col_w * ldb, ldb, (n + 7) & ~7,
                                  nt, acc);
  } else {
    const int npan = (n + kKP - 1) / kKP;
    const int rows = kRingA + 4 * nt * 8;    // A rows, then Bt rows
    auto load = [&](int p) {
      float* stage = ring + (p % kStages) * kStageFloats;
      for (int c = threadIdx.x; c < rows * (kKP / 4); c += kThreads) {
        const int row = c / (kKP / 4), q = c % (kKP / 4);
        const bool is_a = row < kRingA;
        const int grow = is_a ? r0 + row : c0 + row - kRingA;
        const int gk = p * kKP + 4 * q, ld = is_a ? lda : ldb;
        const bool ok = grow < n && gk < ld;
        const float* src = (is_a ? A : Bt) + (ok ? grow * ld + gk : 0);
        cp_async16(stage + row * kKPad + 4 * q, src, ok ? 16 : 0);
      }
    };
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < npan) load(s);
      cp_async_commit();
    }
    for (int p = 0; p < npan; ++p) {
      cp_async_wait<kStages - 2>();          // panel p has landed
      __syncthreads();                       // and panel p-1 is consumed
      if (p + kStages - 1 < npan) load(p + kStages - 1);
      cp_async_commit();
      if (active) {
        const float* stage = ring + (p % kStages) * kStageFloats;
        const float* sb = stage + (kRingA + wc * nt * 8) * kKPad;
        if (kLayout == kStreamed)
          warp_panel<MT, NT, kTensor>(stage + wr * MT * 16 * kKPad,
                                      kKPad, sb, kKPad, kKP, nt, acc);
        else
          warp_panel<MT, NT, kTensor>(A + row_w * lda + p * kKP, lda,
                                      sb, kKPad, kKP, nt, acc);
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();
  if (active) {
    // all loads of the epilogue first, then all stores, so that no
    // load waits behind a store it might alias
    const int g = lane >> 2, t = lane & 3;
    const int i0 = row_w + g, j0 = col_w + 2 * t;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          epi.prepare(i0 + m * 16, j0 + j * 8, acc[m][j][0], acc[m][j][1]);
          epi.prepare(i0 + m * 16 + 8, j0 + j * 8, acc[m][j][2],
                      acc[m][j][3]);
        }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          epi.store(i0 + m * 16, j0 + j * 8, acc[m][j][0], acc[m][j][1]);
          epi.store(i0 + m * 16 + 8, j0 + j * 8, acc[m][j][2],
                    acc[m][j][3]);
        }
  }
}

// product_tile over every tile of the product, by rows; with `upper` a
// row of tiles starts at its first row.
template <int MT, int NT, Layout kLayout, bool kTensor, typename Epi>
__device__ __forceinline__ void tile_product(const float* A, int lda,
                                           const float* Bt, int ldb, int n,
                                           bool upper, float* ring, Epi epi) {
  constexpr int TM = 4 * MT * 16, TN = 4 * NT * 8;
  for (int r0 = 0; r0 < n; r0 += TM)
    for (int c0 = upper ? r0 : 0; c0 < n; c0 += TN)
      product_tile<MT, NT, kLayout, kTensor>(A, lda, Bt, ldb, n, upper, r0,
                                             c0, ring, epi);
}

// Epilogue of T' = X S: store the pair (i, j), (i, j + 1).
struct StorePair {
  float* T;
  int ld, n;
  __device__ void prepare(int, int, float&, float&) const {}
  __device__ void store(int i, int j, float v0, float v1) const {
    if (i < n && j < n)
      *reinterpret_cast<float2*>(T + i * ld + j) = make_float2(v0, v1);
  }
};

// Epilogue of the Newton-Schulz update on and above the diagonal:
// 2 X - X T'^T to Xn[i, j] and Xn[j, i], and to the n x n output Xk if given.
// Xn may be X itself: the only entries below the diagonal that are read
// belong to pairs that straddle it, and their values are not used.
struct NewtonPair {
  const float* X;
  float* Xn;
  float* Xk;
  int ld, n;
  __device__ void prepare(int i, int j, float& v0, float& v1) const {
    if (i >= n || j >= n || j + 1 < i) return;
    const float2 x = *reinterpret_cast<const float2*>(X + i * ld + j);
    v0 = 2.f * x.x - v0;
    v1 = 2.f * x.y - v1;
  }
  __device__ void store(int i, int j, float v0, float v1) const {
    if (i >= n || j >= n || j + 1 < i) return;
    put(Xn, ld, i, j, v0, v1);
    if (Xk) put(Xk, n, i, j, v0, v1);
  }
  // (i, j) and (i, j + 1) and their mirrors, where on or above the diagonal
  static __device__ void put(float* M, int ld, int i, int j, float v0,
                             float v1) {
    if (j >= i) {
      *reinterpret_cast<float2*>(M + i * ld + j) = make_float2(v0, v1);
      M[j * ld + i] = v0;
    } else {
      M[i * ld + j + 1] = v1;
    }
    M[(j + 1) * ld + i] = v1;
  }
};

// S = D_k - (C (x) I) X (C (x) I)^T at the slot pair (ii, jj): the 3 x 3
// slot block C Xs C^T of Xs[t][u] = X[t n2 + ii, u n2 + jj].  X has row
// stride ldx, S row stride lds, D_k row stride 3 n2.
__device__ __forceinline__ void schur_pair(const float* X, int ldx,
                                           const float* __restrict__ Dk,
                                           const float (&cc)[9], float* S,
                                           int lds, int n2, int ii, int jj) {
  float y[3][3];                        // y[t][sj] = sum_u c[sj, u] Xs[t][u]
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float* xr = X + (t * n2 + ii) * ldx + jj;
    const float x0 = xr[0], x1 = xr[n2], x2 = xr[2 * n2];
#pragma unroll
    for (int sj = 0; sj < 3; ++sj)
      y[t][sj] = fmaf(cc[sj * 3 + 2], x2,
                      fmaf(cc[sj * 3 + 1], x1, cc[sj * 3] * x0));
  }
#pragma unroll
  for (int si = 0; si < 3; ++si)
#pragma unroll
    for (int sj = 0; sj < 3; ++sj) {
      const float w = fmaf(cc[si * 3 + 2], y[2][sj],
                           fmaf(cc[si * 3 + 1], y[1][sj],
                                cc[si * 3] * y[0][sj]));
      const int i = si * n2 + ii, j = sj * n2 + jj;
      S[i * lds + j] = Dk[i * 3 * n2 + j] - w;
    }
}

// S = D_k - (C (x) I) X (C (x) I)^T over the block's threads, a thread per
// (ii, jj) pair (schur_pair: no division per element); c the 9 slot
// scalars of C.
__device__ void schur_slots(const float* X, int ldx,
                            const float* __restrict__ Dk,
                            const float* __restrict__ c, float* S, int lds,
                            int n) {
  const int n2 = n / 3;
  float cc[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) cc[q] = c[q];
  for (int idx = threadIdx.x; idx < n2 * n2; idx += blockDim.x) {
    const int ii = idx / n2;
    schur_pair(X, ldx, Dk, cc, S, lds, n2, ii, idx - ii * n2);
  }
}

// Row stride of a matrix in shared memory: room for every kKP-deep panel,
// and 4 mod 8 floats.
int smem_leading_dim(int n) { return (n + kKP - 1) / kKP * kKP + 4; }

// Row stride of a matrix in the global scratch: 16-byte rows.
int scratch_leading_dim(int n) { return (n + 3) / 4 * 4; }

// The chain, with its products on the tensor cores (kTensor) or as FP32
// FMAs.  The dynamic shared memory holds the panel ring (not kResident),
// then the matrices that live there: X (64 MT rows of stride lds; also S and
// T' when kResident).  The others are this scenario's part of `scratch`,
// ldg x ldg each: S, T' (kHybrid), and two X buffers that change roles at
// every update (kStreamed).
template <int MT, int NT, Layout kLayout, bool kTensor>
__global__ void __launch_bounds__(kThreads, 1)
ns_chain_kernel(const float* __restrict__ D, const float* __restrict__ C9,
                float* Xall, float* scratch, int K, int n, int lds, int ldg,
                int k_begin, int k_end, int ns_iters) {
  constexpr int TM = 4 * MT * 16, TN = 4 * NT * 8;
  constexpr int kRingFloats =
      kLayout == kResident
          ? 0
          : kStages * ((kLayout == kStreamed ? TM : 0) + TN) * kKPad;
  constexpr int kInSmem = kLayout == kResident ? 3 : kLayout == kHybrid;
  constexpr int kInScratch = kLayout == kResident ? 0
                             : kLayout == kHybrid ? 2 : 4;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* tiles = ring + kRingFloats;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nn_s = TM * lds, nn_g = ldg * ldg;
  float* gbase = scratch + static_cast<size_t>(b) * kInScratch * nn_g;
  // X, S, T' and their strides
  float* X = kLayout == kStreamed ? gbase + 2 * nn_g : tiles;
  float* Xn = kLayout == kStreamed ? X + nn_g : X;   // else updated in place
  float* S = kLayout == kResident ? tiles + nn_s : gbase;
  float* T = kLayout == kResident ? tiles + 2 * nn_s : gbase + nn_g;
  const int ldx = kLayout == kStreamed ? ldg : lds;
  const int ldst = kLayout == kResident ? lds : ldg;
  const size_t nsq = static_cast<size_t>(n) * n;
  float* Xb = Xall + static_cast<size_t>(b) * K * nsq;
  const float* Db = D + static_cast<size_t>(b) * K * nsq;

  // zero what no store reaches: the tiles in shared memory, and the
  // columns n .. ldg-1 of the matrices in the scratch; then the warm start
  for (int idx = tid; idx < kInSmem * nn_s; idx += kThreads)
    tiles[idx] = 0.f;
  const int pad = ldg - n;
  for (int idx = tid; idx < kInScratch * ldg * pad; idx += kThreads)
    gbase[(idx / pad) * ldg + n + idx % pad] = 0.f;
  __syncthreads();
  {
    const float* X0 = Xb + (k_begin - 1) * nsq;
    for (int i = tid >> 5; i < n; i += kThreads / 32)
      for (int j = tid & 31; j < n; j += 32) X[i * ldx + j] = X0[i * n + j];
  }
  __syncthreads();

  for (int k = k_begin; k < k_end; ++k) {
    schur_slots(X, ldx, Db + k * nsq, C9 + (k - 1) * 9, S, ldst, n);
    if (k + 1 < k_end) {                 // bring D_{k+1} into L2 meanwhile
      const float* Dn = Db + (k + 1) * nsq;
      for (size_t o = static_cast<size_t>(tid) * 32; o < nsq;
           o += kThreads * 32)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(Dn + o));
    }
    __syncthreads();
    for (int it = 0; it < ns_iters; ++it) {
      tile_product<MT, NT, kLayout, kTensor>(X, ldx, S, ldst, n, false,
                                             ring, StorePair{T, ldst, n});
      __syncthreads();
      float* Xk = it == ns_iters - 1 ? Xb + k * nsq : nullptr;
      tile_product<MT, NT, kLayout, kTensor>(
          X, ldx, T, ldst, n, true, ring, NewtonPair{X, Xn, Xk, ldx, n});
      __syncthreads();
      if (kLayout == kStreamed) {
        float* tmp = X;
        X = Xn;
        Xn = tmp;
      }
    }
  }
}

// Matrices of ldg^2 floats a scenario needs in the global scratch.
int scratch_matrices(int n) { return n <= 128 ? 0 : n <= 192 ? 2 : 4; }

template <int MT, int NT, Layout kLayout, bool kTensor>
int launch_chain(const float* D, const float* C9, float* Xall,
                 float* scratch, int B, int K, int n, int k_begin, int k_end,
                 int ns_iters, cudaStream_t stream) {
  constexpr int TM = 4 * MT * 16, TN = 4 * NT * 8;
  const int lds = smem_leading_dim(n), ldg = scratch_leading_dim(n);
  const size_t ring = kLayout == kResident
                          ? 0
                          : static_cast<size_t>(kStages) *
                                ((kLayout == kStreamed ? TM : 0) + TN) * kKPad;
  const size_t tiles = kLayout == kResident ? 3 : kLayout == kHybrid;
  const size_t smem = (ring + tiles * TM * lds) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ns_chain_kernel<MT, NT, kLayout, kTensor>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_chain_kernel<MT, NT, kLayout, kTensor><<<B, kThreads, smem, stream>>>(
      D, C9, Xall, scratch, K, n, lds, ldg, k_begin, k_end, ns_iters);
  return static_cast<int>(cudaGetLastError());
}

// ---- The wide tier: each step of a scenario spread over the card.
//
// A scenario's scratch is the streamed layout's, four matrices of ldg x
// ldg: S, T', then the two X buffers; the update reads one X buffer and
// writes the other, so no block overwrites what another still reads.
constexpr int kWideS = 0, kWideT = 1, kWideX = 2;

// Output tiles of TM x TN of an n x n product: all of them, or (upper)
// those that tile_product visits for the update, each row of tiles
// starting at its first row.
int tile_count(int n, int TM, int TN, bool upper) {
  int count = 0;
  for (int r0 = 0; r0 < n; r0 += TM)
    count += (n - (upper ? r0 : 0) + TN - 1) / TN;
  return count;
}

// The origin (r0, c0) of output tile t in tile_count's order.
template <int TM, int TN>
__device__ __forceinline__ void tile_origin(int t, int n, bool upper,
                                            int& r0, int& c0) {
  r0 = 0;
  for (;;) {
    const int cols = (n - (upper ? r0 : 0) + TN - 1) / TN;
    if (t < cols) break;
    t -= cols;
    r0 += TM;
  }
  c0 = (upper ? r0 : 0) + t * TN;
}

// The warm start X_{k_prev} into X buffer 0 of each scenario, and zeros in
// the columns n .. ldg-1 of its four matrices (which no store reaches):
// a block a row, grid (n, B).
__global__ void __launch_bounds__(256)
ns_wide_start(float* scratch, const float* __restrict__ Xall, int K, int n,
              int ldg, int k_prev) {
  const size_t nn = static_cast<size_t>(ldg) * ldg;
  float* base = scratch + static_cast<size_t>(blockIdx.y) * 4 * nn;
  const int i = blockIdx.x;
  const float* src = Xall + (static_cast<size_t>(blockIdx.y) * K + k_prev) *
                                static_cast<size_t>(n) * n +
                     static_cast<size_t>(i) * n;
  for (int j = threadIdx.x; j < ldg; j += blockDim.x) {
    if (j < n) {
      base[kWideX * nn + static_cast<size_t>(i) * ldg + j] = src[j];
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        base[m * nn + static_cast<size_t>(i) * ldg + j] = 0.f;
    }
  }
}

// S_k of each scenario from its X buffer `xbuf`: a thread a slot pair,
// grid (pair blocks, B).
__global__ void __launch_bounds__(256)
ns_wide_schur(float* scratch, int xbuf, const float* __restrict__ D,
              const float* __restrict__ C9, int K, int n, int ldg, int k) {
  const int n2 = n / 3;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n2 * n2) return;
  const size_t nn = static_cast<size_t>(ldg) * ldg;
  float* base = scratch + static_cast<size_t>(blockIdx.y) * 4 * nn;
  float cc[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) cc[q] = C9[(k - 1) * 9 + q];
  const int ii = idx / n2;
  schur_pair(base + xbuf * nn, ldg, D + (static_cast<size_t>(blockIdx.y) *
                                         K + k) * static_cast<size_t>(n) * n,
             cc, base + kWideS * nn, ldg, n2, ii, idx - ii * n2);
}

// One output tile a block, grid (tiles, B), of a product of one scenario's
// matrices (indices into its scratch): T' = X S (kUpdate false: a = X, bt
// = S, out = T'), or the Newton-Schulz update 2 X - X T'^T on and above
// the diagonal, mirrored (kUpdate: a = X, bt = T', out the other X buffer;
// also into X_{k_out} of Xall where k_out >= 0).
template <int MT, int NT, bool kTensor, bool kUpdate>
__global__ void __launch_bounds__(kThreads, 1)
ns_wide_product(float* scratch, int a, int bt, int out, float* Xall, int K,
                int n, int ldg, int k_out) {
  constexpr int TM = 4 * MT * 16, TN = 4 * NT * 8;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const size_t nn = static_cast<size_t>(ldg) * ldg;
  float* base = scratch + static_cast<size_t>(blockIdx.y) * 4 * nn;
  const float* A = base + a * nn;
  const float* Bt = base + bt * nn;
  float* O = base + out * nn;
  int r0, c0;
  tile_origin<TM, TN>(blockIdx.x, n, kUpdate, r0, c0);
  if constexpr (kUpdate) {
    float* Xk = k_out < 0 ? nullptr
                          : Xall + (static_cast<size_t>(blockIdx.y) * K +
                                    k_out) * static_cast<size_t>(n) * n;
    product_tile<MT, NT, kStreamed, kTensor>(A, ldg, Bt, ldg, n, true, r0, c0,
                                             ring, NewtonPair{A, O, Xk, ldg,
                                                              n});
  } else {
    product_tile<MT, NT, kStreamed, kTensor>(A, ldg, Bt, ldg, n, false, r0,
                                             c0, ring, StorePair{O, ldg, n});
  }
}

// The wide tier in tiles of (64 MT) x (32 NT), square (NT = 2 MT): per
// step one launch for S_k and two for each Newton-Schulz iteration, the
// last writing X_k.  (3, 6) takes 128 registers and spills none.
template <int MT, int NT, bool kTensor>
int launch_wide(const float* D, const float* C9, float* Xall, float* scratch,
                int B, int K, int n, int k_begin, int k_end, int ns_iters,
                cudaStream_t stream) {
  constexpr int TM = 4 * MT * 16, TN = 4 * NT * 8;
  const int ldg = scratch_leading_dim(n), n2 = n / 3;
  const size_t smem =
      static_cast<size_t>(kStages) * (TM + TN) * kKPad * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ns_wide_product<MT, NT, kTensor, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ns_wide_product<MT, NT, kTensor, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 full(tile_count(n, TM, TN, false), B);
  const dim3 upper(tile_count(n, TM, TN, true), B);
  const dim3 pairs((n2 * n2 + 255) / 256, B);
  ns_wide_start<<<dim3(n, B), 256, 0, stream>>>(scratch, Xall, K, n, ldg,
                                                k_begin - 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int x = kWideX;                       // the X buffer holding X_{k-1}
  for (int k = k_begin; k < k_end; ++k) {
    ns_wide_schur<<<pairs, 256, 0, stream>>>(scratch, x, D, C9, K, n, ldg, k);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    for (int it = 0; it < ns_iters; ++it) {
      ns_wide_product<MT, NT, kTensor, false><<<full, kThreads, smem,
                                                stream>>>(
          scratch, x, kWideS, kWideT, Xall, K, n, ldg, -1);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
      const int xn = 2 * kWideX + 1 - x;
      ns_wide_product<MT, NT, kTensor, true><<<upper, kThreads, smem,
                                               stream>>>(
          scratch, x, kWideT, xn, Xall, K, n, ldg,
          it == ns_iters - 1 ? k : -1);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
      x = xn;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Per-scenario float32 scratch that ns_chain_interior_f32 needs for n on
// the tier of `tile` (0: one block a scenario; else the wide tier):
// none up to n = 128, S and T' up to n = 192, S, T' and two X buffers
// beyond and on the wide tier.
int ns_chain_scratch_floats(int n, int tile) {
  const int ldg = scratch_leading_dim(n);
  return (tile ? 4 : scratch_matrices(n)) * ldg * ldg;
}

// D (B, K, n, n); C9 (K-1, 9); Xall (B, K, n, n), row k_begin-1 holds the
// warm start and rows k_begin .. k_end-1 are written; scratch (B,
// ns_chain_scratch_floats(n, tile)).  All float32, contiguous.  precision 0
// is "highest" (FP32 FMAs), 1 is "high" (three-pass TF32 on the tensor
// cores); `tile` the plan's (ops/ns_chain.py ns_chain_plan): 0 runs one
// block a scenario, its layout following from n, 64, 128 or 192 the wide
// tier in output tiles of that size.  Returns the CUDA error code of the
// launches, or cudaErrorInvalidValue for arguments no path serves.
int ns_chain_interior_f32(const float* D, const float* C9, float* Xall,
                          float* scratch, int B, int K, int n, int k_begin,
                          int k_end, int ns_iters, int precision, int tile,
                          cudaStream_t stream) {
  if (B < 1 || n < 3 || n % 6 || k_begin < 1 || k_end > K || ns_iters < 1 ||
      precision < 0 || precision > 1 ||
      (tile != 0 && tile != 64 && tile != 128 && tile != 192))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile) {
    auto wide = tile == 192   ? (precision ? launch_wide<3, 6, true>
                                           : launch_wide<3, 6, false>)
                : tile == 128 ? (precision ? launch_wide<2, 4, true>
                                           : launch_wide<2, 4, false>)
                              : (precision ? launch_wide<1, 2, true>
                                           : launch_wide<1, 2, false>);
    return wide(D, C9, Xall, scratch, B, K, n, k_begin, k_end, ns_iters,
                stream);
  }
  const int matrices = scratch_matrices(n);
  auto launch = matrices == 0
                    ? (precision ? launch_chain<2, 4, kResident, true>
                                 : launch_chain<2, 4, kResident, false>)
                : matrices == 2
                    ? (precision ? launch_chain<3, 6, kHybrid, true>
                                 : launch_chain<3, 6, kHybrid, false>)
                    : (precision ? launch_chain<2, 8, kStreamed, true>
                                 : launch_chain<2, 8, kStreamed, false>);
  return launch(D, C9, Xall, scratch, B, K, n, k_begin, k_end, ns_iters,
                stream);
}

}  // extern "C"
