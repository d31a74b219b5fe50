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
// 4 n^3 flops; at n = 6N = 120 and 2 iterations that is 13.8 MFLOP per
// step and about 0.64 GFLOP per scenario over the 46 interior steps of
// K = 50 (5.1 GFLOP at N = 40).  The chain is serial in k, so the
// parallelism is the batch.
//
// Design: one thread block per scenario walks k serially (the TPU grid's k
// axis becomes a loop; nothing carries between blocks on this card).  The
// matrices are ld x ld tiles, ld = n rounded up to 8, zero padded
// (Newton-Schulz keeps the pad zero).  Each thread computes 8 x 8 output
// tiles with full FP32 FMAs, and a product's output never aliases its
// inputs.  The launcher picks one of two layouts from n:
//
//   * shared (ld <= 168, N <= 28): X and S live in shared memory; T = S X
//     too while three tiles fit (ld <= 136), else in a per-scenario global
//     scratch that stays in L2.  The new X goes through a global scratch
//     and is copied back once all threads have finished reading the old one.
//   * global (ld > 168): two ld x ld tiles no longer fit in the 227 KB a
//     block may have.  S, T and two X buffers (ping-pong) live in a
//     per-scenario global scratch (4 ld^2 floats, 0.92 MB at N = 40, mostly
//     L2-resident), and each product is a shared-memory-tiled GEMM: 128 x 128
//     output super-tiles, 16-deep panels of A (stored transposed) and B.
//
// TF32, 3xTF32 and wgmma are later A/Bs; this version is plain FP32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;
constexpr int kMaxSmemBytes = 232448;
constexpr int kSuper = 128;              // global path: output super-tile edge
constexpr int kPanel = 16;               // global path: panel depth
constexpr int kPanelPad = kSuper + 4;    // transposed A panel row, bank skew

// Leading dimension of the tiles and the scratch layout.
int leading_dim(int n) { return (n + kTile - 1) / kTile * kTile; }

// Layout of the chain for a given ld: 0 = X, S, T in shared memory;
// 1 = X, S in shared memory, T in global scratch; 2 = all in global scratch.
int chain_path(int ld) {
  const long bytes = static_cast<long>(ld) * ld * sizeof(float);
  if (3 * bytes <= kMaxSmemBytes) return 0;
  if (2 * bytes <= kMaxSmemBytes) return 1;
  return 2;
}

// out = A @ B over ld x ld row-major tiles; epi(i0, j0, acc) consumes each
// 8 x 8 output tile.
template <typename Epi>
__device__ void matmul_tiles(const float* __restrict__ A,
                             const float* __restrict__ Bm, int ld, Epi epi) {
  const int tpr = ld / kTile;
  const int ntiles = tpr * tpr;
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const int i0 = (t / tpr) * kTile;
    const int j0 = (t % tpr) * kTile;
    float acc[kTile][kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = 0.f;
    for (int l = 0; l < ld; ++l) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bm + l * ld + j0);
      const float4 b1 = *reinterpret_cast<const float4*>(Bm + l * ld + j0 + 4);
      const float bv[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float a = A[(i0 + r) * ld + l];
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(a, bv[c], acc[r][c]);
      }
    }
    epi(i0, j0, acc);
  }
}

// Epilogue of T = S X: store the 8 x 8 tile.
struct StoreTile {
  float* T;
  int ld;
  __device__ void operator()(int i0, int j0,
                             float (&acc)[kTile][kTile]) const {
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      float* dst = T + (i0 + r) * ld + j0;
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
};

// Epilogue of the Newton-Schulz update Xn = 2 X - X T (acc holds X T).
struct NewtonTile {
  const float* X;
  float* Xn;
  int ld;
  __device__ void operator()(int i0, int j0,
                             float (&acc)[kTile][kTile]) const {
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int o = (i0 + r) * ld + j0 + c;
        Xn[o] = 2.f * X[o] - acc[r][c];
      }
  }
};

// X <- the n x n warm start X0 in an ld x ld tile; S <- 0, pads included.
__device__ void load_warm_start(const float* X0, float* X, float* S, int n,
                                int ld) {
  for (int idx = threadIdx.x; idx < ld * ld; idx += blockDim.x) {
    const int i = idx / ld, j = idx % ld;
    X[idx] = (i < n && j < n) ? X0[i * n + j] : 0.f;
    S[idx] = 0.f;
  }
  __syncthreads();
}

// S = D_k - (C (x) I) X (C (x) I)^T, entry by entry over the 3x3 slots c.
__device__ void schur_complement(const float* X, const float* Dk,
                                 const float* c, float* S, int n, int ld) {
  const int n2 = n / 3;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx % n;
    const int si = i / n2, ii = i % n2, sj = j / n2, jj = j % n2;
    float w = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float row = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u)
        row = fmaf(c[sj * 3 + u], X[(t * n2 + ii) * ld + u * n2 + jj], row);
      w = fmaf(c[si * 3 + t], row, w);
    }
    S[i * ld + j] = Dk[idx] - w;
  }
  __syncthreads();
}

// X <- (X + X^T) / 2, then Xk <- its n x n part.  The next step reads X and
// writes S only, so no barrier follows the store.
__device__ void symmetrize_store(float* X, float* Xk, int n, int ld) {
  // each unordered pair (i, j), i < j, belongs to one thread
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx % n;
    if (i < j) {
      const float m = 0.5f * (X[i * ld + j] + X[j * ld + i]);
      X[i * ld + j] = m;
      X[j * ld + i] = m;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    Xk[idx] = X[(idx / n) * ld + idx % n];
}

__global__ void __launch_bounds__(kThreads)
ns_chain_kernel(const float* __restrict__ D, const float* __restrict__ C9,
                float* __restrict__ Xall, float* __restrict__ scratch,
                float* __restrict__ tscratch, int K, int n, int ld,
                int k_begin, int k_end, int ns_iters) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int nn = ld * ld;
  float* X = smem;
  float* S = smem + nn;
  float* T = tscratch ? tscratch + static_cast<size_t>(b) * nn : smem + 2 * nn;
  float* Xn = scratch + static_cast<size_t>(b) * nn;
  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Xb = Xall + static_cast<size_t>(b) * K * nsq;

  load_warm_start(Xb + (k_begin - 1) * nsq, X, S, n, ld);
  for (int k = k_begin; k < k_end; ++k) {
    schur_complement(X, D + (static_cast<size_t>(b) * K + k) * nsq,
                     C9 + (k - 1) * 9, S, n, ld);
    for (int it = 0; it < ns_iters; ++it) {
      matmul_tiles(S, X, ld, StoreTile{T, ld});
      __syncthreads();
      matmul_tiles(X, T, ld, NewtonTile{X, Xn, ld});
      __syncthreads();
      for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) X[idx] = Xn[idx];
      __syncthreads();
    }
    symmetrize_store(X, Xall + (static_cast<size_t>(b) * K + k) * nsq, n, ld);
  }
}

// out = A @ B for ld x ld row-major matrices in global memory (not
// __restrict__: the block writes them itself), staged through shared-memory
// panels As (kPanel x kPanelPad, A transposed) and Bs (kPanel x kSuper).
// kThreads = 256 threads as 16 x 16, each owning an 8 x 8 tile of a
// 128 x 128 output super-tile; epi(i0, j0, acc) consumes each 8 x 8 tile
// inside ld.  The next panel's loads are issued into registers before the
// current panel's products, so their latency overlaps the FMAs.  Every
// thread of the block must call it: it synchronizes.
template <typename Epi>
__device__ void matmul_global(const float* A, const float* Bm, int ld,
                              float* As, float* Bs, Epi epi) {
  constexpr int kLoads = kSuper * kPanel / kThreads;   // per matrix, panel
  constexpr int kARows = kThreads / kPanel;            // A rows per pass
  constexpr int kBRows = kThreads / kSuper;            // B rows per pass
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int ai = threadIdx.x / kPanel, al = threadIdx.x % kPanel;
  const int bl = threadIdx.x / kSuper, bj = threadIdx.x % kSuper;
  for (int i0 = 0; i0 < ld; i0 += kSuper) {
    for (int j0 = 0; j0 < ld; j0 += kSuper) {
      float ra[kLoads], rb[kLoads];
      auto fetch = [&](int l0) {
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int gi = i0 + ai + q * kARows, gl = l0 + al;
          ra[q] = (gi < ld && gl < ld) ? A[gi * ld + gl] : 0.f;
          const int gk = l0 + bl + q * kBRows, gj = j0 + bj;
          rb[q] = (gk < ld && gj < ld) ? Bm[gk * ld + gj] : 0.f;
        }
      };
      float acc[kTile][kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[r][c] = 0.f;
      fetch(0);
      for (int l0 = 0; l0 < ld; l0 += kPanel) {
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          As[al * kPanelPad + ai + q * kARows] = ra[q];
          Bs[(bl + q * kBRows) * kSuper + bj] = rb[q];
        }
        __syncthreads();
        if (l0 + kPanel < ld) fetch(l0 + kPanel);
#pragma unroll
        for (int l = 0; l < kPanel; ++l) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(As + l * kPanelPad + ti * kTile);
          const float4 a1 = *reinterpret_cast<const float4*>(
              As + l * kPanelPad + ti * kTile + 4);
          const float4 b0 =
              *reinterpret_cast<const float4*>(Bs + l * kSuper + tj * kTile);
          const float4 b1 = *reinterpret_cast<const float4*>(
              Bs + l * kSuper + tj * kTile + 4);
          const float av[kTile] = {a0.x, a0.y, a0.z, a0.w,
                                   a1.x, a1.y, a1.z, a1.w};
          const float bv[kTile] = {b0.x, b0.y, b0.z, b0.w,
                                   b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < kTile; ++r)
#pragma unroll
            for (int c = 0; c < kTile; ++c)
              acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
        __syncthreads();
      }
      const int oi = i0 + ti * kTile, oj = j0 + tj * kTile;
      if (oi < ld && oj < ld) epi(oi, oj, acc);
    }
  }
}

// The chain with every matrix in a per-scenario global scratch of 4 ld^2
// floats: S, T and the two X buffers of the ping-pong.
__global__ void __launch_bounds__(kThreads)
ns_chain_global_kernel(const float* __restrict__ D,
                       const float* __restrict__ C9, float* Xall,
                       float* scratch, int K, int n, int ld, int k_begin,
                       int k_end, int ns_iters) {
  __shared__ __align__(16) float As[kPanel * kPanelPad];
  __shared__ __align__(16) float Bs[kPanel * kSuper];
  const int b = blockIdx.x;
  const size_t nn = static_cast<size_t>(ld) * ld;
  float* S = scratch + static_cast<size_t>(b) * 4 * nn;
  float* T = S + nn;
  float* X = T + nn;         // current iterate
  float* Xn = X + nn;        // next iterate
  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Xb = Xall + static_cast<size_t>(b) * K * nsq;

  load_warm_start(Xb + (k_begin - 1) * nsq, X, S, n, ld);
  for (int k = k_begin; k < k_end; ++k) {
    schur_complement(X, D + (static_cast<size_t>(b) * K + k) * nsq,
                     C9 + (k - 1) * 9, S, n, ld);
    for (int it = 0; it < ns_iters; ++it) {
      matmul_global(S, X, ld, As, Bs, StoreTile{T, ld});
      __syncthreads();
      matmul_global(X, T, ld, As, Bs, NewtonTile{X, Xn, ld});
      __syncthreads();
      float* tmp = X;
      X = Xn;
      Xn = tmp;
    }
    symmetrize_store(X, Xall + (static_cast<size_t>(b) * K + k) * nsq, n, ld);
  }
}

}  // namespace

extern "C" {

// Per-scenario float32 scratch that ns_chain_interior_f32 needs for n:
// ld^2 (path 0), 2 ld^2 (path 1) or 4 ld^2 (path 2).
int ns_chain_scratch_floats(int n) {
  const int ld = leading_dim(n);
  const int mult[3] = {1, 2, 4};
  return mult[chain_path(ld)] * ld * ld;
}

// D (B, K, n, n); C9 (K-1, 9); Xall (B, K, n, n), row k_begin-1 holds the
// warm start and rows k_begin .. k_end-1 are written; scratch (B,
// ns_chain_scratch_floats(n)).  All float32, contiguous.  The layout follows
// from n (chain_path).  Returns the CUDA error code of the launch, or
// cudaErrorInvalidValue for arguments no path serves.
int ns_chain_interior_f32(const float* D, const float* C9, float* Xall,
                          float* scratch, int B, int K, int n, int k_begin,
                          int k_end, int ns_iters, cudaStream_t stream) {
  if (B < 1 || n < 3 || n % 3 || k_begin < 1 || k_end > K || ns_iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = leading_dim(n);
  const int path = chain_path(ld);
  if (path == 2) {
    ns_chain_global_kernel<<<B, kThreads, 0, stream>>>(
        D, C9, Xall, scratch, K, n, ld, k_begin, k_end, ns_iters);
    return static_cast<int>(cudaGetLastError());
  }
  const int nbuf = path == 0 ? 3 : 2;
  const size_t smem = static_cast<size_t>(nbuf) * ld * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ns_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // path 1: the T scratch follows the B Xn scratch blocks
  float* tscratch =
      path == 0 ? nullptr : scratch + static_cast<size_t>(B) * ld * ld;
  ns_chain_kernel<<<B, kThreads, smem, stream>>>(
      D, C9, Xall, scratch, tscratch, K, n, ld, k_begin, k_end, ns_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
