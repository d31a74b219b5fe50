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
// K = 50.  The chain is serial in k, so the parallelism is the batch.
//
// Design: one thread block per scenario walks k serially (the TPU grid's k
// axis becomes a loop; nothing carries between blocks on this card).  X, S
// and T = S X live in shared memory as ld x ld tiles, ld = n rounded up to
// 8, zero padded (Newton-Schulz keeps the pad zero).  At n = 120 the three
// take 172.8 KB of the 227 KB a block may have; from ld = 144 (N >= 23) T
// moves to a per-scenario global scratch that stays in L2.  Each thread
// computes 8 x 8 output tiles with full FP32 FMAs; a product's output never
// aliases its inputs: the new X goes through a per-scenario global scratch
// and is copied back once all threads have finished reading the old one.
// TF32, 3xTF32 and wgmma are later A/Bs; this version is plain FP32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;
constexpr int kMaxSmemBytes = 232448;

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
  const int n2 = n / 3;
  const size_t nsq = static_cast<size_t>(n) * n;

  // warm start X_{k_begin-1}; zero the pads of X and S
  const float* X0 = Xall + (static_cast<size_t>(b) * K + (k_begin - 1)) * nsq;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / ld, j = idx % ld;
    X[idx] = (i < n && j < n) ? X0[i * n + j] : 0.f;
    S[idx] = 0.f;
  }
  __syncthreads();

  for (int k = k_begin; k < k_end; ++k) {
    const float* c = C9 + (k - 1) * 9;
    const float* Dk = D + (static_cast<size_t>(b) * K + k) * nsq;
    // S = D_k - (C (x) I) X (C (x) I)^T, entry by entry over the 3x3 slots
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

    for (int it = 0; it < ns_iters; ++it) {
      // T = S X
      matmul_tiles(S, X, ld, [&](int i0, int j0, float (&acc)[kTile][kTile]) {
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          float* dst = T + (i0 + r) * ld + j0;
          reinterpret_cast<float4*>(dst)[0] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          reinterpret_cast<float4*>(dst)[1] =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      });
      __syncthreads();
      // Xn = 2 X - X T
      matmul_tiles(X, T, ld, [&](int i0, int j0, float (&acc)[kTile][kTile]) {
#pragma unroll
        for (int r = 0; r < kTile; ++r)
#pragma unroll
          for (int c2 = 0; c2 < kTile; ++c2) {
            const int o = (i0 + r) * ld + j0 + c2;
            Xn[o] = 2.f * X[o] - acc[r][c2];
          }
      });
      __syncthreads();
      for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) X[idx] = Xn[idx];
      __syncthreads();
    }

    // symmetrize: each unordered pair (i, j), i < j, belongs to one thread
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, j = idx % n;
      if (i < j) {
        const float m = 0.5f * (X[i * ld + j] + X[j * ld + i]);
        X[i * ld + j] = m;
        X[j * ld + i] = m;
      }
    }
    __syncthreads();
    float* Xk = Xall + (static_cast<size_t>(b) * K + k) * nsq;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
      Xk[idx] = X[(idx / n) * ld + idx % n];
    // the next step reads X and writes S only, so no barrier is needed here
  }
}

}  // namespace

extern "C" {

// Leading dimension of the shared-memory tiles and the scratch layout.
int ns_chain_ld(int n) { return (n + kTile - 1) / kTile * kTile; }

// 1 if T fits in shared memory beside X and S (then no T scratch is read).
int ns_chain_t_in_smem(int n) {
  const long ld = ns_chain_ld(n);
  return 3 * ld * ld * 4 <= kMaxSmemBytes;
}

// D (B, K, n, n); C9 (K-1, 9); Xall (B, K, n, n), row k_begin-1 holds the
// warm start and rows k_begin .. k_end-1 are written; scratch (B, ld, ld);
// tscratch (B, ld, ld), or null when ns_chain_t_in_smem(n).  All float32,
// contiguous.  Returns the CUDA error code of the launch.
int ns_chain_interior_f32(const float* D, const float* C9, float* Xall,
                          float* scratch, float* tscratch, int B, int K, int n,
                          int k_begin, int k_end, int ns_iters,
                          cudaStream_t stream) {
  const int ld = ns_chain_ld(n);
  const int nbuf = ns_chain_t_in_smem(n) ? 3 : 2;
  const size_t smem = static_cast<size_t>(nbuf) * ld * ld * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ns_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_chain_kernel<<<B, kThreads, smem, stream>>>(
      D, C9, Xall, scratch, nbuf == 3 ? nullptr : tscratch, K, n, ld, k_begin,
      k_end, ns_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
