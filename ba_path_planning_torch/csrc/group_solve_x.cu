// X-form block-tridiagonal sweep solve (one ADMM x-update), for Hopper.
//
// Replaces the Pallas TPU kernel
// ba_path_planning_tpu/ops/pallas/group_solve.py (_make_group_kernel_X,
// launched by solve_factorized_grouped_X).  For every scenario it solves
// M x = b from the symmetric block inverses X_k:
//
//     forward   w_0 = X_0 b_0,  w_k = X_k (b_k - B_k w_{k-1})
//     backward  x_{K-1} = w_{K-1},  x_k = w_k - X_k (B_{k+1}^T x_{k+1})
//
// B_k = C_{k-1} (x) I_2N with C upper triangular, applied as the six
// slot-scalar axpys of the Pallas kernel's b_apply / b_apply_t.
//
// What bounds it: memory bandwidth.  Each solve streams every X_k twice,
// 2 K n^2 4 bytes = 5.76 MB per scenario at N = 20, K = 50, against 2 flops
// per byte read; the 2K matvecs of a scenario are serial.
//
// Design: one thread block per scenario runs the 2K steps in order.  A warp
// owns rows i = warp, warp + 8, ...; its lanes read a row of X_k with
// consecutive addresses (X_k is symmetric, so the row is also the column the
// backward sweep needs) and reduce with shuffles.  The small vectors (the
// right-hand side r and the previous w or x) live in shared memory; w_k is
// kept in the output array and overwritten by x_k in the backward sweep.
// Many blocks per SM keep loads in flight.  No lane padding and no scenario
// interleaving: those were rules of the TPU's DMA engine, not of this card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out_vec[i] = sum_j Xk[i, j] * r[j]; each row's result goes to fn(i, dot).
template <typename Fn>
__device__ __forceinline__ void matvec_rows(const float* __restrict__ Xk,
                                            const float* r, int n, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += kWarps) {
    const float* row = Xk + static_cast<size_t>(i) * n;
    float acc = 0.f;
    for (int j = lane; j < n; j += 32) acc = fmaf(row[j], r[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) fn(i, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
group_solve_x_kernel(const float* __restrict__ X, const float* __restrict__ C9,
                     const float* __restrict__ bvec, float* __restrict__ xout,
                     int K, int n) {
  extern __shared__ float sm[];
  float* r = sm;          // right-hand side of the current matvec
  float* v = sm + n;      // w_{k-1} (forward) / x_{k+1} (backward)
  const int b = blockIdx.x;
  const int n2 = n / 3;
  const size_t nsq = static_cast<size_t>(n) * n;
  const float* Xb = X + static_cast<size_t>(b) * K * nsq;
  const float* bb = bvec + static_cast<size_t>(b) * K * n;
  float* xb = xout + static_cast<size_t>(b) * K * n;

  // forward: w_k = X_k (b_k - B_k w_{k-1})
  for (int k = 0; k < K; ++k) {
    const float* bk = bb + static_cast<size_t>(k) * n;
    if (k == 0) {
      for (int j = threadIdx.x; j < n; j += blockDim.x) r[j] = bk[j];
    } else {
      const float* c = C9 + (k - 1) * 9;
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int s = j / n2, q = j % n2;
        const float wa = v[q], wp = v[n2 + q], wv = v[2 * n2 + q];
        float bw;
        if (s == 0)
          bw = c[0] * wa + c[1] * wp + c[2] * wv;
        else if (s == 1)
          bw = c[4] * wp + c[5] * wv;
        else
          bw = c[8] * wv;
        r[j] = bk[j] - bw;
      }
    }
    __syncthreads();
    float* wk = xb + static_cast<size_t>(k) * n;
    matvec_rows(Xb + k * nsq, r, n, [&](int i, float d) {
      wk[i] = d;
      v[i] = d;
    });
    __syncthreads();
  }

  // backward: x_{K-1} = w_{K-1} (already in place and in v);
  // x_k = w_k - X_k (B_{k+1}^T x_{k+1})
  for (int k = K - 2; k >= 0; --k) {
    const float* c = C9 + k * 9;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int s = j / n2, q = j % n2;
      const float xa = v[q], xp = v[n2 + q], xv = v[2 * n2 + q];
      float btx;
      if (s == 0)
        btx = c[0] * xa;
      else if (s == 1)
        btx = c[1] * xa + c[4] * xp;
      else
        btx = c[2] * xa + c[5] * xp + c[8] * xv;
      r[j] = btx;
    }
    __syncthreads();
    float* xk = xb + static_cast<size_t>(k) * n;
    matvec_rows(Xb + k * nsq, r, n, [&](int i, float d) {
      const float val = xk[i] - d;
      xk[i] = val;
      v[i] = val;
    });
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// X (B, K, n, n) symmetric block inverses; C9 (K-1, 9) upper-triangular slot
// scalars; b and x (B, K, n).  All float32, contiguous.  Returns the CUDA
// error code of the launch.
int group_solve_x_f32(const float* X, const float* C9, const float* b,
                      float* x, int B, int K, int n, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  group_solve_x_kernel<<<B, kThreads, smem, stream>>>(X, C9, b, x, K, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
