// The QP's diagonal blocks D_k (B, K, 6N, 6N) in one pass: the
// collision-free skeleton of slot-scalar identities, plus on the p-p slot
// the collision terms of step k + 1 (D_{K-1} takes none).  ops/assemble_d.py
// is its wrapper, which forms the slot scalars (banded._tridiag_scalars)
// and C in PyTorch; solvers/banded.py assemble_D the
// plain version, which forms G = E (x) eta_{k+1} (B, K, 2N, P) and G rho,
// multiplies them on cuBLAS, shifts the product by one step, clones the
// broadcast skeleton and adds the product into it: ~95 launches moving
// ~4.3x the bytes of D at N = 20, K = 50.
//
// It replaces no Pallas body: the JAX package assembles D in fused jnp
// (ba_path_planning_tpu/solvers/banded.py), which XLA compiles with the
// rest of the set-up.  It was added because that plain form runs at about
// a tenth of the card's memory bandwidth.
//
// Bound: D's stores.  Every element is written once, with 16-byte stores
// (n^2 = 36 N^2 is a multiple of 4, and a tile starts on an even row, so
// every tile starts 16-byte aligned whatever N); the reads (eta and the
// collision rho of step k + 1, six slot scalars a (lane, k)) are ~4% of
// the bytes at N = 20.  The design keeps the work per stored vector small:
// a block holds a tile of rows of one D_k (the whole 120 x 120 block at N = 20,
// rows enough for ~64 KB at wider N); it stages the p-p slot's rows of the
// tile, a dense (2V, 2N) table for its V vehicles, in shared memory (and
// each vehicle's partner terms, which its diagonal sums read), then writes
// the tile in row order, each element a lookup in that table or a slot
// scalar of the skeleton.  No G, G rho or product goes through device
// memory.
//
// Arithmetic.  The vehicle block (i, j), i != j, of the p-p slot is the
// one term -rho_p eta_p eta_p^T of their pair p, each entry
// -fl(fl(eta_a rho) eta_b) with a the row's axis: the plain version's
// product bit for bit (a product of one nonzero term and zeros).  The
// block (i, i) sums its N - 1 pairs in ascending pair order as fused
// multiply-adds of fl(eta_a rho) and eta_b, then adds the skeleton's p-p
// scalar on its diagonal; cuBLAS may sum in another order, so these
// entries may differ from the plain version's at the ulp level (on the
// H100 they came out equal at every shape measured).  The skeleton's
// entries are the slot scalars as read, so they equal the plain
// version's bit for bit.  Pairs go by the closed form of triu order
// (admm_rows.cuh pair_base); pad pairs past N (N - 1) / 2 are never read.

#include <cuda_runtime.h>

#include <algorithm>

#include "admm_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long kSmemMax = 232448;

// 16 bytes of the working type
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float4 pack(const float* w) {
    return make_float4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double2 pack(const double* w) {
    return make_double2(w[0], w[1]);
  }
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
struct Args {
  const T* eta;                  // (B, K, P, 2), lanes eta_lane apart
  const T* rho_col;              // lane, k, pair strides rc_*
  const T* s;                    // (s_lanes, K, 6): aa, ap, av, pp, pv, vv
  T* D;                          // (B, K, 6N, 6N)
  long long eta_lane, rc_lane, rc_k, rc_p;
  int K, N, P, s_lanes, rows, tiles;
};

// The element (r, c) of D_k from the tile's staged p-p rows q (rows from
// 2 vlo, where `pairs`) and the slot scalars sv.
template <typename T>
__device__ __forceinline__ T element(int r, int c, int n2, int vlo,
                                     bool pairs, const T* q, const T* sv) {
  const int sr = (r >= n2) + (r >= 2 * n2), sc = (c >= n2) + (c >= 2 * n2);
  const int ir = r - sr * n2, ic = c - sc * n2;
  if (pairs && sr == 1 && sc == 1) return q[(ir - 2 * vlo) * n2 + ic];
  return ir == ic ? sv[sr * 3 + sc] : T(0);
}

// A block: rows [r0, r1) of D_k of lane l (tile t of `tiles`).
template <typename T>
__global__ void __launch_bounds__(kThreads)
assemble_d_kernel(const Args<T> a) {
  extern __shared__ double smem_raw[];
  T* q = reinterpret_cast<T*>(smem_raw);   // the tile's p-p rows (2V, 2N)
  __shared__ T sv[9];
  __shared__ T spp;
  const int N = a.N, K = a.K, n2 = 2 * N, n = 6 * N;
  const int tid = threadIdx.x;
  int bid = blockIdx.x;
  const int tile = bid % a.tiles;
  bid /= a.tiles;
  const int k = bid % K, l = bid / K;
  const int r0 = tile * a.rows, r1 = min(r0 + a.rows, n);
  if (tid < 9) {
    // the slot scalars of (lane, k) as the symmetric 3 x 3 (a, p, v)
    const T* s = a.s + (static_cast<long long>(a.s_lanes > 1 ? l : 0) * K
                        + k) * 6;
    const int r = tid / 3, c = tid - 3 * r;
    const int lo = min(r, c), hi = max(r, c);
    sv[tid] = s[lo == 0 ? hi : lo == 1 ? 2 + hi : 5];
    if (tid == 4) spp = sv[4];
  }

  // the tile's rows of the p-p slot: vehicles [vlo, vlo + V); a tile
  // starts on an even row, so it holds whole vehicles
  const int plo = max(r0, n2), phi = min(r1, 2 * n2);
  const int V = plo < phi ? (phi - plo) / 2 : 0;
  const int vlo = (plo - n2) / 2;
  const bool pairs = V > 0 && k + 1 < K;
  const T* eta = a.eta + l * a.eta_lane + (k + 1LL) * a.P * 2;
  const T* rc = a.rho_col + l * a.rc_lane + (k + 1LL) * a.rc_k;
  // t: each vehicle's partner terms (eta_0, eta_1, rho) by partner, so
  // that its diagonal sums read shared memory
  T* t = q + 2 * V * n2;
  if (pairs) {
    // the off-diagonal vehicle blocks: -fl(fl(eta_a rho) eta_b)
    for (int idx = tid; idx < V * N; idx += kThreads) {
      const int li = idx / N, vj = idx - li * N, vi = vlo + li;
      if (vj == vi) continue;
      const int i = min(vi, vj), j = max(vi, vj);
      const int p = admm_rows::pair_base(i, N) + j - i - 1;
      const T e0 = eta[2 * p], e1 = eta[2 * p + 1], rho = rc[p * a.rc_p];
      const T x0 = mul_rn(e0, rho), x1 = mul_rn(e1, rho);
      T* row = q + 2 * li * n2 + 2 * vj;
      row[0] = -mul_rn(x0, e0);
      row[1] = -mul_rn(x0, e1);
      row[n2] = -mul_rn(x1, e0);
      row[n2 + 1] = -mul_rn(x1, e1);
      T* te = t + 3 * idx;
      te[0] = e0;
      te[1] = e1;
      te[2] = rho;
    }
  }
  __syncthreads();
  if (pairs) {
    // the diagonal vehicle blocks: each entry sums its N - 1 pairs in
    // ascending pair order (ascending partner) as fused multiply-adds of
    // fl(eta_a rho) and eta_b, then the skeleton's p-p scalar on the
    // diagonal
    for (int idx = tid; idx < 4 * V; idx += kThreads) {
      const int li = idx >> 2, ax = (idx >> 1) & 1, bx = idx & 1;
      const int vi = vlo + li;
      const T* te = t + 3 * li * N;
      T sum = T(0);
#pragma unroll 8
      for (int vj = 0; vj < N; ++vj) {
        const T* e = te + 3 * vj;
        if (vj != vi) sum = fma_rn(mul_rn(e[ax], e[2]), e[bx], sum);
      }
      q[(2 * li + ax) * n2 + 2 * vi + bx] = ax == bx ? add_rn(spp, sum) : sum;
    }
    __syncthreads();
  }

  // the tile in row order, one 16-byte vector a thread at a time
  using V4 = typename Vec<T>::type;
  constexpr int W = Vec<T>::n;
  T* out = a.D + ((static_cast<long long>(l) * K + k) * n + r0) * n;
  const int nvec = (r1 - r0) * n / W;
  const int step = kThreads * W, dr = step / n, dc = step - dr * n;
  int r = r0 + tid * W / n, c = tid * W - (r - r0) * n;
  for (int v = tid; v < nvec; v += kThreads) {
    T w[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      int rr = r, cc = c + e;
      if (cc >= n) {
        cc -= n;
        ++rr;
      }
      w[e] = element(rr, cc, n2, vlo, pairs, q, sv);
    }
    __stcs(reinterpret_cast<V4*>(out) + v, Vec<T>::pack(w));
    c += dc;
    r += dr;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
}

template <typename T>
int launch(const T* eta, const T* rho_col, const T* s, T* D,
           const long long* strides, int B, int K, int N, int P,
           int s_lanes, int tile_rows, cudaStream_t stream) {
  const int n = 6 * N;
  const long long tiles = (n + tile_rows - 1) / static_cast<long long>(
                              tile_rows > 0 ? tile_rows : 1);
  const long long blocks = static_cast<long long>(B) * K * tiles;
  // the tile's p-p rows (2V, 2N) and its vehicles' partner terms (V, N, 3)
  const long smem = static_cast<long>(std::min(tile_rows, 2 * N)) * N * 7 / 2
                    * static_cast<long>(sizeof(T));
  if (B < 1 || K < 1 || N < 1 || tile_rows < 2 || (tile_rows & 1) ||
      P < N * (N - 1LL) / 2 || (s_lanes != 1 && s_lanes != B) ||
      smem > kSmemMax || blocks >= (1LL << 31) ||
      static_cast<long long>(N) * N >= (1LL << 30) ||
      (reinterpret_cast<size_t>(D) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.eta = eta;
  a.rho_col = rho_col;
  a.s = s;
  a.D = D;
  a.eta_lane = strides[0];
  a.rc_lane = strides[1];
  a.rc_k = strides[2];
  a.rc_p = strides[3];
  a.K = K;
  a.N = N;
  a.P = P;
  a.s_lanes = s_lanes;
  a.rows = tile_rows;
  a.tiles = static_cast<int>(tiles);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(assemble_d_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  assemble_d_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// D (B, K, 6N, 6N) from eta (B, K, P, 2) contiguous, the collision rho
// rho_col and the slot scalars s (s_lanes, K, 6) contiguous, s_lanes 1 or
// B.  strides (4): eta's lane; rho_col's lane, k and pair.  Tiles of
// `tile_rows` rows (even) a block (ops/assemble_d.py assemble_plan).
// Returns the CUDA error code of the launch, or cudaErrorInvalidValue for
// arguments it cannot serve.
int assemble_d_f32(const float* eta, const float* rho_col, const float* s,
                   float* D, const long long* strides, int B, int K, int N,
                   int P, int s_lanes, int tile_rows, cudaStream_t stream) {
  return launch(eta, rho_col, s, D, strides, B, K, N, P, s_lanes, tile_rows,
                stream);
}

int assemble_d_f64(const double* eta, const double* rho_col, const double* s,
                   double* D, const long long* strides, int B, int K, int N,
                   int P, int s_lanes, int tile_rows, cudaStream_t stream) {
  return launch(eta, rho_col, s, D, strides, B, K, N, P, s_lanes, tile_rows,
                stream);
}

}  // extern "C"
