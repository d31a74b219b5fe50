// The elementwise stages of one ADMM iteration on row planes, shared by the
// fused ADMM-interval kernels (admm_fused_x.cu, admm_fused_l.cu): the
// right-hand side b = A^T (rho z - y) + sigma x before the sweeps, and the
// relaxation, A xt, the clip / exact-penalty prox and the dual update after
// them.  Every function is called by the first `nthr` threads of the
// block (tid, nthr), and leaves the barrier after it to the caller.  The
// `_rows` forms take a range [lo, hi) of row indices (k * 2N + q for the
// static rows, k * P + p for the collision rows): each row k reads rows
// k - 1 .. k + 1 of its inputs and writes row k only, so a caller may
// split k over blocks.  Such a caller (the wide tier of admm_fused_x.cu)
// passes kL2: every read of what the launch writes (the state and the
// sweep plane) then goes through L2 (ld.global.cg), so that no block reads
// a line that its SM's L1 kept from before another block wrote it.
//
// Rows are planes: static rows (K, 6, 2N) in the slot order dyn_p, dyn_v,
// jerk, acc, vbox, pbox (the jerk block's row K-1 is unused), collision rows
// (K, P).  Pair coupling goes by index, not by the TPU kernels' dense
// incidence products: A's collision row (k, p) is eta_kp . (p_i - p_j) at
// step k - 1, and A^T's column (vehicle v, axis c) is the signed sum of the
// N - 1 pair rows v belongs to, summed in a fixed order (no atomics, so the
// result is deterministic).
//
// Infinite values: a disabled collision row has the lower bound -inf, and
// hard collision rows have the penalty weight lam = +inf.  The prox
// w >= l ? w : min(w + lam / rho, l) then gives w on a disabled row and l
// on a violated hard row; no stage forms inf - inf or 0 * inf as long as
// the state is finite.

#pragma once

#include <cuda_runtime.h>

namespace admm_rows {

// One scenario's row planes and state, and the solver scalars.
struct Scenario {
  const float* __restrict__ eb;       // eta (K, P, 2)
  const float* __restrict__ lsb;      // static lower bounds (K, 6, 2N)
  const float* __restrict__ usb;      // static upper bounds
  const float* __restrict__ lcb;      // collision lower bounds (K, P)
  const float* __restrict__ rho_s;    // (K, 6) this scenario's rho
  const float* __restrict__ rho_c;    // (K, P)
  float* xb;             // x (K, 6N)
  float* zsb;            // z, y static rows (K, 6, 2N)
  float* ysb;
  float* zcb;            // z, y collision rows (K, P)
  float* ycb;
  float h, sigma, alpha, lam;
  int K, N;
};

// A read of the state or the sweep plane: through L2 where kL2, else a
// plain load.
template <bool kL2>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (kL2) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Index of pair (i, j), i < j, in triu_indices order.
__device__ __forceinline__ int pair_base(int i, int N) {
  return i * (2 * N - i - 1) / 2;
}

// The first vehicle i of pair p (pair_base(i) <= p < pair_base(i + 1)):
// the root of i^2 - (2N - 1) i + 2p = 0, then a step either way for the
// rounding of the square root.  Its partner is j = p - pair_base(i) + i + 1.
__device__ __forceinline__ int pair_first(int p, int N) {
  const float m = 2.f * N - 1.f;
  int i = static_cast<int>(0.5f * (m - sqrtf(m * m - 8.f * p)));
  i = max(0, min(i, N - 2));
  while (i > 0 && pair_base(i, N) > p) --i;
  while (pair_base(i + 1, N) <= p) ++i;
  return i;
}

// b = scale (A^T (rho z - y) + sigma x) into the sweep plane xt (K, 6N),
// on the static rows [lo, hi) (scale 1, or the per-lane 1 / rho of the
// grouped routes' adaptive rho).
template <bool kL2 = false>
__device__ __forceinline__ void build_rhs_rows(const Scenario& sc, float* xt,
                                               int lo, int hi, int tid,
                                               int nthr, float scale) {
  const int K = sc.K, N = sc.N, n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const float h = sc.h, sigma = sc.sigma, hh = 0.5f * h * h;
  const float *rho_s = sc.rho_s, *rho_c = sc.rho_c, *eb = sc.eb;
  const float *zsb = sc.zsb, *ysb = sc.ysb, *zcb = sc.zcb, *ycb = sc.ycb;
  const float* xb = sc.xb;
  for (int idx = lo + tid; idx < hi; idx += nthr) {
    const int k = idx / n2, q = idx % n2;
    auto rz = [&](int kk, int s) {
      const size_t o = (static_cast<size_t>(kk) * 6 + s) * n2 + q;
      return rho_s[kk * 6 + s] * load<kL2>(zsb + o) - load<kL2>(ysb + o);
    };
    const bool last = k == K - 1;
    const float dp = rz(k, 0), dv = rz(k, 1);
    const float jr = last ? 0.f : rz(k, 2);
    const float jr_prev = k > 0 ? rz(k - 1, 2) : 0.f;
    const float dp_next = last ? 0.f : rz(k + 1, 0);
    const float dv_next = last ? 0.f : rz(k + 1, 1);
    float col = 0.f;
    if (!last) {
      // collision rows at k + 1 on vehicle v, axis c: pairs (u, v) with
      // u < v enter with sign -1, pairs (v, u) with u > v with sign +1
      const int v = q >> 1, c = q & 1;
      const size_t kp = static_cast<size_t>(k + 1) * P;
      for (int u = 0; u < v; ++u) {
        const size_t o = kp + pair_base(u, N) + v - u - 1;
        col -= (rho_c[o] * load<kL2>(zcb + o) - load<kL2>(ycb + o))
               * eb[2 * o + c];
      }
      const size_t ov = kp + pair_base(v, N) - v - 1;
      for (int u = v + 1; u < N; ++u) {
        const size_t o = ov + u;
        col += (rho_c[o] * load<kL2>(zcb + o) - load<kL2>(ycb + o))
               * eb[2 * o + c];
      }
    }
    const float* xk = xb + static_cast<size_t>(k) * n;
    float* bk = xt + k * n;
    bk[q] = (-hh * dp - h * dv + (jr_prev - jr) / h + rz(k, 3)
             + sigma * load<kL2>(xk + q)) * scale;
    bk[n2 + q] = (dp - dp_next + rz(k, 5) + col
                  + sigma * load<kL2>(xk + n2 + q)) * scale;
    bk[2 * n2 + q] = (-h * dp_next + dv - dv_next + rz(k, 4)
                      + sigma * load<kL2>(xk + 2 * n2 + q)) * scale;
  }
}

// b = A^T (rho z - y) + sigma x into the sweep plane xt (K, 6N).
__device__ __forceinline__ void build_rhs(const Scenario& sc, float* xt,
                                          int tid, int nthr) {
  build_rhs_rows(sc, xt, 0, sc.K * 2 * sc.N, tid, nthr, 1.f);
}

// Relaxation of x, A xt, the z update (clip) and the dual update on the
// static rows [lo, hi), from the sweep plane xt (K, 6N) = the solution of
// the x-update.
template <bool kL2 = false>
__device__ __forceinline__ void update_static_rows(const Scenario& sc,
                                                   const float* xt, int lo,
                                                   int hi, int tid,
                                                   int nthr) {
  const int K = sc.K, N = sc.N, n2 = 2 * N, n = 3 * n2;
  const float h = sc.h, alpha = sc.alpha, hh = 0.5f * h * h;
  const float* rho_s = sc.rho_s;
  const float *lsb = sc.lsb, *usb = sc.usb;
  float *zsb = sc.zsb, *ysb = sc.ysb;
  float* xb = sc.xb;
  for (int idx = lo + tid; idx < hi; idx += nthr) {
    const int k = idx / n2, q = idx % n2;
    const float* t = xt + k * n;
    const float at = load<kL2>(t + q), pt = load<kL2>(t + n2 + q);
    const float vt = load<kL2>(t + 2 * n2 + q);
    const float pp = k > 0 ? load<kL2>(t + n2 + q - n) : 0.f;
    const float vp = k > 0 ? load<kL2>(t + 2 * n2 + q - n) : 0.f;
    float ax[6];
    ax[0] = pt - pp - h * vp - hh * at;
    ax[1] = vt - vp - h * at;
    ax[2] = k < K - 1 ? (load<kL2>(t + n + q) - at) / h : 0.f;
    ax[3] = at;
    ax[4] = vt;
    ax[5] = pt;
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      if (s == 2 && k == K - 1) continue;     // no jerk row at K-1
      const size_t o = (static_cast<size_t>(k) * 6 + s) * n2 + q;
      const float rho = rho_s[k * 6 + s];
      const float zr = alpha * ax[s] + (1.f - alpha) * load<kL2>(zsb + o);
      const float zn =
          fminf(fmaxf(zr + load<kL2>(ysb + o) / rho, lsb[o]), usb[o]);
      ysb[o] = load<kL2>(ysb + o) + rho * (zr - zn);
      zsb[o] = zn;
    }
    float* xk = xb + static_cast<size_t>(k) * n;
    xk[q] = alpha * at + (1.f - alpha) * load<kL2>(xk + q);
    xk[n2 + q] = alpha * pt + (1.f - alpha) * load<kL2>(xk + n2 + q);
    xk[2 * n2 + q] = alpha * vt + (1.f - alpha) * load<kL2>(xk + 2 * n2 + q);
  }
}

// A xt, then the exact-penalty soft prox and the dual update on the
// collision rows [lo, hi); each row's pair in closed form (pair_first).
template <bool kL2 = false>
__device__ __forceinline__ void update_collision_rows(
    const Scenario& sc, const float* xt, int lo, int hi, int tid, int nthr) {
  const int N = sc.N, n2 = 2 * N, n = 3 * n2, P = N * (N - 1) / 2;
  const float alpha = sc.alpha, lam = sc.lam;
  const float *rho_c = sc.rho_c, *eb = sc.eb, *lcb = sc.lcb;
  float *zcb = sc.zcb, *ycb = sc.ycb;
  for (int idx = lo + tid; idx < hi; idx += nthr) {
    const int k = idx / P, p = idx % P;
    // the row's operands first, so that their loads are in flight while
    // its pair is found
    const float rho = rho_c[idx], z = load<kL2>(zcb + idx);
    const float y = load<kL2>(ycb + idx), lb = lcb[idx];
    const float e0 = eb[2 * idx], e1 = eb[2 * idx + 1];
    float colv = 0.f;
    if (k > 0) {
      const float* pos = xt + (k - 1) * n + n2;
      const int i = pair_first(p, N), j = p - pair_base(i, N) + i + 1;
      colv = e0 * (load<kL2>(pos + 2 * i) - load<kL2>(pos + 2 * j))
             + e1 * (load<kL2>(pos + 2 * i + 1) - load<kL2>(pos + 2 * j + 1));
    }
    const float zr = alpha * colv + (1.f - alpha) * z;
    const float w = zr + y / rho;
    const float zn = w >= lb ? w : fminf(w + lam / rho, lb);
    ycb[idx] = y + rho * (zr - zn);
    zcb[idx] = zn;
  }
}

// Relaxation of x, A xt, the z update (clip on the static rows, the
// exact-penalty soft prox on the collision rows) and the dual update, from
// the sweep plane xt (K, 6N) = the solution of the x-update.
__device__ __forceinline__ void update_rows(const Scenario& sc,
                                            const float* xt, int tid,
                                            int nthr) {
  const int K = sc.K, N = sc.N;
  update_static_rows(sc, xt, 0, K * 2 * N, tid, nthr);
  update_collision_rows(sc, xt, 0, K * (N * (N - 1) / 2), tid, nthr);
}

}  // namespace admm_rows
