// Host-side matrix-free ADMM QP solver for the SCP subproblem.
//
// The PyTorch port's copy of the JAX package's native solver (the same
// source): the equilibrated ADMM of solvers/admm.py with prefix-sum
// operator applications (never materializing constraint matrices) and the
// eigendecomposed static-block preconditioner (Q, lam are computed
// host-side in Python and passed in).  It fills the role OSQP's C core
// plays in the reference: a native QP engine for single-scenario host
// solves, and an independent implementation for differential tests.
//
// Problem:  min ||x||^2  s.t.  l <= A x <= u   with A the stacked
// jerk/acc/vel/pos/collision operator over accelerations x in R^{N*K*2}
// (layout: vehicle-major (N, K, 2)).
//
// Built by native/__init__.py with g++ into build/native/ at first use and
// bound through ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Dims {
    int N;   // vehicles
    int K;   // timesteps
    int P;   // pairs = N(N-1)/2
};

// Row-space vector: one contiguous buffer per block.
struct Rows {
    std::vector<double> jerk;  // N*(K-1)*2
    std::vector<double> acc;   // N*K*2
    std::vector<double> vel;   // N*K*2
    std::vector<double> pos;   // N*K*2
    std::vector<double> col;   // K*P

    void resize(const Dims& d) {
        jerk.assign((size_t)d.N * (d.K - 1) * 2, 0.0);
        acc.assign((size_t)d.N * d.K * 2, 0.0);
        vel.assign((size_t)d.N * d.K * 2, 0.0);
        pos.assign((size_t)d.N * d.K * 2, 0.0);
        col.assign((size_t)d.K * d.P, 0.0);
    }
};

inline size_t xi(const Dims& d, int i, int k, int c) {
    return ((size_t)i * d.K + k) * 2 + c;
}

// ---- forward operator blocks (constraints.py:apply_static equivalents) ----

void apply_static(const Dims& d, double h, const double* x, Rows& out) {
    for (int i = 0; i < d.N; ++i) {
        for (int c = 0; c < 2; ++c) {
            // jerk: (x[k+1]-x[k])/h
            for (int k = 0; k + 1 < d.K; ++k)
                out.jerk[((size_t)i * (d.K - 1) + k) * 2 + c] =
                    (x[xi(d, i, k + 1, c)] - x[xi(d, i, k, c)]) / h;
            // acc, vel (h*cumsum), pos (h^2*(s2 + 0.5*cs)) where
            // s2[k] = sum_{m<=k} s1[m], s1[m] = exclusive cumsum of a
            double cs = 0.0, s2 = 0.0;
            for (int k = 0; k < d.K; ++k) {
                double a = x[xi(d, i, k, c)];
                s2 += cs;          // cs still exclusive here: s1[k]
                cs += a;           // now inclusive
                out.acc[xi(d, i, k, c)] = a;
                out.vel[xi(d, i, k, c)] = h * cs;
                out.pos[xi(d, i, k, c)] = h * h * (s2 + 0.5 * cs);
            }
        }
    }
}

// zero-IC position rollout: p~[k] = sum_{j<k} h^2 (k-j-0.5) a[j]
void rollout_zero_ic(const Dims& d, double h, const double* x,
                     std::vector<double>& ptilde /* N*K*2 */) {
    ptilde.assign((size_t)d.N * d.K * 2, 0.0);
    for (int i = 0; i < d.N; ++i)
        for (int c = 0; c < 2; ++c) {
            double s1 = 0.0, s2 = 0.0;
            for (int k = 0; k < d.K; ++k) {
                // s1 = sum_{j<k} a[j],  s2 = sum_{m<=k} s1[m] (s1[0]=0)
                s2 += s1;
                ptilde[xi(d, i, k, c)] = h * h * (s2 - 0.5 * s1);
                s1 += x[xi(d, i, k, c)];
            }
        }
}

// collision rows: row(k,p) = eta[k,p] . (p~_i[k] - p~_j[k])
void apply_collision(const Dims& d, double h, const double* x,
                     const double* eta /* K*P*2 */, const int* pi,
                     const int* pj, double col_mask, Rows& out,
                     std::vector<double>& scratch) {
    if (d.P == 0) return;
    rollout_zero_ic(d, h, x, scratch);
    for (int k = 0; k < d.K; ++k)
        for (int p = 0; p < d.P; ++p) {
            size_t e = ((size_t)k * d.P + p) * 2;
            double dx = scratch[xi(d, pi[p], k, 0)] - scratch[xi(d, pj[p], k, 0)];
            double dy = scratch[xi(d, pi[p], k, 1)] - scratch[xi(d, pj[p], k, 1)];
            out.col[(size_t)k * d.P + p] =
                col_mask * (eta[e] * dx + eta[e + 1] * dy);
        }
}

// ---- adjoint blocks ----

void apply_static_adjoint(const Dims& d, double h, const Rows& y, double* out) {
    for (int i = 0; i < d.N; ++i)
        for (int c = 0; c < 2; ++c) {
            // jerk^T: out[k] = (y[k-1] - y[k])/h, boundary zeros
            for (int k = 0; k < d.K; ++k) {
                double prev = (k > 0)
                    ? y.jerk[((size_t)i * (d.K - 1) + k - 1) * 2 + c] : 0.0;
                double cur = (k < d.K - 1)
                    ? y.jerk[((size_t)i * (d.K - 1) + k) * 2 + c] : 0.0;
                out[xi(d, i, k, c)] = (prev - cur) / h;
            }
            // acc^T + vel^T + pos^T via reverse scans
            double r1 = 0.0;        // vel: sum_{k>=m} y[k]
            double p1 = 0.0, rp = 0.0;
            for (int k = d.K - 1; k >= 0; --k) {
                double yv = y.vel[xi(d, i, k, c)];
                double yp = y.pos[xi(d, i, k, c)];
                r1 += yv;
                rp += p1;           // rp[m] = sum_{k>m} p1-ish; see python impl
                p1 += yp;
                out[xi(d, i, k, c)] += y.acc[xi(d, i, k, c)] + h * r1 +
                    h * h * (rp + 0.5 * p1);
            }
        }
}

void apply_collision_adjoint(const Dims& d, double h, const Rows& y,
                             const double* eta, const int* pi, const int* pj,
                             double col_mask, double* out,
                             std::vector<double>& g /* N*K*2 scratch */) {
    if (d.P == 0) return;
    g.assign((size_t)d.N * d.K * 2, 0.0);
    for (int k = 0; k < d.K; ++k)
        for (int p = 0; p < d.P; ++p) {
            double yv = col_mask * y.col[(size_t)k * d.P + p];
            size_t e = ((size_t)k * d.P + p) * 2;
            g[xi(d, pi[p], k, 0)] += yv * eta[e];
            g[xi(d, pi[p], k, 1)] += yv * eta[e + 1];
            g[xi(d, pj[p], k, 0)] -= yv * eta[e];
            g[xi(d, pj[p], k, 1)] -= yv * eta[e + 1];
        }
    // adjoint of zero-IC rollout: out[m] += h^2 (rev_inc(q1)[m] - 0.5 q1[m]),
    // q1[m] = sum_{k>m} g[k]
    for (int i = 0; i < d.N; ++i)
        for (int c = 0; c < 2; ++c) {
            double q1 = 0.0, rq = 0.0;
            for (int k = d.K - 1; k >= 0; --k) {
                // q1 currently = sum_{t>k} g[t]; after the add below,
                // rq = sum_{t>=k} q1[t] (reverse inclusive cumsum of q1)
                rq += q1;
                out[xi(d, i, k, c)] += h * h * (rq - 0.5 * q1);
                q1 += g[xi(d, i, k, c)];
            }
        }
}

struct Solver {
    Dims d;
    double h;
    // problem data
    Rows lower, upper, scale /* d_i */, rho_rows;
    std::vector<double> eta;       // K*P*2
    std::vector<int> pi_idx, pj_idx;
    double col_mask = 0.0;
    // preconditioner
    std::vector<double> Q;         // K*K (column-major ok: symmetric use)
    std::vector<double> lam;       // K
    // settings
    double rho = 0.1, sigma = 1e-6, alpha = 1.6;
    double eps_abs = 1e-3, eps_rel = 1e-3;
    int max_iter = 4000, check_interval = 25, cg_iters = 10;
    // state
    std::vector<double> x;
    Rows z, y;
    int iters = 0;
    double prim_res = 0.0, dual_res = 0.0;
    bool converged = false;
};

size_t nvar(const Dims& d) { return (size_t)d.N * d.K * 2; }

void apply_A(Solver& S, const double* x, Rows& out, std::vector<double>& scr) {
    apply_static(S.d, S.h, x, out);
    apply_collision(S.d, S.h, x, S.eta.data(), S.pi_idx.data(),
                    S.pj_idx.data(), S.col_mask, out, scr);
}

void apply_AT(Solver& S, const Rows& y, double* out, std::vector<double>& scr) {
    apply_static_adjoint(S.d, S.h, y, out);
    apply_collision_adjoint(S.d, S.h, y, S.eta.data(), S.pi_idx.data(),
                            S.pj_idx.data(), S.col_mask, out, scr);
}

template <typename F>
void for_each_block(Rows& a, F f) {
    f(a.jerk); f(a.acc); f(a.vel); f(a.pos); f(a.col);
}

// precond: out = Q diag(1/(2+sigma+rho*lam)) Q^T r, applied per (i, c) along K
void precond(Solver& S, const double* r, double* out) {
    const int K = S.d.K;
    std::vector<double> tmp(K);
    for (int i = 0; i < S.d.N; ++i)
        for (int c = 0; c < 2; ++c) {
            for (int kk = 0; kk < K; ++kk) {
                double acc = 0.0;
                for (int l = 0; l < K; ++l)
                    acc += S.Q[(size_t)l * K + kk] * r[xi(S.d, i, l, c)];
                tmp[kk] = acc / (2.0 + S.sigma + S.rho * S.lam[kk]);
            }
            for (int kk = 0; kk < K; ++kk) {
                double acc = 0.0;
                for (int l = 0; l < K; ++l)
                    acc += S.Q[(size_t)kk * K + l] * tmp[l];
                out[xi(S.d, i, kk, c)] = acc;
            }
        }
}

}  // namespace

extern "C" {

// Opaque handle API for ctypes.
void* scp_qp_create(int N, int K, double h) {
    auto* S = new Solver();
    S->d = {N, K, N * (N - 1) / 2};
    S->h = h;
    S->lower.resize(S->d); S->upper.resize(S->d);
    S->scale.resize(S->d); S->rho_rows.resize(S->d);
    S->z.resize(S->d); S->y.resize(S->d);
    S->eta.assign((size_t)K * S->d.P * 2, 0.0);
    S->pi_idx.resize(S->d.P); S->pj_idx.resize(S->d.P);
    int p = 0;
    for (int i = 0; i < N; ++i)
        for (int j = i + 1; j < N; ++j) { S->pi_idx[p] = i; S->pj_idx[p] = j; ++p; }
    S->Q.assign((size_t)K * K, 0.0);
    S->lam.assign(K, 0.0);
    S->x.assign(nvar(S->d), 0.0);
    return S;
}

void scp_qp_destroy(void* h) { delete static_cast<Solver*>(h); }

void scp_qp_set_settings(void* hS, double rho, double sigma, double alpha,
                         double eps_abs, double eps_rel, int max_iter,
                         int check_interval, int cg_iters) {
    auto* S = static_cast<Solver*>(hS);
    S->rho = rho; S->sigma = sigma; S->alpha = alpha;
    S->eps_abs = eps_abs; S->eps_rel = eps_rel;
    S->max_iter = max_iter; S->check_interval = check_interval;
    S->cg_iters = cg_iters;
}

void scp_qp_set_precond(void* hS, const double* Q, const double* lam) {
    auto* S = static_cast<Solver*>(hS);
    std::memcpy(S->Q.data(), Q, sizeof(double) * S->Q.size());
    std::memcpy(S->lam.data(), lam, sizeof(double) * S->lam.size());
}

// Bounds/scale/rho arrays in block order jerk|acc|vel|pos|col, concatenated.
static void unpack_rows(const Dims& d, const double* buf, Rows& r) {
    size_t o = 0;
    auto cp = [&](std::vector<double>& v) {
        std::memcpy(v.data(), buf + o, sizeof(double) * v.size());
        o += v.size();
    };
    cp(r.jerk); cp(r.acc); cp(r.vel); cp(r.pos); cp(r.col);
}

void scp_qp_set_bounds(void* hS, const double* lower, const double* upper) {
    auto* S = static_cast<Solver*>(hS);
    unpack_rows(S->d, lower, S->lower);
    unpack_rows(S->d, upper, S->upper);
}

void scp_qp_set_scaling(void* hS, const double* d_rows, const double* rho_rows) {
    auto* S = static_cast<Solver*>(hS);
    unpack_rows(S->d, d_rows, S->scale);
    unpack_rows(S->d, rho_rows, S->rho_rows);
}

void scp_qp_set_collision(void* hS, const double* eta, double col_mask) {
    auto* S = static_cast<Solver*>(hS);
    if (!S->eta.empty())
        std::memcpy(S->eta.data(), eta, sizeof(double) * S->eta.size());
    S->col_mask = col_mask;
}

int scp_qp_solve(void* hS, const double* x_init, double* x_out,
                 double* info /* [iters, prim, dual, converged] */) {
    auto* S = static_cast<Solver*>(hS);
    const size_t n = nvar(S->d);
    S->x.assign(x_init, x_init + n);

    std::vector<double> scr, b(n), xt(n), r(n), zv(n), pv(n), Ap(n), tmp(n);
    Rows Ax; Ax.resize(S->d);
    Rows rz; rz.resize(S->d);

    // z0 = clip(A x0), y0 = 0
    apply_A(*S, S->x.data(), Ax, scr);
    {
        auto cl = [&](std::vector<double>& zz, const std::vector<double>& vv,
                      const std::vector<double>& lo, const std::vector<double>& up) {
            for (size_t q = 0; q < zz.size(); ++q)
                zz[q] = std::fmin(std::fmax(vv[q], lo[q]), up[q]);
        };
        cl(S->z.jerk, Ax.jerk, S->lower.jerk, S->upper.jerk);
        cl(S->z.acc, Ax.acc, S->lower.acc, S->upper.acc);
        cl(S->z.vel, Ax.vel, S->lower.vel, S->upper.vel);
        cl(S->z.pos, Ax.pos, S->lower.pos, S->upper.pos);
        cl(S->z.col, Ax.col, S->lower.col, S->upper.col);
    }
    for_each_block(S->y, [](std::vector<double>& v) {
        std::fill(v.begin(), v.end(), 0.0); });

    S->converged = false;
    S->iters = 0;

    auto matvec = [&](const double* v, double* out) {
        apply_A(*S, v, Ax, scr);
        // rho-weighted rows
        auto wmul = [](std::vector<double>& dst, const std::vector<double>& a,
                       const std::vector<double>& w) {
            for (size_t q = 0; q < dst.size(); ++q) dst[q] = a[q] * w[q];
        };
        wmul(rz.jerk, Ax.jerk, S->rho_rows.jerk);
        wmul(rz.acc, Ax.acc, S->rho_rows.acc);
        wmul(rz.vel, Ax.vel, S->rho_rows.vel);
        wmul(rz.pos, Ax.pos, S->rho_rows.pos);
        wmul(rz.col, Ax.col, S->rho_rows.col);
        std::fill(out, out + n, 0.0);
        apply_AT(*S, rz, out, scr);
        for (size_t q = 0; q < n; ++q) out[q] += (2.0 + S->sigma) * v[q];
    };

    while (S->iters < S->max_iter && !S->converged) {
        for (int inner = 0; inner < S->check_interval; ++inner) {
            // rhs b = sigma x + A^T (rho z - y)
            auto combine = [](std::vector<double>& dst, const std::vector<double>& z,
                              const std::vector<double>& y,
                              const std::vector<double>& w) {
                for (size_t q = 0; q < dst.size(); ++q)
                    dst[q] = w[q] * z[q] - y[q];
            };
            combine(rz.jerk, S->z.jerk, S->y.jerk, S->rho_rows.jerk);
            combine(rz.acc, S->z.acc, S->y.acc, S->rho_rows.acc);
            combine(rz.vel, S->z.vel, S->y.vel, S->rho_rows.vel);
            combine(rz.pos, S->z.pos, S->y.pos, S->rho_rows.pos);
            combine(rz.col, S->z.col, S->y.col, S->rho_rows.col);
            std::fill(b.begin(), b.end(), 0.0);
            apply_AT(*S, rz, b.data(), scr);
            for (size_t q = 0; q < n; ++q) b[q] += S->sigma * S->x[q];

            // PCG from x
            xt = S->x;
            matvec(xt.data(), Ap.data());
            for (size_t q = 0; q < n; ++q) r[q] = b[q] - Ap[q];
            precond(*S, r.data(), zv.data());
            pv = zv;
            double rz_dot = 0.0;
            for (size_t q = 0; q < n; ++q) rz_dot += r[q] * zv[q];
            for (int cg = 0; cg < S->cg_iters; ++cg) {
                matvec(pv.data(), Ap.data());
                double pAp = 0.0;
                for (size_t q = 0; q < n; ++q) pAp += pv[q] * Ap[q];
                double al = rz_dot / std::fmax(pAp, 1e-300);
                for (size_t q = 0; q < n; ++q) { xt[q] += al * pv[q]; r[q] -= al * Ap[q]; }
                double r2 = 0.0;
                for (size_t q = 0; q < n; ++q) r2 += r[q] * r[q];
                if (r2 < 1e-20) break;
                precond(*S, r.data(), zv.data());
                double rz_new = 0.0;
                for (size_t q = 0; q < n; ++q) rz_new += r[q] * zv[q];
                double beta = rz_new / std::fmax(rz_dot, 1e-300);
                rz_dot = rz_new;
                for (size_t q = 0; q < n; ++q) pv[q] = zv[q] + beta * pv[q];
            }

            // relaxation + z/y updates
            apply_A(*S, xt.data(), Ax, scr);
            auto zyup = [&](std::vector<double>& z, std::vector<double>& y,
                            const std::vector<double>& axt,
                            const std::vector<double>& lo,
                            const std::vector<double>& up,
                            const std::vector<double>& w) {
                for (size_t q = 0; q < z.size(); ++q) {
                    double zr = S->alpha * axt[q] + (1.0 - S->alpha) * z[q];
                    double zn = std::fmin(std::fmax(zr + y[q] / w[q], lo[q]), up[q]);
                    y[q] += w[q] * (zr - zn);
                    z[q] = zn;
                }
            };
            zyup(S->z.jerk, S->y.jerk, Ax.jerk, S->lower.jerk, S->upper.jerk, S->rho_rows.jerk);
            zyup(S->z.acc, S->y.acc, Ax.acc, S->lower.acc, S->upper.acc, S->rho_rows.acc);
            zyup(S->z.vel, S->y.vel, Ax.vel, S->lower.vel, S->upper.vel, S->rho_rows.vel);
            zyup(S->z.pos, S->y.pos, Ax.pos, S->lower.pos, S->upper.pos, S->rho_rows.pos);
            zyup(S->z.col, S->y.col, Ax.col, S->lower.col, S->upper.col, S->rho_rows.col);
            for (size_t q = 0; q < n; ++q)
                S->x[q] = S->alpha * xt[q] + (1.0 - S->alpha) * S->x[q];
            ++S->iters;
        }

        // residuals (scaled rows)
        apply_A(*S, S->x.data(), Ax, scr);
        double prim = 0.0, prim_scale = 0.0;
        auto presid = [&](const std::vector<double>& ax, const std::vector<double>& z,
                          const std::vector<double>& dsc) {
            for (size_t q = 0; q < ax.size(); ++q) {
                double da = ax[q] * dsc[q], dz = z[q] * dsc[q];
                prim = std::fmax(prim, std::fabs(da - dz));
                prim_scale = std::fmax(prim_scale, std::fmax(std::fabs(da), std::fabs(dz)));
            }
        };
        presid(Ax.jerk, S->z.jerk, S->scale.jerk);
        presid(Ax.acc, S->z.acc, S->scale.acc);
        presid(Ax.vel, S->z.vel, S->scale.vel);
        presid(Ax.pos, S->z.pos, S->scale.pos);
        presid(Ax.col, S->z.col, S->scale.col);

        std::fill(tmp.begin(), tmp.end(), 0.0);
        apply_AT(*S, S->y, tmp.data(), scr);
        double dual = 0.0, dual_scale = 0.0;
        for (size_t q = 0; q < n; ++q) {
            dual = std::fmax(dual, std::fabs(2.0 * S->x[q] + tmp[q]));
            dual_scale = std::fmax(dual_scale,
                                   std::fmax(std::fabs(2.0 * S->x[q]), std::fabs(tmp[q])));
        }
        S->prim_res = prim;
        S->dual_res = dual;
        S->converged = prim <= S->eps_abs + S->eps_rel * prim_scale &&
                       dual <= S->eps_abs + S->eps_rel * dual_scale;
    }

    std::memcpy(x_out, S->x.data(), sizeof(double) * n);
    info[0] = S->iters;
    info[1] = S->prim_res;
    info[2] = S->dual_res;
    info[3] = S->converged ? 1.0 : 0.0;
    return S->converged ? 0 : 1;
}

}  // extern "C"
