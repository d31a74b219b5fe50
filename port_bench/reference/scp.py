"""Plain reference of the production SCP solver, in plain PyTorch.

It solves the problem that a configuration file of ``port_bench/configs``
states, from the scenarios alone, with the method that configuration names:

  1. phase 1: the QP without collision rows, ``admm_iters`` ADMM iterations
     from the rest trajectory, each x-update an exact solve of the normal
     equations;
  2. a lane whose goal-projected phase-1 trajectory is collision-free stops
     there (status 0);
  3. else SCP iterations, at most ``max_scp``: linearize the pair distances
     about the previous iterate, tighten the collision rows by ``margin``,
     and solve the QP warm-started at the previous iterate and duals, its
     x-updates on X-form factors (the inverses of the Schur complements of
     the block-tridiagonal normal matrix, each from ``ns_iters``
     Newton-Schulz iterations warm-started at the step before, the steps
     k = 0, 1, 2 and K-1 exact); a lane stops (status 1) once its
     goal-projected iterate is collision-free at R, else runs out (status 2);
  4. the output is the goal-projected iterate where that is collision-free.

The QP is posed over the whole state trajectory (accelerations, positions
and velocities), the dynamics as equality rows, boxes, jerk rows and one
half-space row a pair and step; ADMM is OSQP's, with over-relaxation alpha,
a row-scaled rho, equality rows at ``rho_eq_scale`` times rho, and the
collision rows at ``col_boost`` times rho.  The normal matrix is built by
applying the constraint operator to unit vectors; it is never read from the
program under test.

Nothing here imports the program.  ``Numerics`` names the arithmetic: a
dtype, and for the lower-precision control, matrix products whose operands
are rounded to TF32 (10 bits of mantissa) as the tensor cores round them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEGENERATE_EPS = 1e-6     # a pair closer than this takes a hashed direction
FEAS_SLACK = 0.01         # collision-free: every distance >= R - 0.01
LOOSE_RHO = 1e-6          # rho of a disabled row


class Spec(NamedTuple):
    """The numbers a configuration states (``from_config``)."""
    N: int
    K: int
    h: float
    R: float
    pos_min: tuple
    pos_max: tuple
    vel_lim: tuple
    acc_lim: tuple
    jerk_lim: tuple
    max_scp: int
    rho: float
    sigma: float
    alpha: float
    admm_iters: int
    rho_eq_scale: float
    col_boost: float
    margin: float
    ns_iters: int
    angle_seed: int


def from_config(cfg: dict) -> Spec:
    """The :class:`Spec` of a configuration file's dict."""
    p, s = cfg["problem"], cfg["solver"]
    if s["max_iter"] != s["check_interval"]:
        raise NotImplementedError(
            "the reference runs one check interval a QP (max_iter == "
            "check_interval), as the production solver does")
    if (s["method"], s["factor_form"], s["adaptive_rho"], s["polish"]) != (
            "direct", "X", False, False):
        raise NotImplementedError("the reference implements the production "
                                  "method: direct, X-form, fixed rho, no "
                                  "polish")
    if math.isfinite(float(s["col_penalty"])):
        raise NotImplementedError("the reference holds the collision rows "
                                  "hard (col_penalty inf)")
    if p["stop_mode"] != "feasible" or not p["goal_project"]:
        raise NotImplementedError("the reference stops on feasibility with "
                                  "the goal projection")
    K = int(p["time_horizon"] / p["time_step"])
    box = p["space_dims"]
    return Spec(
        N=p["n_vehicles"], K=K, h=p["time_step"], R=p["min_distance"],
        pos_min=(box[0], box[1]), pos_max=(box[2], box[3]),
        vel_lim=(p["vel_min"], p["vel_max"]),
        acc_lim=(p["acc_min"], p["acc_max"]),
        jerk_lim=(p["jerk_min"], p["jerk_max"]),
        max_scp=p["max_iterations"], rho=s["rho"], sigma=s["sigma"],
        alpha=s["alpha"], admm_iters=s["max_iter"],
        rho_eq_scale=s["rho_eq_scale"], col_boost=s["col_rho_boost"],
        margin=s["collision_margin"], ns_iters=s["ns_iters"],
        angle_seed=cfg["angle_seed"])


class Numerics(NamedTuple):
    """The arithmetic of a reference run: ``dtype`` and, with ``tf32``,
    every matrix product on operands rounded to TF32 (float32 only)."""
    dtype: torch.dtype = torch.float64
    tf32: bool = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero), as the tensor cores read their operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(num: Numerics, a, b):
    """a @ b in the run's arithmetic."""
    if num.tf32:
        return tf32_round(a) @ tf32_round(b)
    return a @ b


# ---------------------------------------------------------------------------
# dynamics, goal projection, feasibility
# ---------------------------------------------------------------------------

def rollout(a, p0, v0, h):
    """Positions and velocities (..., N, K, 2) at k = 0..K-1 of the double
    integrator p' = p + h v + h^2/2 a, v' = v + h a from (p0, v0) (..., N, 2),
    and the terminal state (p_K, v_K)."""
    dv = h * a
    v = torch.cat([torch.zeros_like(a[..., :1, :]), torch.cumsum(dv, -2)],
                  -2) + v0[..., None, :]
    dp = h * v[..., :-1, :] + 0.5 * h * h * a
    p = torch.cat([torch.zeros_like(a[..., :1, :]), torch.cumsum(dp, -2)],
                  -2) + p0[..., None, :]
    return p[..., :-1, :], v[..., :-1, :], p[..., -1, :], v[..., -1, :]


def goal_project(a, p0, v0, pf, vf, h):
    """The least-norm change of a (..., N, K, 2) that puts the terminal
    state on (pf, vf): a + G^T (G G^T)^-1 r, G the (2, K) map from an axis's
    accelerations to its terminal (velocity, position)."""
    K = a.shape[-2]
    j = torch.arange(K, dtype=torch.float64)
    G = torch.stack([torch.full((K,), h, dtype=torch.float64),
                     h * h * (K - j - 0.5)])
    W = (G.T @ torch.linalg.inv(G @ G.T)).to(a.dtype).to(a.device)  # (K, 2)
    _, _, pK, vK = rollout(a, p0, v0, h)
    r = torch.stack([vf - vK, pf - pK], -2)                  # (..., N, 2, 2)
    return a + torch.einsum('kr,...rc->...kc', W, r)


def pair_index(N: int, device=None):
    """(i, j) of every pair i < j, in row-major order of the upper
    triangle."""
    i, j = torch.triu_indices(N, N, 1, device=device)
    return i, j


def pair_diffs(pos, i, j):
    """(..., N, K, 2) -> p_i - p_j as (..., K, P, 2)."""
    return (pos[..., i, :, :] - pos[..., j, :, :]).transpose(-3, -2)


def collision_free(pos, R, i, j):
    """Every pair at least R - FEAS_SLACK apart at every step: (...)."""
    d = pair_diffs(pos, i, j)
    thresh = R - FEAS_SLACK
    return ((d * d).sum(-1) >= thresh * thresh).flatten(-2).all(-1)


_M32 = 0xFFFFFFFF


def _mix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def degenerate_angles(seed, lane_ids, it, i, j, K, dtype):
    """The direction angle of a pair closer than DEGENERATE_EPS, as the
    configuration defines it: a 32-bit hash of (seed, scenario id, SCP
    iteration, i * 65536 + j, k) to 24 bits over [0, 2 pi).  (B, K, P)."""
    dev = lane_ids.device
    h = _mix32(torch.tensor(seed & _M32, dtype=torch.int64, device=dev))
    h = _mix32(h ^ (lane_ids.to(torch.int64) & _M32))
    h = _mix32(h ^ (it.to(torch.int64) & _M32))
    h = _mix32(h[:, None] ^ (i * 65536 + j)[None, :])
    k = torch.arange(K, dtype=torch.int64, device=dev)
    h = _mix32(h[:, None, :] ^ k[None, :, None])
    return (h >> 8).to(dtype) * (2.0 * math.pi / 2.0 ** 24)


# ---------------------------------------------------------------------------
# the QP over the state trajectory
# ---------------------------------------------------------------------------
# Variables, time-major: a[k] (k = 0..K-1), p[k] and v[k] the state at time
# k + 1, each (S, K, N, 2).  Stacked, block k is (a[k], p[k], v[k]) with the
# channel n * 2 + c inside each slot: x (S, K, 6N).
# Rows, time-major: dyn_p, dyn_v (S, K, N, 2): the dynamics from step k to
# k + 1; jerk (S, K-1, N, 2); acc, vbox, pbox (S, K, N, 2); col (S, K, P):
# the pair (i, j) at time k, eta . (p_i - p_j), vacuous at k = 0.
ROWS = ("dyn_p", "dyn_v", "jerk", "acc", "vbox", "pbox", "col")


def stack(a, p, v):
    S, K = a.shape[:2]
    return torch.cat([a.reshape(S, K, -1), p.reshape(S, K, -1),
                      v.reshape(S, K, -1)], -1)


def unstack(x, N):
    S, K = x.shape[:2]
    a, p, v = x.reshape(S, K, 3, N, 2).unbind(2)
    return a, p, v


def apply_A(a, p, v, h, eta=None, i=None, j=None):
    """The rows of (a, p, v); ``col`` only where ``eta`` (S, K, P, 2) is
    given."""
    z = torch.zeros_like(a[:, :1])
    p_prev = torch.cat([z, p[:, :-1]], 1)   # the state at time k (p0 apart)
    v_prev = torch.cat([z, v[:, :-1]], 1)
    rows = dict(dyn_p=p - p_prev - h * v_prev - 0.5 * h * h * a,
                dyn_v=v - v_prev - h * a,
                jerk=(a[:, 1:] - a[:, :-1]) / h, acc=a, vbox=v, pbox=p)
    if eta is not None:
        d = p[:, :-1, i, :] - p[:, :-1, j, :]           # time 1..K-1
        col = (eta[:, 1:] * d).sum(-1)
        rows["col"] = torch.cat([torch.zeros_like(col[:, :1]), col], 1)
    return rows


def apply_AT(rows, h, N, eta=None, i=None, j=None):
    """A^T of ``rows`` as (a, p, v); the collision rows only where ``eta``
    is given."""
    zj = torch.zeros_like(rows["jerk"][:, :1])
    jp = torch.cat([zj, rows["jerk"]], 1)      # jerk[k-1]
    jn = torch.cat([rows["jerk"], zj], 1)      # jerk[k]
    zd = torch.zeros_like(rows["dyn_p"][:, :1])
    dp_next = torch.cat([rows["dyn_p"][:, 1:], zd], 1)
    dv_next = torch.cat([rows["dyn_v"][:, 1:], zd], 1)
    a = (-0.5 * h * h * rows["dyn_p"] - h * rows["dyn_v"] + rows["acc"]
         + (jp - jn) / h)
    p = rows["dyn_p"] - dp_next + rows["pbox"]
    v = rows["dyn_v"] - dv_next - h * dp_next + rows["vbox"]
    if eta is not None:
        w = rows["col"][:, 1:, :, None] * eta[:, 1:]      # (S, K-1, P, 2)
        pc = torch.zeros_like(p)
        pc[:, :-1].index_add_(2, i, w)
        pc[:, :-1].index_add_(2, j, -w)
        p = p + pc
    return a, p, v


def row_scaling(K, h, dtype, device):
    """1 / the norm of each row block's rows, (K, 1, 1) or (K-1, 1, 1)."""
    def col_(vals):
        return torch.tensor(vals, dtype=dtype, device=device)[:, None, None]
    dyn_p = [1 / math.sqrt(1 + h ** 4 / 4)] + [
        1 / math.sqrt(2 + h * h + h ** 4 / 4)] * (K - 1)
    dyn_v = [1 / math.sqrt(1 + h * h)] + [1 / math.sqrt(2 + h * h)] * (K - 1)
    return dict(dyn_p=col_(dyn_p), dyn_v=col_(dyn_v),
                jerk=col_([h / math.sqrt(2)] * (K - 1)), acc=col_([1.0] * K),
                vbox=col_([1.0] * K), pbox=col_([1.0] * K),
                col=1 / math.sqrt(2))


def rho_rows(spec: Spec, dtype, device, collisions: bool):
    """The per-row rho: rho over the row's squared norm, equality rows
    (the dynamics, the terminal box rows) times rho_eq_scale, the
    collision rows times col_boost (LOOSE_RHO at k = 0, and everywhere in
    phase 1)."""
    K, rho = spec.K, spec.rho
    sc = row_scaling(K, spec.h, dtype, device)
    term = torch.zeros((K, 1, 1), dtype=torch.bool, device=device)
    term[-1] = True
    eq = torch.tensor(spec.rho_eq_scale * rho, dtype=dtype, device=device)
    box = torch.where(term, eq, torch.tensor(rho, dtype=dtype, device=device))
    out = dict(dyn_p=eq * sc["dyn_p"] ** 2, dyn_v=eq * sc["dyn_v"] ** 2,
               jerk=rho * sc["jerk"] ** 2, acc=rho * sc["acc"] ** 2,
               vbox=box * sc["vbox"] ** 2, pbox=box * sc["pbox"] ** 2)
    col = torch.full((K, 1), LOOSE_RHO, dtype=dtype, device=device)
    if collisions:
        col[1:] = spec.col_boost * rho * sc["col"] ** 2
    out["col"] = col
    return out


def bounds(spec: Spec, p0, v0, pf, vf):
    """Lower and upper bounds of the static rows, time-major; p0 ... (S, N,
    2)."""
    S, N = p0.shape[:2]
    K, h = spec.K, spec.h
    dt, dev = p0.dtype, p0.device

    def full(k, val):
        return torch.full((S, k, N, 2), val, dtype=dt, device=dev)

    dyn_p = full(K, 0.0)
    dyn_p[:, 0] = p0 + h * v0
    dyn_v = full(K, 0.0)
    dyn_v[:, 0] = v0
    lo = dict(dyn_p=dyn_p, dyn_v=dyn_v, jerk=full(K - 1, spec.jerk_lim[0]),
              acc=full(K, spec.acc_lim[0]), vbox=full(K, spec.vel_lim[0]),
              pbox=torch.tensor(spec.pos_min, dtype=dt,
                                device=dev).expand(S, K, N, 2).clone())
    up = dict(dyn_p=dyn_p, dyn_v=dyn_v, jerk=full(K - 1, spec.jerk_lim[1]),
              acc=full(K, spec.acc_lim[1]), vbox=full(K, spec.vel_lim[1]),
              pbox=torch.tensor(spec.pos_max, dtype=dt,
                                device=dev).expand(S, K, N, 2).clone())
    for b in (lo, up):
        b["vbox"][:, -1] = vf
        b["pbox"][:, -1] = pf
    return lo, up


class Normal(NamedTuple):
    """The collision-free normal matrix M = P + sigma I + A^T rho A of the
    static rows: dense (for phase 1's exact solve: its Cholesky factor) and
    its diagonal and sub-diagonal blocks D (K, n, n), B (K-1, n, n),
    B[k - 1] = M[block k, block k - 1]."""
    chol: torch.Tensor
    D: torch.Tensor
    B: torch.Tensor


def normal_matrix(spec: Spec, rho, dtype, device) -> Normal:
    """Build M column by column: M e = 2 e_a + sigma e + A^T rho A e for the
    unit vectors e of one block at a time."""
    N, K = spec.N, spec.K
    n = 6 * N
    nv = K * n
    M = torch.zeros((nv, nv), dtype=dtype, device=device)
    eye = torch.eye(n, dtype=dtype, device=device)
    for k in range(K):
        x = torch.zeros((n, K, n), dtype=dtype, device=device)
        x[:, k] = eye
        a, p, v = unstack(x, N)
        rows = apply_A(a, p, v, spec.h)
        rows = {r: rows[r] * rho[r] for r in rows}
        ta, tp, tv = apply_AT(rows, spec.h, N)
        Mx = stack(2.0 * a + spec.sigma * a + ta, spec.sigma * p + tp,
                   spec.sigma * v + tv)
        M[:, k * n:(k + 1) * n] = Mx.reshape(n, nv).T
    D = torch.stack([M[k * n:(k + 1) * n, k * n:(k + 1) * n]
                     for k in range(K)])
    B = torch.stack([M[k * n:(k + 1) * n, (k - 1) * n:k * n]
                     for k in range(1, K)])
    off = M.clone()
    for k in range(K):
        off[k * n:(k + 1) * n, max(k - 1, 0) * n:min(k + 2, K) * n] = 0
    if float(off.abs().max()) != 0.0:
        raise AssertionError("the normal matrix is not block-tridiagonal")
    del off
    return Normal(chol=torch.linalg.cholesky(M), D=D, B=B)


def collision_blocks(num: Numerics, eta, rho_col, N, i, j):
    """The collision rows' part of the diagonal blocks' p-p slots,
    sum over pairs of rho g g^T, g = e_i (x) eta - e_j (x) eta: the rows at
    time k + 1 act on block k.  (S, K, 2N, 2N), the last block zero."""
    S, K, P, _ = eta.shape
    E = torch.zeros((N, P), dtype=eta.dtype, device=eta.device)
    pidx = torch.arange(P, device=eta.device)
    E[i, pidx] = 1.0
    E[j, pidx] = -1.0
    G = torch.einsum('np,skpc->skncp', E, eta).reshape(S, K, 2 * N, P)
    colM = mm(num, G * rho_col[..., None, :], G.transpose(-1, -2))
    return torch.cat([colM[:, 1:], torch.zeros_like(colM[:, :1])], 1)


def spd_inverse(S):
    X = torch.cholesky_inverse(torch.linalg.cholesky(S))
    return 0.5 * (X + X.transpose(-1, -2))


def factor_X(num: Numerics, D, B, ns_iters: int):
    """X-form factors: X_k the inverse of S_k = D_k - B_k X_{k-1} B_k^T,
    exact at k = 0, 1, 2 and K-1, else ``ns_iters`` Newton-Schulz steps
    X <- 2 X - X S X from X_{k-1}, then made symmetric.  D (S, K, n, n),
    B (K-1, n, n)."""
    K = D.shape[1]
    exact = {0, 1, 2, K - 1} if ns_iters > 0 else set(range(K))
    X = torch.empty_like(D)
    X[:, 0] = spd_inverse(D[:, 0])
    for k in range(1, K):
        Bk = B[k - 1]
        Sk = D[:, k] - mm(num, mm(num, Bk, X[:, k - 1]), Bk.T)
        if k in exact:
            X[:, k] = spd_inverse(Sk)
            continue
        Xk = X[:, k - 1]
        for _ in range(ns_iters):
            Xk = 2.0 * Xk - mm(num, Xk, mm(num, Sk, Xk))
        X[:, k] = 0.5 * (Xk + Xk.transpose(-1, -2))
    return X


def solve_X(num: Numerics, X, B, b):
    """M x = b on the X-form factors: w_k = X_k (b_k - B_k w_{k-1}),
    x_{K-1} = w_{K-1}, x_k = w_k - X_k B_{k+1}^T x_{k+1}.  b (S, K, n)."""
    K = X.shape[1]

    def mv(M, t):
        return mm(num, M, t[..., None])[..., 0]
    w = [mv(X[:, 0], b[:, 0])]
    for k in range(1, K):
        w.append(mv(X[:, k], b[:, k] - mv(B[k - 1], w[-1])))
    x = [None] * K
    x[K - 1] = w[K - 1]
    for k in range(K - 2, -1, -1):
        x[k] = w[k] - mv(X[:, k], mv(B[k].T, x[k + 1]))
    return torch.stack(x, 1)


def admm(spec: Spec, solve, x, z, y, lo, up, rho, eta, i, j):
    """``admm_iters`` OSQP iterations from (x, z, y); the collision rows'
    projection onto [lower, inf)."""
    N, h, al = spec.N, spec.h, spec.alpha
    a, p, v = x
    for _ in range(spec.admm_iters):
        rzy = {r: rho[r] * z[r] - y[r] for r in z}
        ta, tp, tv = apply_AT(rzy, h, N, eta, i, j)
        b = stack(ta + spec.sigma * a, tp + spec.sigma * p,
                  tv + spec.sigma * v)
        xt = unstack(solve(b), N)
        a, p, v = (al * t + (1 - al) * u for t, u in zip(xt, (a, p, v)))
        At = apply_A(*xt, h, eta, i, j)
        zr = {r: al * At[r] + (1 - al) * z[r] for r in z}
        w = {r: zr[r] + y[r] / rho[r] for r in z}
        zn = {r: torch.clamp(w[r], lo[r], up[r]) for r in z}
        zn["col"] = torch.maximum(w["col"], lo["col"])
        y = {r: y[r] + rho[r] * (zr[r] - zn[r]) for r in z}
        z = zn
    return (a, p, v), y


def _warm(a, p0, v0, h):
    """(a, p, v) time-major from accelerations (S, N, K, 2): the states of
    the exact rollout at times 1..K."""
    pos, vel, pK, vK = rollout(a, p0, v0, h)
    p = torch.cat([pos[..., 1:, :], pK[..., None, :]], -2)
    v = torch.cat([vel[..., 1:, :], vK[..., None, :]], -2)
    return tuple(t.transpose(1, 2) for t in (a, p, v))


def _clamp_rows(rows, lo, up):
    return {r: torch.clamp(rows[r], lo[r], up[r]) for r in rows}


class Result(NamedTuple):
    accelerations: torch.Tensor   # (S, N, K, 2)
    positions: torch.Tensor       # (S, N, K, 2)
    iterations: torch.Tensor      # (S,) SCP iterations
    status: torch.Tensor          # (S,) 0 / 1 / 2
    feasible_final: torch.Tensor  # (S,)


def solve(spec: Spec, p0, pf, lane_ids, num: Numerics = Numerics(),
          normal: dict | None = None) -> Result:
    """Solve the scenarios (S, N, 2) from rest to rest; ``lane_ids`` (S,)
    the scenarios' places in their call's batch, which key the degenerate
    directions.  ``normal``: a dict that keeps the normal matrices between
    calls of one arithmetic."""
    dt = num.dtype
    dev = p0.device
    p0, pf = p0.to(dt), pf.to(dt)
    v0 = torch.zeros_like(p0)
    S, N = p0.shape[:2]
    K, h, R = spec.K, spec.h, spec.R
    pi, pj = pair_index(N, dev)
    P = pi.numel()
    normal = {} if normal is None else normal
    key = (dt, str(dev))
    if key not in normal:
        normal[key] = normal_matrix(spec, rho_rows(spec, dt, dev, False),
                                    dt, dev)
    nm = normal[key]
    lo, up = bounds(spec, p0, v0, pf, v0)
    inf = torch.full((S, K, P), math.inf, dtype=dt, device=dev)
    lo["col"], up["col"] = -inf, inf

    def feasible_projected(a, sel):
        ag = goal_project(a, p0[sel], v0[sel], pf[sel], v0[sel], h)
        return collision_free(rollout(ag, p0[sel], v0[sel], h)[0], R, pi, pj)

    # phase 1
    rho1 = rho_rows(spec, dt, dev, False)
    x = _warm(torch.zeros((S, N, K, 2), dtype=dt, device=dev), p0, v0, h)
    eta0 = torch.zeros((S, K, P, 2), dtype=dt, device=dev)
    z = _clamp_rows(apply_A(*x, h, eta0, pi, pj), lo, up)
    y = {r: torch.zeros_like(z[r]) for r in z}

    def solve_exact(b):
        return torch.cholesky_solve(b.reshape(S, -1).T, nm.chol).T.reshape(
            b.shape)
    x, y = admm(spec, solve_exact, x, z, y, lo, up, rho1, eta0, pi, pj)
    a = x[0].transpose(1, 2).contiguous()
    every = torch.arange(S, device=dev)
    feas0 = feasible_projected(a, every)

    it = torch.zeros(S, dtype=torch.int64, device=dev)
    stop = torch.zeros(S, dtype=torch.bool, device=dev)
    rho2 = rho_rows(spec, dt, dev, True)
    acc_cap = 2.0 * max(abs(spec.acc_lim[0]), abs(spec.acc_lim[1]))
    while True:
        idx = torch.nonzero((it < spec.max_scp) & ~stop & ~feas0)[:, 0]
        if idx.numel() == 0:
            break
        m = idx.numel()
        al = a[idx]
        pos = rollout(al, p0[idx], v0[idx], h)[0]
        diff = pair_diffs(pos, pi, pj)                       # (m, K, P, 2)
        dist = diff.norm(dim=-1)
        degen = dist < DEGENERATE_EPS
        ang = degenerate_angles(spec.angle_seed, lane_ids[idx], it[idx], pi,
                                pj, K, dt)
        safe = torch.where(degen, torch.ones_like(dist), dist)
        eta = torch.where(degen[..., None],
                          torch.stack([ang.cos(), ang.sin()], -1),
                          diff / safe[..., None])
        col_lo = R + spec.margin + (eta * diff).sum(-1) - safe
        col_lo[:, 0] = -math.inf
        lo_i = {r: lo[r][idx] for r in lo}
        up_i = {r: up[r][idx] for r in up}
        lo_i["col"] = col_lo
        D = nm.D.expand(m, -1, -1, -1).clone()
        n2 = 2 * N
        D[:, :, n2:2 * n2, n2:2 * n2] += collision_blocks(
            num, eta, rho2["col"].expand(K, P), N, pi, pj)
        X = factor_X(num, D, nm.B, spec.ns_iters)
        del D
        xw = _warm(al, p0[idx], v0[idx], h)
        z = _clamp_rows(apply_A(*xw, h, eta, pi, pj), lo_i, up_i)
        y_i = {r: y[r][idx] for r in y}
        (an, _, _), y_i = admm(spec, lambda b: solve_X(num, X, nm.B, b), xw,
                               z, y_i, lo_i, up_i, rho2, eta, pi, pj)
        del X
        an = an.transpose(1, 2)
        flat = an.flatten(1)
        bad = ~torch.isfinite(flat).all(-1) | (flat.abs().amax(-1) > acc_cap)
        an = torch.where(bad[:, None, None, None], al, an)
        a[idx] = an
        for r in y:
            y[r][idx] = y_i[r]
        it[idx] += 1
        stop[idx] = feasible_projected(an, idx)

    ag = goal_project(a, p0, v0, pf, v0, h)
    feas_g = collision_free(rollout(ag, p0, v0, h)[0], R, pi, pj)
    a_out = torch.where(feas_g[:, None, None, None], ag, a)
    pos = rollout(a_out, p0, v0, h)[0]
    status = torch.where(feas0, 0, torch.where(stop, 1, 2))
    return Result(accelerations=a_out, positions=pos, iterations=it,
                  status=status, feasible_final=collision_free(pos, R, pi, pj))
