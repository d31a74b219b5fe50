"""Matrix-free ADMM QP solver over the accelerations, the CG method
(counterpart of ``ba_path_planning_tpu.solvers.admm``).

Solves, for a batch of scenarios (the leading axis), with OSQP's iteration

    min  ||x||^2   s.t.   l <= A x <= u

where A is the operator of ``ops/constraints.py``.  The x-update system
(2 + sigma) x + A^T diag(rho) A x = b is solved by preconditioned CG; the
preconditioner is the exact inverse of its collision-free part, from the
eigendecomposition of one K x K matrix computed in float64 on the host
(:func:`build_static_normal_inverse`).  Termination follows OSQP, checked
every ``check_interval`` iterations; with ``adaptive_rho`` each lane's rho
adapts after each interval (a scalar a lane: nothing is refactorized).

Every lane runs the same number of PCG iterations (``cg_iters``), a lane
that meets ``cg_tol`` keeping its values from then on, as each lane of the
JAX package's vmapped PCG loop does; the host reads nothing inside the PCG
loop and one flag per ADMM check interval.  The method launches no
hand-written kernel; on the card a check interval is replayed as a CUDA
graph (``utils/graphs.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.double_integrator import DoubleIntegrator2D
from ..ops.constraints import (ConstraintBlocks, apply_collision,
                               apply_collision_adjoint, apply_static,
                               apply_static_adjoint)
from ..ops.matmul_ops import (apply_collision_adjoint_matmul,
                              apply_collision_matmul,
                              apply_static_adjoint_matmul,
                              apply_static_matmul)
from ..utils.config import SolverConfig, SolverParams, SolverStatic
from ..utils.graphs import graphed
from .banded import (_LOOSE_RHO, RHO_ADAPT_RATIO, RHO_MAX, RHO_MIN,
                     _inf_norm, lane_mask, tree_map)

class QPData(NamedTuple):
    """One QP a lane: eta (B, K, P, 2), ``col_mask`` (a 0-d tensor, 1.0
    enables the collision rows), bounds as (B, ...) ConstraintBlocks."""
    eta: torch.Tensor
    col_mask: torch.Tensor
    lower: ConstraintBlocks
    upper: ConstraintBlocks


class QPState(NamedTuple):
    x: torch.Tensor            # (B, N, K, 2) accelerations
    z: ConstraintBlocks
    y: ConstraintBlocks
    iters: torch.Tensor        # (B,) int32 ADMM iterations run
    prim_res: torch.Tensor     # (B,) residuals at the last check
    dual_res: torch.Tensor
    converged: torch.Tensor    # (B,) bool


# ---------------------------------------------------------------------------
# Row equilibration: closed-form row norms -> per-row rho pattern
# ---------------------------------------------------------------------------
#
# Scaling row i by d_i = 1/||A_i|| is ADMM with rho_i = rho d_i^2, and every
# row norm has a closed form (|eta| = 1 on the collision rows):
#   jerk: sqrt(2)/h;  acc: 1;  vel row k: h sqrt(k+1);
#   pos row k: h^2 sqrt(sum_{m<=k} (m+0.5)^2);
#   collision row k: sqrt(2) h^2 sqrt(sum_{m<k} (m+0.5)^2)  (1 at k = 0)

def _row_norms_np(K: int, h: float):
    m = np.arange(K) + 0.5
    cum = np.cumsum(m * m)
    jerk = np.full(K - 1, np.sqrt(2.0) / h)
    acc = np.ones(K)
    vel = h * np.sqrt(np.arange(1, K + 1, dtype=np.float64))
    pos = h * h * np.sqrt(cum)
    col = np.zeros(K)
    col[1:] = np.sqrt(2.0) * h * h * np.sqrt(cum[:-1])
    col[0] = 1.0                                 # the vacuous all-zero row
    return jerk, acc, vel, pos, col


def build_row_scaling(n_steps: int, h: float, dtype=torch.float32,
                      device=None) -> ConstraintBlocks:
    """Row scales d = 1/||A_i|| as (K', 1) columns, one a block."""
    def d(v):
        return torch.as_tensor((1.0 / v)[:, None], dtype=dtype,
                               device=device)
    return ConstraintBlocks(*map(d, _row_norms_np(n_steps, h)))


# ---------------------------------------------------------------------------
# Preconditioner: exact inverse of the static-block normal matrix
# ---------------------------------------------------------------------------

class Preconditioner(NamedTuple):
    """B = Q diag(lam) Q^T of the equilibrated static normal matrix, so
    that M(rho)^{-1} = Q diag(1/(2+sigma+rho lam)) Q^T is the exact inverse
    of the collision-free x-update system for any rho."""
    Q: torch.Tensor      # (K, K)
    lam: torch.Tensor    # (K,)


def build_static_normal_inverse(n_steps: int, h: float, cfg: SolverConfig,
                                dtype=torch.float32,
                                device=None) -> Preconditioner:
    """Eigendecomposition of B = sum_b C_b^T diag(w_b) C_b, w the row
    pattern 1/||A_i||^2 with the ``rho_eq_scale`` boost on the terminal
    equality rows; the same for every vehicle, axis and scenario.  Computed
    in float64 numpy, then cast."""
    K = n_steps
    model = DoubleIntegrator2D(n_steps=K, time_step=h)
    J = model.jerk_matrix()
    T = model.velocity_matrix()
    S = model.position_matrix()
    n_jerk, n_acc, n_vel, n_pos, _ = _row_norms_np(K, h)
    w_vel = 1.0 / n_vel ** 2
    w_pos = 1.0 / n_pos ** 2
    w_vel[K - 1] *= cfg.rho_eq_scale    # terminal equality rows
    w_pos[K - 1] *= cfg.rho_eq_scale
    B = J.T @ np.diag(1.0 / n_jerk ** 2) @ J
    B += np.diag(1.0 / n_acc ** 2)
    B += T.T @ np.diag(w_vel) @ T
    B += S.T @ np.diag(w_pos) @ S
    lam, Q = np.linalg.eigh(B)
    return Preconditioner(Q=torch.as_tensor(Q, dtype=dtype, device=device),
                          lam=torch.as_tensor(lam, dtype=dtype,
                                              device=device))


# ---------------------------------------------------------------------------
# Operator plumbing
# ---------------------------------------------------------------------------

def _apply_A(x, eta, E, h, col_mask, impl: str = "scan") -> ConstraintBlocks:
    if impl == "matmul":
        jerk, acc, vel, pos = apply_static_matmul(x, h)
        col = apply_collision_matmul(x, eta, E, h)
    else:
        jerk, acc, vel, pos = apply_static(x, h)
        col = apply_collision(x, eta, E, h)
    return ConstraintBlocks(jerk=jerk, acc=acc, vel=vel, pos=pos,
                            col=col * col_mask)


def _apply_AT(y: ConstraintBlocks, eta, E, h, col_mask, impl: str = "scan"):
    if impl == "matmul":
        return (apply_static_adjoint_matmul(y.jerk, y.acc, y.vel, y.pos, h)
                + apply_collision_adjoint_matmul(y.col * col_mask, eta, E, h))
    return (apply_static_adjoint(y.jerk, y.acc, y.vel, y.pos, h)
            + apply_collision_adjoint(y.col * col_mask, eta, E, h))


def _rho_blocks(data: QPData, static: SolverStatic, rho: torch.Tensor,
                scaling: ConstraintBlocks, col_boost=1.0) -> ConstraintBlocks:
    """Per-row rho = rho d_i^2 with one rho a lane (B,), equality rows
    boosted by ``rho_eq_scale``, disabled collision rows at the loose
    rho."""
    def block_rho(lo, up, d):
        base = lane_mask(rho, lo) * d * d
        return torch.where(lo == up, static.rho_eq_scale * base, base)

    col_base = col_boost * rho[:, None, None] * scaling.col * scaling.col
    col_rho = torch.where(data.col_mask > 0, col_base,
                          torch.full_like(col_base, _LOOSE_RHO))
    lo, up = data.lower, data.upper
    return ConstraintBlocks(
        jerk=block_rho(lo.jerk, up.jerk, scaling.jerk),
        acc=block_rho(lo.acc, up.acc, scaling.acc),
        vel=block_rho(lo.vel, up.vel, scaling.vel),
        pos=block_rho(lo.pos, up.pos, scaling.pos),
        col=col_rho.expand(lo.col.shape))


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dot product of two (B, ...) tensors."""
    return (a * b).flatten(1).sum(-1)


def _precond_apply(pc: Preconditioner, rho, sigma, r: torch.Tensor):
    """M(rho)^{-1} r along the K axis, one rho a lane (B,):
    Q diag(1/(2 + sigma + rho lam)) Q^T r for r (B, N, K, 2)."""
    qt_r = torch.einsum('lk,...nlc->...nkc', pc.Q, r)
    qt_r = qt_r / (2.0 + sigma + rho[:, None] * pc.lam)[:, None, :, None]
    return torch.einsum('kl,...nlc->...nkc', pc.Q, qt_r)


# ---------------------------------------------------------------------------
# PCG x-update
# ---------------------------------------------------------------------------

def _solve_xupdate(b, x0, eta, E, h, rho: ConstraintBlocks, rho_scalar,
                   sigma, pc: Preconditioner, static: SolverStatic,
                   params: SolverParams):
    """Solve (2 + sigma) x + A^T diag(rho) A x = b by PCG from x0 for every
    lane: ``cg_iters`` iterations, a lane whose residual meets ``cg_tol``
    (||r|| <= cg_tol ||b||) keeping its values from then on.  Returns x and
    the iterations each lane ran."""
    impl = static.operator_impl

    def matvec(v):
        rAv = tree_map(torch.mul, _apply_A(v, eta, E, h, 1.0, impl), rho)
        return (2.0 + sigma) * v + _apply_AT(rAv, eta, E, h, 1.0, impl)

    r = b - matvec(x0)
    z = _precond_apply(pc, rho_scalar, sigma, r)
    x, p, rz = x0, z, _lane_dot(r, z)
    tol2 = params.cg_tol ** 2 * torch.clamp_min(_lane_dot(b, b), 1e-30)
    its = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    for _ in range(int(params.cg_iters)):
        live = _lane_dot(r, r) > tol2
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(_lane_dot(p, Ap), 1e-30)
        x_n = x + lane_mask(alpha, p) * p
        r_n = r - lane_mask(alpha, Ap) * Ap
        z = _precond_apply(pc, rho_scalar, sigma, r_n)
        rz_n = _lane_dot(r_n, z)
        beta = rz_n / torch.clamp_min(rz, 1e-30)
        p_n = z + lane_mask(beta, p) * p
        keep = lane_mask(live, x)
        x = torch.where(keep, x_n, x)
        r = torch.where(keep, r_n, r)
        p = torch.where(keep, p_n, p)
        rz = torch.where(live, rz_n, rz)
        its = its + live.to(torch.int32)
    return x, its


# ---------------------------------------------------------------------------
# Main solve
# ---------------------------------------------------------------------------

def solve_qp_impl(data: QPData, E, Minv: Preconditioner, x_init,
                  params: SolverParams, y_init: ConstraintBlocks | None = None,
                  *, h: float, static: SolverStatic) -> QPState:
    """One ADMM solve a lane for a batch: ``x_init`` (B, N, K, 2) the warm
    start, ``y_init`` the dual warm start (zeros when None).  Intervals of
    ``check_interval`` iterations run while a lane has not converged and
    ``iters < max_iter``; a lane that stops keeps its state.  With
    ``adaptive_rho`` each lane's rho (a scalar) adapts after each interval
    by OSQP's rule, y not rescaled; with ``polish`` the CG active-set polish
    refines x at the end."""
    dtype, dev = x_init.dtype, x_init.device
    eta, sigma, alpha = data.eta, params.sigma, params.alpha
    B, K = x_init.shape[0], x_init.shape[-2]
    scaling = build_row_scaling(K, h, dtype=dtype, device=dev)
    impl = static.operator_impl
    check, max_iter = int(params.check_interval), int(params.max_iter)

    x = x_init
    z = tree_map(torch.clamp, _apply_A(x_init, eta, E, h, data.col_mask, impl),
                 data.lower, data.upper)
    y = tree_map(torch.zeros_like, z) if y_init is None else y_init
    rho = params.rho.to(dtype).expand(B).clone()

    def admm_iter(x, z, y, rho_b, rho):
        rzy = tree_map(lambda zz, yy, rr: rr * zz - yy, z, y, rho_b)
        b = sigma * x + _apply_AT(rzy, eta, E, h, 1.0, impl)
        x_t, _ = _solve_xupdate(b, x, eta, E, h, rho_b, rho, sigma, Minv,
                                static, params)
        x_new = alpha * x_t + (1.0 - alpha) * x
        z_rel = tree_map(lambda azt, zz: alpha * azt + (1.0 - alpha) * zz,
                         _apply_A(x_t, eta, E, h, data.col_mask, impl), z)
        z_new = tree_map(lambda zr, yy, rr, lo, up: torch.clamp(zr + yy / rr,
                                                             lo, up),
                         z_rel, y, rho_b, data.lower, data.upper)
        # exact-penalty soft prox on the collision rows (hard at lam = inf)
        w_col = z_rel.col + y.col / rho_b.col
        z_col = torch.where(w_col >= data.lower.col, w_col,
                            torch.minimum(w_col + params.col_penalty
                                          / rho_b.col, data.lower.col))
        z_new = z_new._replace(col=z_col)
        y_new = tree_map(lambda yy, zr, zn, rr: yy + rr * (zr - zn),
                         y, z_rel, z_new, rho_b)
        return x_new, z_new, y_new

    def residuals(x, z, y):
        dAx = tree_map(torch.mul, _apply_A(x, eta, E, h, data.col_mask, impl),
                       scaling)
        dz = tree_map(torch.mul, z, scaling)
        prim = _inf_norm(tree_map(torch.sub, dAx, dz), 1)
        ATy = _apply_AT(y, eta, E, h, data.col_mask, impl)
        dual = (2.0 * x + ATy).abs().flatten(1).amax(-1)
        prim_scale = torch.maximum(_inf_norm(dAx, 1), _inf_norm(dz, 1))
        dual_scale = torch.maximum((2.0 * x).abs().flatten(1).amax(-1),
                                   ATy.abs().flatten(1).amax(-1))
        done = ((prim <= params.eps_abs + params.eps_rel * prim_scale)
                & (dual <= params.eps_abs + params.eps_rel * dual_scale))
        return (prim, dual, done, prim / torch.clamp_min(prim_scale, 1e-10),
                dual / torch.clamp_min(dual_scale, 1e-10))

    @graphed
    def interval(x, z, y, rho):
        """``check`` iterations and the residuals after them."""
        rho_b = _rho_blocks(data, static, rho, scaling, params.col_rho_boost)
        for _ in range(check):
            x, z, y = admm_iter(x, z, y, rho_b, rho)
        return (x, z, y) + residuals(x, z, y)

    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    prim = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    dual = prim.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    active = ~done
    for it in range(0, max_iter, check):
        if it > 0 and not bool(active.any()):
            break
        solve_qp_impl.iterations += check
        xn, zn, yn, pn, dn, donen, pr, dr = interval(x, z, y, rho)

        def keep(n_, o_):
            return torch.where(lane_mask(active, n_), n_, o_)
        x = keep(xn, x)
        z, y = (tree_map(keep, n_, o_) for n_, o_ in ((zn, z), (yn, y)))
        prim, dual, done = keep(pn, prim), keep(dn, dual), keep(donen, done)
        iters = iters + check * active.to(torch.int32)
        if static.adaptive_rho:
            ratio = torch.sqrt(pr / torch.clamp_min(dr, 1e-12))
            adapt = active & ((ratio > RHO_ADAPT_RATIO)
                              | (ratio < 1.0 / RHO_ADAPT_RATIO))
            rho = torch.where(adapt, torch.clamp(rho * ratio, RHO_MIN,
                                                 RHO_MAX), rho)
        active = active & ~done

    if static.polish:
        x, prim, dual = _polish(x, y, data, E, h=h, static=static,
                                params=params, prim0=prim, dual0=dual)
    return QPState(x=x, z=z, y=y, iters=iters, prim_res=prim, dual_res=dual,
                   converged=done)


# ADMM iterations run by the batches, summed over calls
solve_qp_impl.iterations = 0


# ---------------------------------------------------------------------------
# Polishing: exact solve on the detected active set (OSQP's polish)
# ---------------------------------------------------------------------------

def _polish(x, y: ConstraintBlocks, data: QPData, E, *, h,
            static: SolverStatic, params: SolverParams, prim0, dual0):
    """Refine x by solving min ||x||^2 s.t. A_act x = b_act on the active
    set the duals identify (y < 0: lower bound, y > 0: upper), by CG on the
    equilibrated, delta-regularized row-space Gram system with one step of
    iterative refinement: x = A_act^T D nu.  A lane takes the polished x
    only where it does not worsen the measured KKT residuals."""
    dtype = x.dtype
    impl = static.operator_impl
    eps_act = 1e-10

    mask = tree_map(lambda v: (v.abs() > eps_act).to(dtype), y)
    # never activate disabled collision rows, nor, in the soft (penalty)
    # mode, rows whose dual sits at the penalty bound
    soft_ok = (y.col.abs() < 0.999 * params.col_penalty).to(dtype)
    mask = mask._replace(col=mask.col * soft_ok * data.col_mask)

    def act_bound(yv, lo, up):
        b = torch.where(yv < 0, lo, up)
        return torch.where(torch.isfinite(b), b, torch.zeros_like(b))
    b_act = tree_map(act_bound, y, data.lower, data.upper)

    dscale = build_row_scaling(x.shape[-2], h, dtype=dtype, device=x.device)
    md = tree_map(torch.mul, mask, dscale)
    b_act = tree_map(torch.mul, b_act, md)
    delta = 1e-9

    def G(mu: ConstraintBlocks) -> ConstraintBlocks:
        v = _apply_AT(tree_map(torch.mul, mu, md), data.eta, E, h, 1.0, impl)
        Av = _apply_A(v, data.eta, E, h, 1.0, impl)
        return tree_map(lambda a, m, u_: a * m + delta * u_, Av, md, mu)

    def tdot(a, b_):
        return sum(_lane_dot(u_, v) for u_, v in zip(a, b_))

    def axpy(s, u_, v):
        return tree_map(lambda p_, q_: p_ + lane_mask(s, p_) * q_, u_, v)

    def cg(rhs, n_iters):
        mu = tree_map(torch.zeros_like, rhs)
        r, p = rhs, rhs
        rr = tdot(r, r)
        for _ in range(n_iters):
            Gp = G(p)
            al = rr / torch.clamp_min(tdot(p, Gp), 1e-30)
            mu = axpy(al, mu, p)
            r = axpy(-al, r, Gp)
            rr_new = tdot(r, r)
            p = axpy(rr_new / torch.clamp_min(rr, 1e-30), r, p)
            rr = rr_new
        return mu

    n_cg = int(params.polish_cg_iters)
    mu = cg(b_act, n_cg)
    # one step of iterative refinement
    mu = tree_map(torch.add, mu, cg(tree_map(torch.sub, b_act, G(mu)), n_cg))
    mu_m = tree_map(torch.mul, mu, md)
    x_pol = _apply_AT(mu_m, data.eta, E, h, 1.0, impl)

    def kkt_residuals(xv, yv):
        Ax = _apply_A(xv, data.eta, E, h, data.col_mask, impl)
        zero = torch.zeros((), dtype=dtype, device=x.device)
        viol = tree_map(lambda a, lo, up: torch.clamp_min(torch.maximum(
            torch.where(torch.isfinite(lo), lo - a, zero),
            torch.where(torch.isfinite(up), a - up, zero)), 0.0),
            Ax, data.lower, data.upper)
        dual = (2.0 * xv + _apply_AT(yv, data.eta, E, h, data.col_mask,
                                     impl)).abs().flatten(1).amax(-1)
        return _inf_norm(viol, 1), dual

    prim_p, dual_p = kkt_residuals(x_pol, tree_map(lambda m_: -2.0 * m_,
                                                   mu_m))
    prim_u, dual_u = kkt_residuals(x, y)
    better = (prim_p <= prim_u + 1e-12) & (dual_p <= dual_u + 1e-12)
    return (torch.where(lane_mask(better, x), x_pol, x),
            torch.where(better, prim_p, prim0),
            torch.where(better, dual_p, dual0))
