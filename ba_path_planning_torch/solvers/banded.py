"""State-space ADMM QP solver with exact block-tridiagonal x-updates
(counterpart of ``ba_path_planning_tpu.solvers.banded``).

The QP is posed over the whole state trajectory: variables a[0..K-1],
p[1..K], v[1..K] per vehicle and axis, with the discrete dynamics as banded
equality rows.  Every constraint is then local in time, so the ADMM normal
matrix  M = P + sigma I + A^T rho A  is block-tridiagonal with K blocks of
size 6N.  Super-block u_k = (a_k, p_{k+1}, v_{k+1}) has the flat layout
``idx = slot * 2N + n * 2 + c`` with slot 0:a, 1:p, 2:v.

Every function takes tensors with leading batch axes (``...``) where the JAX
package vmapped a per-scenario function; the scenario axis is explicit and
comes first.  :func:`solve_qp_state` runs check intervals until every lane
has converged or spent its budget, without adaptive rho and without polish:
the shared per-channel factorization for the collision-free QP and, for
every QP with collision rows, X-form, L-only or dense (Linv, Eb) factors with
either a sweep kernel per ADMM iteration or a fused kernel for the whole
interval (:func:`qp_route`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.collisions import PairIndex, pairwise_diffs
from ..utils.config import SolverParams, SolverStatic

_LOOSE_RHO = 1e-6   # rho on disabled (+-inf) rows; OSQP's RHO_MIN


# ---------------------------------------------------------------------------
# Variable / row containers
# ---------------------------------------------------------------------------

class StateVars(NamedTuple):
    """Decision variables, (..., N, K, 2) each: a[k] for k = 0..K-1;
    p[k], v[k] for k = 1..K stored at index k-1."""
    a: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor


class RowVals(NamedTuple):
    """Constraint row values, one leaf per block.

    dyn_p, dyn_v: (..., N, K, 2) dynamics equalities for k = 0..K-1
    jerk:         (..., N, K-1, 2)
    acc:          (..., N, K, 2)   box on a
    vbox:         (..., N, K, 2)   box on v[1..K] (terminal equality at K)
    pbox:         (..., N, K, 2)   box on p[1..K] (terminal equality at K)
    col:          (..., K, P)      eta . (p_i[k] - p_j[k]); row k = 0 vacuous
    """
    dyn_p: torch.Tensor
    dyn_v: torch.Tensor
    jerk: torch.Tensor
    acc: torch.Tensor
    vbox: torch.Tensor
    pbox: torch.Tensor
    col: torch.Tensor


def tree_map(f, *ts):
    """Apply ``f`` leafwise to (nested) NamedTuples of one structure."""
    return type(ts[0])(*[tree_map(f, *vs) if isinstance(vs[0], tuple)
                         else f(*vs) for vs in zip(*ts)])


def lane_mask(mask, t):
    """A per-lane mask (B,), shaped to broadcast against ``t`` (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))


def _inf_norm(t, batch_dims: int = 0) -> torch.Tensor:
    """Max |entry| over every leaf, per index of the ``batch_dims`` leading
    axes (a scalar when ``batch_dims`` is 0)."""
    maxes = [v.abs().flatten(batch_dims).amax(-1) for v in t if v.numel() > 0]
    return torch.stack(maxes).amax(0)


# ---------------------------------------------------------------------------
# Constraint operator (all local in time)
# ---------------------------------------------------------------------------

def apply_A(xv: StateVars, eta, E, h: float) -> RowVals:
    a, p, v = xv.a, xv.p, xv.v
    p_prev = p[..., :-1, :]
    v_prev = v[..., :-1, :]
    # dynamics rows: p-row_k = p[k+1] - p[k] - h v[k] - h^2/2 a[k],
    # v-row_k = v[k+1] - v[k] - h a[k]; p[0], v[0] are constants
    dyn_p0 = p[..., 0:1, :] - 0.5 * h * h * a[..., 0:1, :]
    dyn_pk = (p[..., 1:, :] - p_prev - h * v_prev
              - 0.5 * h * h * a[..., 1:, :])
    dyn_p = torch.cat([dyn_p0, dyn_pk], dim=-2)
    dyn_v0 = v[..., 0:1, :] - h * a[..., 0:1, :]
    dyn_vk = v[..., 1:, :] - v_prev - h * a[..., 1:, :]
    dyn_v = torch.cat([dyn_v0, dyn_vk], dim=-2)

    jerk = (a[..., 1:, :] - a[..., :-1, :]) / h

    # collision rows: k = 0 vacuous, k >= 1 uses p[k] (index k-1)
    dp = torch.einsum('np,...nkc->...kpc', E, p)
    col_k = torch.sum(eta[..., 1:, :, :] * dp[..., :-1, :, :], dim=-1)
    col = torch.cat([torch.zeros_like(col_k[..., 0:1, :]), col_k], dim=-2)
    return RowVals(dyn_p=dyn_p, dyn_v=dyn_v, jerk=jerk, acc=a, vbox=v,
                   pbox=p, col=col)


def apply_AT(y: RowVals, eta, E, h: float) -> StateVars:
    yj = F.pad(y.jerk, (0, 0, 1, 1))
    a = (-0.5 * h * h * y.dyn_p - h * y.dyn_v
         + (yj[..., :-1, :] - yj[..., 1:, :]) / h + y.acc)

    dyn_p_next = torch.cat(
        [y.dyn_p[..., 1:, :], torch.zeros_like(y.dyn_p[..., 0:1, :])], dim=-2)
    p = y.dyn_p - dyn_p_next + y.pbox
    w = y.col[..., None] * eta
    w_shift = torch.cat(
        [w[..., 1:, :, :], torch.zeros_like(w[..., 0:1, :, :])], dim=-3)
    p = p + torch.einsum('np,...kpc->...nkc', E, w_shift)

    dyn_v_next = torch.cat(
        [y.dyn_v[..., 1:, :], torch.zeros_like(y.dyn_v[..., 0:1, :])], dim=-2)
    v = -h * dyn_p_next + y.dyn_v - dyn_v_next + y.vbox
    return StateVars(a=a, p=p, v=v)


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

def build_bounds(p0, v0, pf, vf, *, n_vehicles: int, n_steps: int, h: float,
                 limits, n_pairs: int) -> tuple[RowVals, RowVals]:
    """Lower and upper bounds of every row block; p0/v0/pf/vf (..., N, 2).
    Collision rows start disabled (-inf / +inf)."""
    N, K = n_vehicles, n_steps
    dt, dev = p0.dtype, p0.device
    batch = tuple(p0.shape[:-2])

    def full(shape, val):
        return torch.full(batch + shape, val, dtype=dt, device=dev)

    zero = torch.zeros(batch + (N, K - 1, 2), dtype=dt, device=dev)
    dyn_p_rhs = torch.cat([(p0 + h * v0)[..., :, None, :], zero], dim=-2)
    dyn_v_rhs = torch.cat([v0[..., :, None, :], zero], dim=-2)

    is_term = (torch.arange(K, device=dev) == K - 1).reshape(K, 1)
    vf_b = vf[..., :, None, :].expand(batch + (N, K, 2))
    l_v = torch.where(is_term, vf_b, full((N, K, 2), limits.vel_min))
    u_v = torch.where(is_term, vf_b, full((N, K, 2), limits.vel_max))
    pf_b = pf[..., :, None, :].expand(batch + (N, K, 2))
    pos_min = torch.tensor(limits.pos_min, dtype=dt, device=dev)
    pos_max = torch.tensor(limits.pos_max, dtype=dt, device=dev)
    l_p = torch.where(is_term, pf_b, pos_min.expand(batch + (N, K, 2)))
    u_p = torch.where(is_term, pf_b, pos_max.expand(batch + (N, K, 2)))

    lower = RowVals(dyn_p=dyn_p_rhs, dyn_v=dyn_v_rhs,
                    jerk=full((N, K - 1, 2), limits.jerk_min),
                    acc=full((N, K, 2), limits.acc_min), vbox=l_v, pbox=l_p,
                    col=full((K, n_pairs), -np.inf))
    upper = RowVals(dyn_p=dyn_p_rhs, dyn_v=dyn_v_rhs,
                    jerk=full((N, K - 1, 2), limits.jerk_max),
                    acc=full((N, K, 2), limits.acc_max), vbox=u_v, pbox=u_p,
                    col=full((K, n_pairs), np.inf))
    return lower, upper


def collision_lower_bounds_state(eta, dist, prev_positions, pairs: PairIndex,
                                 *, min_distance) -> torch.Tensor:
    """RHS of the collision rows in state space: R + (eta . dprev - dist);
    row k = 0 is vacuous (-inf)."""
    dprev = pairwise_diffs(prev_positions, pairs)
    lin = torch.sum(eta * dprev, dim=-1) - dist
    l = min_distance + lin
    neg_inf = torch.full_like(l[..., 0:1, :], -np.inf)
    return torch.cat([neg_inf, l[..., 1:, :]], dim=-2)


# ---------------------------------------------------------------------------
# Row scaling / rho pattern
# ---------------------------------------------------------------------------

def row_scaling_state(n_steps: int, h: float, dtype=torch.float32,
                      device=None) -> RowVals:
    K = n_steps

    def d(v):
        return torch.as_tensor((1.0 / v)[:, None], dtype=dtype, device=device)

    dyn_p = np.full(K, np.sqrt(2.0 + h * h + 0.25 * h ** 4))
    dyn_p[0] = np.sqrt(1.0 + 0.25 * h ** 4)
    dyn_v = np.full(K, np.sqrt(2.0 + h * h))
    dyn_v[0] = np.sqrt(1.0 + h * h)
    jerk = np.full(K - 1, np.sqrt(2.0) / h)
    col = np.full(K, np.sqrt(2.0))
    one = np.ones(K)
    return RowVals(dyn_p=d(dyn_p), dyn_v=d(dyn_v), jerk=d(jerk), acc=d(one),
                   vbox=d(one), pbox=d(one), col=d(col))


def rho_pattern_masks(scaling: RowVals, static: SolverStatic, rho, col_boost,
                      *, n_steps: int, n_pairs: int, col_enabled: bool,
                      dtype=torch.float32) -> RowVals:
    """Per-row rho from the structural equality pattern: dynamics rows are
    equalities, vbox/pbox rows are equalities at k = K-1, jerk/acc never.
    Batch-independent; leaves are (K, 1) columns, (K, P) for collisions."""
    K = n_steps
    dev = scaling.acc.device
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)
    eq = static.rho_eq_scale * rho
    box_r = rho
    is_term = (torch.arange(K, device=dev) == K - 1).reshape(K, 1)
    vbox = torch.where(is_term, eq, box_r) * scaling.vbox * scaling.vbox
    pbox = torch.where(is_term, eq, box_r) * scaling.pbox * scaling.pbox
    loose = torch.tensor(_LOOSE_RHO, dtype=dtype, device=dev)
    if col_enabled:
        col = col_boost * box_r * scaling.col * scaling.col
        col = torch.where((torch.arange(K, device=dev) == 0).reshape(K, 1),
                          loose, col)
    else:
        col = loose.expand(K, 1)
    return RowVals(
        dyn_p=eq * scaling.dyn_p * scaling.dyn_p,
        dyn_v=eq * scaling.dyn_v * scaling.dyn_v,
        jerk=box_r * scaling.jerk * scaling.jerk,
        acc=box_r * scaling.acc * scaling.acc,
        vbox=vbox, pbox=pbox, col=col.expand(K, n_pairs))


# ---------------------------------------------------------------------------
# Block-tridiagonal normal matrix: per-channel (phase-1) path
# ---------------------------------------------------------------------------

def _per_k(leaf) -> torch.Tensor:
    """Per-k scalar rho from a (K', 1) leaf."""
    return leaf[:, 0]


def _tridiag_scalars(rho: RowVals, *, h: float, sigma) -> dict:
    """The per-k scalars of the (a, p, v)-slot 3x3 coupling pattern: every
    static row acts identically on all 2N (vehicle, axis) channels."""
    h2 = h * h
    rdp = _per_k(rho.dyn_p)
    rdv = _per_k(rho.dyn_v)
    rj = _per_k(rho.jerk)
    ra = _per_k(rho.acc)
    rv = _per_k(rho.vbox)
    rp = _per_k(rho.pbox)
    zero = torch.zeros(1, dtype=rdp.dtype, device=rdp.device)
    rdp_next = torch.cat([rdp[1:], zero])
    rdv_next = torch.cat([rdv[1:], zero])
    rj_prev = torch.cat([zero, rj])
    rj_here = torch.cat([rj, zero])
    return dict(
        aa=2.0 + sigma + rdp * (0.25 * h2 * h2) + rdv * h2 + ra
        + (rj_here + rj_prev) / h2,
        pp=sigma + rdp + rdp_next + rp,
        vv=sigma + rdv + rdv_next + rdp_next * h2 + rv,
        ap=-0.5 * h2 * rdp,
        av=-h * rdv,
        pv=h * rdp_next,
        # B_k entries (rows u_k, cols u_{k-1}), k = 1..K-1
        aa_b=-rj / h2,
        ap_pk=0.5 * h2 * rdp[1:],
        av_bk=0.5 * h2 * h * rdp[1:] + h * rdv[1:],
        pp_b=-rdp[1:],
        pv_b=-h * rdp[1:],
        vv_b=-rdv[1:],
    )


def b_slot_mats(s: dict) -> torch.Tensor:
    """The off-diagonal blocks B_k = C_k (x) I_2N as (K-1, 3, 3) slot
    scalars C_k (upper triangular)."""
    z = torch.zeros_like(s["aa_b"])
    return torch.stack([
        torch.stack([s["aa_b"], s["ap_pk"], s["av_bk"]], dim=-1),
        torch.stack([z, s["pp_b"], s["pv_b"]], dim=-1),
        torch.stack([z, z, s["vv_b"]], dim=-1),
    ], dim=-2)


def assemble_channel(rho: RowVals, *, h: float, sigma):
    """Collision-free normal blocks in per-channel form: D (K, 3, 3) and
    B (K-1, 3, 3), shared by every channel and every scenario."""
    s = _tridiag_scalars(rho, h=h, sigma=sigma)
    D = torch.stack([
        torch.stack([s["aa"], s["ap"], s["av"]], dim=-1),
        torch.stack([s["ap"], s["pp"], s["pv"]], dim=-1),
        torch.stack([s["av"], s["pv"], s["vv"]], dim=-1),
    ], dim=-2)
    return D, b_slot_mats(s)


def factorize(D, B):
    """Block Cholesky of the SPD block-tridiagonal [D_k; B_k], in inverted
    factor form (Linv (..., K, n, n), Eb (..., K-1, n, n)):

        L_0 L_0^T = D_0,  E_k = B_k L_{k-1}^{-T},  L_k L_k^T = D_k - E_k E_k^T

    D (..., K, n, n); B (K-1, n, n) shared, or with D's batch axes."""
    K, n = D.shape[-3], D.shape[-1]
    L = [torch.linalg.cholesky(D[..., 0, :, :])]
    Es = []
    for k in range(1, K):
        Ek = torch.linalg.solve_triangular(L[-1].mT, B[..., k - 1, :, :],
                                           upper=True, left=False)
        L.append(torch.linalg.cholesky(D[..., k, :, :] - Ek @ Ek.mT))
        Es.append(Ek)
    L = torch.stack(L, dim=-3)
    eye = torch.eye(n, dtype=D.dtype, device=D.device).expand(L.shape)
    # the solve returns column-major blocks; the kernels take row-major
    Linv = torch.linalg.solve_triangular(L, eye, upper=False).contiguous()
    return Linv, torch.stack(Es, dim=-3)


def _mv(M, t):
    """M t for stacked matrices (..., n, n) and vectors (..., n)."""
    return (M @ t[..., None])[..., 0]


def _mv_t(M, t):
    """M^T t for stacked matrices (..., n, n) and vectors (..., n)."""
    return (t[..., None, :] @ M)[..., 0, :]


def solve_factorized(Linv, Eb, b):
    """Solve M x = b from the dense inverted factors Linv (..., K, n, n) and
    Eb (..., K-1, n, n); b (..., K, n).

        y_k = Linv_k (b_k - E_k y_{k-1});  x_k = Linv_k^T (y_k - E_{k+1}^T x_{k+1})
    """
    K = Linv.shape[-3]
    y = [_mv(Linv[..., 0, :, :], b[..., 0, :])]
    for k in range(1, K):
        y.append(_mv(Linv[..., k, :, :],
                     b[..., k, :] - _mv(Eb[..., k - 1, :, :], y[-1])))
    x = [None] * K
    x[K - 1] = _mv_t(Linv[..., K - 1, :, :], y[K - 1])
    for k in range(K - 2, -1, -1):
        x[k] = _mv_t(Linv[..., k, :, :],
                     y[k] - _mv_t(Eb[..., k, :, :], x[k + 1]))
    return torch.stack(x, dim=-2)


def solve_factorized_channel(Linv, Eb, b):
    """Channel-shared banded solve.  Linv (K, 3, 3), Eb (K-1, 3, 3) shared
    factors; b (..., K, 3, C) with C channel columns.  Returns (..., K, 3, C).

        y_k = Linv_k (b_k - E_k y_{k-1});  x_k = Linv_k^T (y_k - E_{k+1}^T x_{k+1})
    """
    K = Linv.shape[0]

    def mv(M, t):
        return torch.einsum('ij,...jc->...ic', M, t)

    def mv_t(M, t):
        return torch.einsum('ji,...jc->...ic', M, t)

    y = [mv(Linv[0], b[..., 0, :, :])]
    for k in range(1, K):
        y.append(mv(Linv[k], b[..., k, :, :] - mv(Eb[k - 1], y[-1])))
    x = [None] * K
    x[K - 1] = mv_t(Linv[K - 1], y[K - 1])
    for k in range(K - 2, -1, -1):
        x[k] = mv_t(Linv[k], y[k] - mv_t(Eb[k], x[k + 1]))
    return torch.stack(x, dim=-3)


# ---------------------------------------------------------------------------
# StateVars <-> stacked (..., K, 6N) layout
# ---------------------------------------------------------------------------

def to_stacked(xv: StateVars) -> torch.Tensor:
    """(..., N, K, 2) leaves -> (..., K, 6N) with slot layout (a, p, v)."""
    def flat(arr):
        t = torch.swapaxes(arr, -3, -2)
        return t.reshape(t.shape[:-2] + (-1,))
    return torch.cat([flat(xv.a), flat(xv.p), flat(xv.v)], dim=-1)


def from_stacked(x: torch.Tensor, n_vehicles: int) -> StateVars:
    n2 = 2 * n_vehicles

    def unflat(sl):
        t = sl.reshape(sl.shape[:-1] + (n_vehicles, 2))
        return torch.swapaxes(t, -3, -2)
    return StateVars(a=unflat(x[..., :n2]), p=unflat(x[..., n2:2 * n2]),
                     v=unflat(x[..., 2 * n2:]))


# ---------------------------------------------------------------------------
# X-form (symmetric block-inverse) factorization
# ---------------------------------------------------------------------------

def _slot_diag(n6, n2, sr, sc, vals_k):
    """(K,) scalars -> (K, n6, n6) with vals on the (sr, sc) slot diagonal."""
    K = vals_k.shape[0]
    out = torch.zeros((K, n6, n6), dtype=vals_k.dtype, device=vals_k.device)
    idx = torch.arange(n2, device=vals_k.device)
    out[:, sr * n2 + idx, sc * n2 + idx] = vals_k[:, None]
    return out


def assemble_skeleton(rho: RowVals, *, h: float, sigma, n_vehicles: int):
    """Collision-free diagonal blocks D (K, 6N, 6N), shared by every
    scenario, and the slot scalars they came from."""
    n2, n6 = 2 * n_vehicles, 6 * n_vehicles
    s = _tridiag_scalars(rho, h=h, sigma=sigma)
    D = (_slot_diag(n6, n2, 0, 0, s["aa"]) + _slot_diag(n6, n2, 1, 1, s["pp"])
         + _slot_diag(n6, n2, 2, 2, s["vv"])
         + _slot_diag(n6, n2, 0, 1, s["ap"]) + _slot_diag(n6, n2, 1, 0, s["ap"])
         + _slot_diag(n6, n2, 0, 2, s["av"]) + _slot_diag(n6, n2, 2, 0, s["av"])
         + _slot_diag(n6, n2, 1, 2, s["pv"])
         + _slot_diag(n6, n2, 2, 1, s["pv"]))
    return D, s


def collision_blocks(rho_col, eta, E) -> torch.Tensor:
    """Collision contributions to the p-p slot of D: G_k diag(rho_k) G_k^T
    with G_k = E (x) eta_k.  eta (..., K, P, 2), rho_col broadcastable to
    (..., K, P).  Returns (..., K, 2N, 2N), shifted so entry k adds onto D_k
    (last entry zero)."""
    K, P = eta.shape[-3], eta.shape[-2]
    G = torch.einsum('np,...kpc->...kncp', E, eta)
    G = G.reshape(G.shape[:-3] + (-1, P))
    colM = (G * rho_col[..., None, :]) @ G.mT
    return torch.cat([colM[..., 1:, :, :], torch.zeros_like(colM[..., :1, :, :])],
                     dim=-3)


def assemble_D(rho: RowVals, eta, E, *, h: float, sigma, n_vehicles: int):
    """Diagonal blocks D (..., K, 6N, 6N) and slot-scalar off-diagonals
    C (K-1, 3, 3)."""
    n2 = 2 * n_vehicles
    D0, s = assemble_skeleton(rho, h=h, sigma=sigma, n_vehicles=n_vehicles)
    colM = collision_blocks(rho.col, eta, E)
    D = D0.expand(colM.shape[:-3] + D0.shape).clone()
    D[..., n2:2 * n2, n2:2 * n2] += colM
    return D, b_slot_mats(s)


def slot_dense(C, n2: int) -> torch.Tensor:
    """Slot scalars C (K-1, 3, 3) as the dense blocks C_k (x) I_n2,
    (K-1, 3 n2, 3 n2)."""
    eye = torch.eye(n2, dtype=C.dtype, device=C.device)
    return torch.einsum('kst,ij->ksitj', C, eye).reshape(-1, 3 * n2, 3 * n2)


def assemble_blocks(rho: RowVals, eta, E, *, h: float, sigma,
                    n_vehicles: int):
    """Diagonal blocks D (..., K, 6N, 6N) and the dense off-diagonal blocks
    B_k = C_k (x) I_2N as (K-1, 6N, 6N), shared by every scenario (the
    collision rows touch only D)."""
    D, C = assemble_D(rho, eta, E, h=h, sigma=sigma, n_vehicles=n_vehicles)
    return D, slot_dense(C, 2 * n_vehicles)


def slot_apply(C3, M):
    """(C (x) I) @ M for M (..., n, cols) and a shared (3, 3) C: rows of slot
    s are sum_t C[s, t] * (rows of slot t)."""
    n = M.shape[-2]
    M3 = M.reshape(M.shape[:-2] + (3, n // 3) + M.shape[-1:])
    return torch.einsum('st,...tcj->...scj', C3, M3).reshape(M.shape)


def slot_apply_vec(C3, w):
    """(C (x) I) w for a stacked vector w (..., n) and a shared (3, 3) C."""
    n = w.shape[-1]
    w3 = w.reshape(w.shape[:-1] + (3, n // 3))
    return torch.einsum('st,...tc->...sc', C3, w3).reshape(w.shape)


def bxbt(C3, X):
    """(C (x) I) X (C (x) I)^T for symmetric X via two slot recombinations."""
    return slot_apply(C3, torch.swapaxes(slot_apply(C3, X), -1, -2))


def _spd_inv(S):
    """Symmetric inverse of SPD S as Linv^T Linv (Cholesky, then a
    triangular solve)."""
    n = S.shape[-1]
    L = torch.linalg.cholesky(S)
    eye = torch.eye(n, dtype=S.dtype, device=S.device).expand(S.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.mT @ Linv


def _ns_step(Sk, Xprev, ns_iters: int):
    """``ns_iters`` Newton-Schulz steps X <- 2X - X (S X) from Xprev, then
    symmetrize."""
    X = Xprev
    for _ in range(ns_iters):
        X = 2.0 * X - X @ (Sk @ X)
    return 0.5 * (X + X.mT)


def ns_anchors(K: int, ns_anchor: int) -> list[int]:
    """Steps factorized exactly in the NS chain: k = 1, 2 and K-1 always,
    plus every ``ns_anchor``-th step if > 0 (k = 0 is exact too)."""
    return sorted({a for a in range(1, K - 1)
                   if ns_anchor > 0 and a % ns_anchor == 0}
                  | ({1, 2} & set(range(1, K))) | {K - 1})


def factorize_X(D, C, *, ns_iters: int = 0, ns_anchor: int = 0):
    """Block factorization storing the symmetric inverses X (..., K, n, n)
    of the Schur complements S_k = D_k - (C_k (x) I) X_{k-1} (C_k (x) I)^T.

    ``ns_iters = 0``: exact inverse at every step.  ``ns_iters > 0``:
    interior steps run that many Newton-Schulz iterations warm-started from
    X_{k-1}; the steps of :func:`ns_anchors` are exact."""
    K = D.shape[-3]
    X = torch.empty_like(D)
    X[..., 0, :, :] = _spd_inv(D[..., 0, :, :])
    exact = set(range(1, K)) if ns_iters <= 0 else set(ns_anchors(K, ns_anchor))
    for k in range(1, K):
        Sk = D[..., k, :, :] - bxbt(C[k - 1], X[..., k - 1, :, :])
        if k in exact:
            X[..., k, :, :] = _spd_inv(Sk)
        else:
            X[..., k, :, :] = _ns_step(Sk, X[..., k - 1, :, :], ns_iters)
    return X


def solve_factorized_X(X, C, b):
    """Solve M x = b from the X-form factors X (..., K, n, n) and the shared
    slot scalars C (K-1, 3, 3); b (..., K, n).

        w_k = X_k (b_k - B_k w_{k-1})
        x_{K-1} = w_{K-1};   x_k = w_k - X_k (B_{k+1}^T x_{k+1})
    """
    K = X.shape[-3]
    w = [_mv(X[..., 0, :, :], b[..., 0, :])]
    for k in range(1, K):
        w.append(_mv(X[..., k, :, :],
                     b[..., k, :] - slot_apply_vec(C[k - 1], w[-1])))
    x = [None] * K
    x[K - 1] = w[K - 1]
    for k in range(K - 2, -1, -1):
        x[k] = w[k] - _mv(X[..., k, :, :], slot_apply_vec(C[k].mT, x[k + 1]))
    return torch.stack(x, dim=-2)


# ---------------------------------------------------------------------------
# L-only factorization: the dense E_k are never stored
# ---------------------------------------------------------------------------

def factorize_L(D, C):
    """Block Cholesky of [D_k; B_k = C_k (x) I] keeping only the inverted
    diagonal factors Linv (..., K, n, n): half the bytes of the (Linv, Eb)
    form to store and to stream at every ADMM iteration."""
    return factorize(D, slot_dense(C, D.shape[-1] // 3))[0]


def solve_factorized_L(Linv, C, b):
    """Solve M x = b from the L-only factors Linv (..., K, n, n) and the
    shared slot scalars C (K-1, 3, 3); b (..., K, n).  The forward sweep
    keeps w_k = Linv_k^T y_k, so the E-apply is the slot recombination
    B_k w_{k-1}:

        y_k = Linv_k (b_k - B_k w_{k-1}),   w_k = Linv_k^T y_k
        x_{K-1} = w_{K-1};   x_k = w_k - Linv_k^T (Linv_k (B_{k+1}^T x_{k+1}))
    """
    K = Linv.shape[-3]
    L0 = Linv[..., 0, :, :]
    w = [_mv_t(L0, _mv(L0, b[..., 0, :]))]
    for k in range(1, K):
        Lk = Linv[..., k, :, :]
        w.append(_mv_t(Lk, _mv(Lk, b[..., k, :]
                               - slot_apply_vec(C[k - 1], w[-1]))))
    x = [None] * K
    x[K - 1] = w[K - 1]
    for k in range(K - 2, -1, -1):
        Lk = Linv[..., k, :, :]
        x[k] = w[k] - _mv_t(Lk, _mv(Lk, slot_apply_vec(C[k].mT, x[k + 1])))
    return torch.stack(x, dim=-2)


# ---------------------------------------------------------------------------
# ADMM loop with exact x-updates
# ---------------------------------------------------------------------------

class StateQPResult(NamedTuple):
    x: StateVars
    y: RowVals
    iters: torch.Tensor       # (B,) int32
    prim_res: torch.Tensor    # (B,)
    dual_res: torch.Tensor    # (B,)
    converged: torch.Tensor   # (B,) bool


def _factorize_X_routed(D, C, static: SolverStatic):
    """X-form factorization: the NS-chain kernel route where the JAX router
    takes its Pallas kernel (``banded.py:_factorize_X_routed``), else
    :func:`factorize_X`.  On the card that route takes float32 only and
    raises for any other dtype, and computes its products as
    ``static.ns_precision`` says; on the CPU it is :func:`factorize_X`."""
    K = D.shape[-3]
    if (static.kernels and static.ns_iters > 0 and static.ns_anchor == 0
            and K >= 6):
        from ..ops.ns_chain import factorize_X_chain_batched
        return factorize_X_chain_batched(D, C, ns_iters=static.ns_iters,
                                         ns_precision=static.ns_precision)
    return factorize_X(D, C, ns_iters=static.ns_iters,
                       ns_anchor=static.ns_anchor)


# The values of ``SolverConfig.assemble_precision`` (the JAX package's
# names); the port assembles at FP32 for each of them (:func:`qp_route`).
ASSEMBLE_PRECISIONS = ("highest", "high", "default")


def qp_route(static: SolverStatic, *, n_vehicles: int, n_steps: int,
             dtype, col_enabled: bool) -> str:
    """The x-update route the JAX router (``banded.py:1210-1259`` and
    ``1292-1339``) takes for these options:

    * "channel": the collision-free QP, shared per-channel factors;
    * "fused_X" / "fused_L": a kernel runs the whole check interval, on
      X-form factors (the fused option is on, the factors fit and the auto
      group is starved: N >= 22 in float32) or on dense (Linv, Eb) factors
      (fused, no group, N <= 29 at K = 50 in float32);
    * "grouped_X" / "grouped_L": a sweep kernel per ADMM iteration on the
      X-form or the L-only factors (a group size is set, or kernels with the
      auto group);
    * "resident": the dense (Linv, Eb) sweep kernel per iteration (kernels,
      ``group=-1``, N <= 20 at K = 50 in float32);
    * "dense": plain :func:`solve_factorized`, no kernel, in either form.

    The gates are the JAX router's as they stand: its 12 MiB and 96 MiB are
    byte budgets of the TPU's VMEM, kept so that the port routes where JAX
    routes.  Adaptive rho and bf16 factor storage raise NotImplementedError,
    naming their ROADMAP item.

    ``static.assemble_precision`` must be one of
    :data:`ASSEMBLE_PRECISIONS`, else ValueError.  Every one of them
    assembles the collision blocks in FP32 here (:func:`collision_blocks`,
    on the card as on the CPU): the JAX package's ``"default"`` and
    ``"high"`` name bf16-input passes of the TPU's matrix unit, and a
    reduced-precision product on this card would change the rounding of
    D, which moves lanes between SCP iteration counts as any change of FP32
    rounding does; so the port keeps one assembly and accepts the three
    names (ROADMAP Queue 3)."""
    if static.assemble_precision not in ASSEMBLE_PRECISIONS:
        raise ValueError(
            f"assemble_precision={static.assemble_precision!r}: one of "
            f"{ASSEMBLE_PRECISIONS} (each assembles in FP32 on this card)")
    if static.adaptive_rho:
        raise NotImplementedError(
            "adaptive rho is not ported yet (ROADMAP Queue 1 item 3)")
    if static.factor_dtype != "f32":
        raise NotImplementedError(
            "bf16 factor storage is not ported (ROADMAP Queue 1 item 5)")
    if not col_enabled:
        return "channel"
    N, K = n_vehicles, n_steps
    isz = torch.empty((), dtype=dtype).element_size()
    np_ = -(-6 * N // 128) * 128
    per_g = 4 * np_ * np_ * isz + 5 * K * np_ * isz
    auto_g = max(1, min(32, (12 * 1024 * 1024) // per_g))
    if static.group > 0:
        group_n = static.group
    elif static.group == 0 and static.kernels:
        group_n = auto_g
    else:
        group_n = 0
    factor_bytes = 2 * K * (6 * N) ** 2 * isz
    form = static.factor_form
    if form == "X":
        nr8 = -(-6 * N // 8) * 8
        fused_ok = K * nr8 * np_ * isz <= 96 * 1024 * 1024
        use_fused = static.fused and fused_ok and (group_n == 0
                                                   or group_n < 16)
    else:
        use_fused = (static.fused and group_n == 0
                     and factor_bytes <= 12 * 1024 * 1024)
    if use_fused:
        return "fused_X" if form == "X" else "fused_L"
    if group_n:
        return "grouped_X" if form == "X" else "grouped_L"
    if static.kernels and 2 * factor_bytes <= 12 * 1024 * 1024:
        return "resident"
    return "dense"


def _interval_fn(route: str, rho_b: RowVals, lower: RowVals, upper: RowVals,
                 eta, E, static: SolverStatic, n_vehicles: int, step: dict):
    """The function (x, z, y) -> (x, z, y) that runs one check interval on
    ``route``, its factors computed here once."""
    N, h, sigma = n_vehicles, step["h"], step["sigma"]

    def per_iteration(solve):
        return lambda x, z, y: admm_iterations(x, z, y, solve, eta, E, lower,
                                               upper, rho_b, **step)

    if route == "channel":
        L, Eb = factorize(*assemble_channel(rho_b, h=h, sigma=sigma))
        return per_iteration(lambda sb: solve_factorized_channel(
            L, Eb, sb.reshape(sb.shape[:-1] + (3, 2 * N))).reshape(sb.shape))
    if route in ("fused_X", "grouped_X", "grouped_L"):
        D, C = assemble_D(rho_b, eta, E, h=h, sigma=sigma, n_vehicles=N)
        if route == "grouped_L":
            from ..ops.group_solve import solve_factorized_grouped_L
            Linv = factorize_L(D, C)
            return per_iteration(
                lambda sb: solve_factorized_grouped_L(Linv, C, sb))
        Xf = _factorize_X_routed(D, C, static)
        del D
        if route == "fused_X":
            from ..ops.admm_fused import admm_interval_fused_X
            return lambda x, z, y: admm_interval_fused_X(
                Xf, C, eta, E, lower, upper, x, z, y, rho_b, **step)
        from ..ops.group_solve import solve_factorized_grouped_X
        return per_iteration(lambda sb: solve_factorized_grouped_X(Xf, C, sb))
    Linv, Eb = factorize(*assemble_blocks(rho_b, eta, E, h=h, sigma=sigma,
                                          n_vehicles=N))
    if route == "fused_L":
        from ..ops.admm_fused import admm_interval_fused
        return lambda x, z, y: admm_interval_fused(
            Linv, Eb, eta, E, lower, upper, x, z, y, rho_b, **step)
    if route == "resident":
        from ..ops.banded_solve import solve_factorized_dense
        return per_iteration(lambda sb: solve_factorized_dense(Linv, Eb, sb))
    return per_iteration(lambda sb: solve_factorized(Linv, Eb, sb))


def solve_qp_state(lower: RowVals, upper: RowVals, eta, x_init: StateVars,
                   params: SolverParams, E, *, h: float,
                   static: SolverStatic, n_vehicles: int,
                   y_init: RowVals | None = None,
                   col_enabled: bool = True) -> StateQPResult:
    """One ADMM solve in state space for a batch of scenarios.

    Every argument carries the scenario axis first: bounds and duals as
    (B, ...) RowVals, eta (B, K, P, 2), x_init (B, N, K, 2) StateVars.
    Collision rows are controlled through ``lower.col`` (-inf rows are
    disabled).  ``col_enabled=False`` marks the collision-free initial QP,
    whose x-updates run on the shared per-channel (K, 3, 3) factorization.

    The loop runs intervals of ``check_interval`` iterations, with the
    residuals checked after each, while ``iters < max_iter`` and the lane
    has not converged.  A lane that has stopped keeps its x, y, iteration
    count, residuals and ``converged`` flag while the others go on, as each
    lane of the vmapped JAX loop does; the host reads one flag per interval
    (does any lane go on?), and none when the budget is one interval.

    The fused routes keep the batch-independent rho of
    :func:`rho_pattern_masks` on every collision row, as the JAX router
    does; the other routes give rows disabled by a -inf lower bound the
    loose rho.
    """
    dtype = x_init.a.dtype
    N = n_vehicles
    K = x_init.a.shape[-2]
    P = lower.col.shape[-1]
    nb = x_init.a.dim() - 3
    route = qp_route(static, n_vehicles=N, n_steps=K, dtype=dtype,
                     col_enabled=col_enabled)
    check, max_iter = int(params.check_interval), int(params.max_iter)
    scaling = row_scaling_state(K, h, dtype=dtype, device=x_init.a.device)

    Ax0 = apply_A(x_init, eta, E, h)
    z = tree_map(torch.clamp, Ax0, lower, upper)
    y = tree_map(torch.zeros_like, z) if y_init is None else y_init
    x = x_init

    rho_b = rho_pattern_masks(scaling, static, params.rho,
                              params.col_rho_boost, n_steps=K, n_pairs=P,
                              col_enabled=col_enabled, dtype=dtype)
    if route not in ("channel", "fused_X", "fused_L"):
        # rows disabled by a -inf bound take the loose rho
        rho_b = rho_b._replace(col=torch.where(
            torch.isinf(lower.col), torch.full_like(lower.col, _LOOSE_RHO),
            rho_b.col))
    interval = _interval_fn(route, rho_b, lower, upper, eta, E, static, N,
                            dict(h=h, sigma=params.sigma, alpha=params.alpha,
                                 lam=params.col_penalty, n_iters=check))

    x, z, y = interval(x, z, y)
    prim, dual, done = _residuals(x, z, y, eta, E, h, scaling, params, nb)
    iters = torch.full(prim.shape, check, dtype=torch.int32,
                       device=prim.device)
    active = ~done
    for _ in range(check, max_iter, check):
        if not bool(active.any()):
            break
        new = interval(x, z, y)
        res = _residuals(*new, eta, E, h, scaling, params, nb)

        def keep(n_, o_):
            return torch.where(lane_mask(active, n_), n_, o_)
        x, z, y = (tree_map(keep, n_, o_) for n_, o_ in zip(new, (x, z, y)))
        prim, dual, done = (keep(n_, o_) for n_, o_ in zip(res, (prim, dual,
                                                                 done)))
        iters = iters + check * active.to(torch.int32)
        active = active & ~done
    return StateQPResult(x=x, y=y, iters=iters, prim_res=prim, dual_res=dual,
                         converged=done)


def admm_iterations(x: StateVars, z: RowVals, y: RowVals, solve, eta, E,
                    lower: RowVals, upper: RowVals, rho: RowVals, *, h: float,
                    sigma, alpha, lam, n_iters: int):
    """``n_iters`` ADMM iterations from (x, z, y): the loop body of the JAX
    ``solve_qp_state`` (``admm_iter``).  ``solve`` maps a stacked right-hand
    side (..., K, 6N) to the solution of the normal equations.  Returns the
    new (x, z, y)."""
    N = x.a.shape[-3]
    for _ in range(n_iters):
        rzy = tree_map(lambda zz, yy, rr: rr * zz - yy, z, y, rho)
        b_sv = apply_AT(rzy, eta, E, h)
        b_sv = tree_map(lambda bb, xx: bb + sigma * xx, b_sv, x)
        x_t = from_stacked(solve(to_stacked(b_sv)), N)
        x = tree_map(lambda xt, xx: alpha * xt + (1 - alpha) * xx, x_t, x)
        Ax_t = apply_A(x_t, eta, E, h)
        z_rel = tree_map(lambda az, zz: alpha * az + (1 - alpha) * zz, Ax_t, z)
        z_new = tree_map(lambda zr, yy, rr, lo, up: torch.clamp(zr + yy / rr,
                                                             lo, up),
                         z_rel, y, rho, lower, upper)
        # exact-penalty soft prox on the collision rows
        w_col = z_rel.col + y.col / rho.col
        z_col = torch.where(w_col >= lower.col, w_col,
                            torch.minimum(w_col + lam / rho.col, lower.col))
        z = z_new._replace(col=z_col)
        y = tree_map(lambda yy, zr, zn, rr: yy + rr * (zr - zn), y, z_rel, z,
                     rho)
    return x, z, y


def _residuals(x, z, y, eta, E, h, scaling, params, nb):
    """OSQP primal/dual residuals and the termination test, per scenario."""
    Ax = apply_A(x, eta, E, h)
    dAx = tree_map(lambda a, d_: a * d_, Ax, scaling)
    dz = tree_map(lambda a, d_: a * d_, z, scaling)
    prim = _inf_norm(tree_map(lambda a, b_: a - b_, dAx, dz), nb)
    ATy = apply_AT(y, eta, E, h)
    dual = _inf_norm(StateVars(a=2.0 * x.a + ATy.a, p=ATy.p, v=ATy.v), nb)
    prim_scale = torch.maximum(_inf_norm(dAx, nb), _inf_norm(dz, nb))
    dual_scale = torch.maximum(2.0 * x.a.abs().flatten(nb).amax(-1),
                               _inf_norm(ATy, nb))
    eps_prim = params.eps_abs + params.eps_rel * prim_scale
    eps_dual = params.eps_abs + params.eps_rel * dual_scale
    done = (prim <= eps_prim) & (dual <= eps_dual)
    return prim, dual, done
