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

from ..ops.blocked_chol import chol_inv, exact_fp32
from ..ops.collisions import PairIndex, pairwise_diffs
from ..utils.config import SolverParams, SolverStatic
from ..utils.dist import all_reduce
from ..utils.graphs import graphed
from ..utils.profiling import host_read, host_write, span

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
    """A per-lane mask or scalar (B,), shaped to broadcast against ``t``
    (B, ...)."""
    return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))


def _inf_norm(t, batch_dims: int = 0, group=None) -> torch.Tensor:
    """Max |entry| over every leaf, per index of the ``batch_dims`` leading
    axes (a scalar when ``batch_dims`` is 0); over the ranks of ``group``
    too where the collision rows are sharded (JAX's ``pmax``)."""
    maxes = [v.abs().flatten(batch_dims).amax(-1) for v in t if v.numel() > 0]
    return all_reduce(torch.stack(maxes).amax(0), "max", group)


# ---------------------------------------------------------------------------
# Constraint operator (all local in time)
# ---------------------------------------------------------------------------

def apply_A_static(xv: StateVars, h: float) -> RowVals:
    """A's static rows (dynamics, jerk, boxes) of ``xv``; ``col`` None."""
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
    return RowVals(dyn_p=dyn_p, dyn_v=dyn_v, jerk=jerk, acc=a, vbox=v,
                   pbox=p, col=None)


def apply_A(xv: StateVars, eta, E, h: float) -> RowVals:
    # collision rows: k = 0 vacuous, k >= 1 uses p[k] (index k-1)
    dp = torch.einsum('np,...nkc->...kpc', E, xv.p)
    col_k = torch.sum(eta[..., 1:, :, :] * dp[..., :-1, :, :], dim=-1)
    col = torch.cat([torch.zeros_like(col_k[..., 0:1, :]), col_k], dim=-2)
    return apply_A_static(xv, h)._replace(col=col)


def apply_AT_static(y: RowVals, h: float) -> StateVars:
    """A^T y over the static rows of ``y`` (``y.col`` is not read)."""
    yj = F.pad(y.jerk, (0, 0, 1, 1))
    a = (-0.5 * h * h * y.dyn_p - h * y.dyn_v
         + (yj[..., :-1, :] - yj[..., 1:, :]) / h + y.acc)

    dyn_p_next = torch.cat(
        [y.dyn_p[..., 1:, :], torch.zeros_like(y.dyn_p[..., 0:1, :])], dim=-2)
    p = y.dyn_p - dyn_p_next + y.pbox

    dyn_v_next = torch.cat(
        [y.dyn_v[..., 1:, :], torch.zeros_like(y.dyn_v[..., 0:1, :])], dim=-2)
    v = -h * dyn_p_next + y.dyn_v - dyn_v_next + y.vbox
    return StateVars(a=a, p=p, v=v)


def apply_AT(y: RowVals, eta, E, h: float, group=None) -> StateVars:
    """A^T y.  ``group``: the collision rows are this rank's share of the
    pairs, and their contribution to p is summed over the group (JAX's
    ``psum``)."""
    st = apply_AT_static(y, h)
    w = y.col[..., None] * eta
    w_shift = torch.cat(
        [w[..., 1:, :, :], torch.zeros_like(w[..., 0:1, :, :])], dim=-3)
    return st._replace(p=st.p + all_reduce(
        torch.einsum('np,...kpc->...nkc', E, w_shift), "sum", group))


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
    pos_min = host_write("scp", limits.pos_min, dtype=dt, device=dev)
    pos_max = host_write("scp", limits.pos_max, dtype=dt, device=dev)
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
    row k = 0 is vacuous (-inf), and so are the rows of pad pairs
    (``pairs.valid``)."""
    dprev = pairwise_diffs(prev_positions, pairs)
    lin = torch.sum(eta * dprev, dim=-1) - dist
    l = min_distance + lin
    if pairs.valid is not None:
        l = torch.where(pairs.valid, l, torch.full_like(l, -np.inf))
    neg_inf = torch.full_like(l[..., 0:1, :], -np.inf)
    return torch.cat([neg_inf, l[..., 1:, :]], dim=-2)


# ---------------------------------------------------------------------------
# Row scaling / rho pattern
# ---------------------------------------------------------------------------

def row_scaling_state(n_steps: int, h: float, dtype=torch.float32,
                      device=None) -> RowVals:
    K = n_steps

    def d(v):
        return host_write("qp", (1.0 / v)[:, None], dtype=dtype,
                          device=device)

    dyn_p = np.full(K, np.sqrt(2.0 + h * h + 0.25 * h ** 4))
    dyn_p[0] = np.sqrt(1.0 + 0.25 * h ** 4)
    dyn_v = np.full(K, np.sqrt(2.0 + h * h))
    dyn_v[0] = np.sqrt(1.0 + h * h)
    jerk = np.full(K - 1, np.sqrt(2.0) / h)
    col = np.full(K, np.sqrt(2.0))
    one = np.ones(K)
    return RowVals(dyn_p=d(dyn_p), dyn_v=d(dyn_v), jerk=d(jerk), acc=d(one),
                   vbox=d(one), pbox=d(one), col=d(col))


def rho_pattern(lower: RowVals, upper: RowVals, scaling: RowVals,
                static: SolverStatic, rho, col_boost, col_shape) -> RowVals:
    """Per-row rho from the bounds (the JAX package's ``rho_pattern``):
    rho / norm^2, boosted by ``rho_eq_scale`` on rows whose bounds are
    equal; the collision rows get ``col_boost``, their vacuous k = 0 row
    the loose rho.  :func:`rho_pattern_masks` gives the same from the
    structural equality pattern, which the solver uses."""
    def box(lo, up, d):
        base = rho * d * d
        return torch.where(lo == up, static.rho_eq_scale * base, base)

    eq = static.rho_eq_scale * rho
    K = col_shape[-2]
    col = col_boost * rho * scaling.col * scaling.col
    col = torch.where((torch.arange(K, device=col.device) == 0).reshape(K, 1),
                      _LOOSE_RHO, col)
    return RowVals(
        dyn_p=eq * scaling.dyn_p * scaling.dyn_p * torch.ones_like(lower.dyn_p),
        dyn_v=eq * scaling.dyn_v * scaling.dyn_v * torch.ones_like(lower.dyn_v),
        jerk=box(lower.jerk, upper.jerk, scaling.jerk),
        acc=box(lower.acc, upper.acc, scaling.acc),
        vbox=box(lower.vbox, upper.vbox, scaling.vbox),
        pbox=box(lower.pbox, upper.pbox, scaling.pbox),
        col=col.expand(col_shape))


def rho_pattern_masks(scaling: RowVals, static: SolverStatic, rho, col_boost,
                      *, n_steps: int, n_pairs: int, col_enabled: bool,
                      dtype=torch.float32) -> RowVals:
    """Per-row rho from the structural equality pattern: dynamics rows are
    equalities, vbox/pbox rows are equalities at k = K-1, jerk/acc never.
    A scalar ``rho`` gives batch-shared leaves, (K, 1) columns and (K, P)
    for collisions; a per-lane rho (B,) (adaptive rho) gives (B, 1, K, 1),
    which broadcast against the (B, N, K, 2) rows, and (B, K, P)."""
    K = n_steps
    dev = scaling.acc.device
    rho = torch.as_tensor(rho, dtype=dtype, device=dev)
    batch = tuple(rho.shape)
    if batch:
        rho_col = rho.reshape(batch + (1, 1))
        rho = rho.reshape(batch + (1, 1, 1))
    else:
        rho_col = rho
    eq = static.rho_eq_scale * rho
    box_r = rho
    is_term = (torch.arange(K, device=dev) == K - 1).reshape(K, 1)
    vbox = torch.where(is_term, eq, box_r) * scaling.vbox * scaling.vbox
    pbox = torch.where(is_term, eq, box_r) * scaling.pbox * scaling.pbox
    loose = host_write("qp", _LOOSE_RHO, dtype=dtype, device=dev)
    if col_enabled:
        col = col_boost * rho_col * scaling.col * scaling.col
        col = torch.where((torch.arange(K, device=dev) == 0).reshape(K, 1),
                          loose, col)
    else:
        col = loose.expand(batch + (K, 1))
    return RowVals(
        dyn_p=eq * scaling.dyn_p * scaling.dyn_p,
        dyn_v=eq * scaling.dyn_v * scaling.dyn_v,
        jerk=box_r * scaling.jerk * scaling.jerk,
        acc=box_r * scaling.acc * scaling.acc,
        vbox=vbox, pbox=pbox, col=col.expand(batch + (K, n_pairs)))


# ---------------------------------------------------------------------------
# Block-tridiagonal normal matrix: per-channel (phase-1) path
# ---------------------------------------------------------------------------

def _per_k(leaf) -> torch.Tensor:
    """Per-k scalar rho from a (K', 1) leaf, or (B, K') from a per-lane
    (B, 1, K', 1) one."""
    return leaf[..., 0] if leaf.dim() == 2 else leaf[:, 0, :, 0]


def _tridiag_scalars(rho: RowVals, *, h: float, sigma) -> dict:
    """The per-k scalars of the (a, p, v)-slot 3x3 coupling pattern: every
    static row acts identically on all 2N (vehicle, axis) channels.  Each
    is (..., K) or (..., K-1), with the batch axes of the rho leaves."""
    h2 = h * h
    rdp = _per_k(rho.dyn_p)
    rdv = _per_k(rho.dyn_v)
    rj = _per_k(rho.jerk)
    ra = _per_k(rho.acc)
    rv = _per_k(rho.vbox)
    rp = _per_k(rho.pbox)
    zero = torch.zeros(rdp.shape[:-1] + (1,), dtype=rdp.dtype,
                       device=rdp.device)
    rdp_next = torch.cat([rdp[..., 1:], zero], dim=-1)
    rdv_next = torch.cat([rdv[..., 1:], zero], dim=-1)
    rj_prev = torch.cat([zero, rj], dim=-1)
    rj_here = torch.cat([rj, zero], dim=-1)
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
        ap_pk=0.5 * h2 * rdp[..., 1:],
        av_bk=0.5 * h2 * h * rdp[..., 1:] + h * rdv[..., 1:],
        pp_b=-rdp[..., 1:],
        pv_b=-h * rdp[..., 1:],
        vv_b=-rdv[..., 1:],
    )


def unit_slot_scalars(static: SolverStatic, *, n_steps: int, h: float,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """The slot scalars C (K-1, 3, 3) of rho = 1.  C is linear in rho (the
    off-diagonal blocks come from A^T rho A alone), so those of any rho are
    rho times these."""
    scaling = row_scaling_state(n_steps, h, dtype=dtype, device=device)
    rho = rho_pattern_masks(scaling, static, 1.0, 1.0, n_steps=n_steps,
                            n_pairs=1, col_enabled=False, dtype=dtype)
    return b_slot_mats(_tridiag_scalars(rho, h=h, sigma=0.0))


def b_slot_mats(s: dict) -> torch.Tensor:
    """The off-diagonal blocks B_k = C_k (x) I_2N as (..., K-1, 3, 3) slot
    scalars C_k (upper triangular)."""
    z = torch.zeros_like(s["aa_b"])
    return torch.stack([
        torch.stack([s["aa_b"], s["ap_pk"], s["av_bk"]], dim=-1),
        torch.stack([z, s["pp_b"], s["pv_b"]], dim=-1),
        torch.stack([z, z, s["vv_b"]], dim=-1),
    ], dim=-2)


def b_scalar_stack(s: dict) -> torch.Tensor:
    """The six B_k slot scalars as (..., K-1, 6) in the fixed order
    (aa_b, ap_pk, av_bk, pp_b, pv_b, vv_b)."""
    return torch.stack([s["aa_b"], s["ap_pk"], s["av_bk"], s["pp_b"],
                        s["pv_b"], s["vv_b"]], dim=-1)


def assemble_channel(rho: RowVals, *, h: float, sigma):
    """Collision-free normal blocks in per-channel form: D (K, 3, 3) and
    B (K-1, 3, 3), shared by every channel and, for a batch-shared rho,
    every scenario (else with the batch axes of the rho leaves)."""
    s = _tridiag_scalars(rho, h=h, sigma=sigma)
    D = torch.stack([
        torch.stack([s["aa"], s["ap"], s["av"]], dim=-1),
        torch.stack([s["ap"], s["pp"], s["pv"]], dim=-1),
        torch.stack([s["av"], s["pv"], s["vv"]], dim=-1),
    ], dim=-2)
    return D, b_slot_mats(s)


def _cholesky(S):
    """Cholesky factor of SPD S (..., n, n), NaN-filled where a matrix is
    not positive definite, as JAX's ``lax.linalg.cholesky`` returns it: a
    lane that fails (a NaN input) poisons itself and not its batch, where
    ``torch.linalg.cholesky`` would raise for the whole batch."""
    L, info = torch.linalg.cholesky_ex(S)
    return L.masked_fill((info != 0)[..., None, None], float("nan"))


def factorize(D, B):
    """Block Cholesky of the SPD block-tridiagonal [D_k; B_k], in inverted
    factor form (Linv (..., K, n, n), Eb (..., K-1, n, n)):

        L_0 L_0^T = D_0,  E_k = B_k L_{k-1}^{-T},  L_k L_k^T = D_k - E_k E_k^T

    D (..., K, n, n); B (K-1, n, n) shared, or with D's batch axes.  The
    Cholesky factors and triangular solves are the library's (cuSOLVER on
    the card); :func:`factorize_matmul` is the matmul form."""
    K, n = D.shape[-3], D.shape[-1]
    L = [_cholesky(D[..., 0, :, :])]
    Es = []
    for k in range(1, K):
        Ek = torch.linalg.solve_triangular(L[-1].mT, B[..., k - 1, :, :],
                                           upper=True, left=False)
        L.append(_cholesky(D[..., k, :, :] - Ek @ Ek.mT))
        Es.append(Ek)
    L = torch.stack(L, dim=-3)
    eye = torch.eye(n, dtype=D.dtype, device=D.device).expand(L.shape)
    # the solve returns column-major blocks; the kernels take row-major
    Linv = torch.linalg.solve_triangular(L, eye, upper=False).contiguous()
    return Linv, torch.stack(Es, dim=-3)


# the JAX package's name of this factorization (its XLA-primitive form)
factorize_xla = factorize


def factorize_matmul(D, B):
    """The factorization of :func:`factorize` in pure matmul form (the JAX
    package's ``factorize_matmul``): carrying the inverted factor through
    the steps turns each into matmuls and one matmul-form Cholesky,

        E_k = B_k Linv_{k-1}^T,   S_k = D_k - E_k E_k^T,
        Linv_k = chol_inv(S_k)[1]   (``ops/blocked_chol.py``),

    every product in exact FP32.  No route of the solver takes it: the
    port's factorizations stay on cuSOLVER (ROADMAP, Decided)."""
    with exact_fp32():
        Linv = [chol_inv(D[..., 0, :, :])[1]]
        Es = []
        for k in range(1, D.shape[-3]):
            Ek = B[..., k - 1, :, :] @ Linv[-1].mT
            Linv.append(chol_inv(D[..., k, :, :] - Ek @ Ek.mT)[1])
            Es.append(Ek)
    return torch.stack(Linv, dim=-3), torch.stack(Es, dim=-3)


def _mv(M, t):
    """M t for stacked matrices (..., n, n) and vectors (..., n).  Stored
    bf16 factors are widened to t's dtype first, as JAX promotes bf16 x
    f32 (or f64)."""
    return (M.to(t.dtype) @ t[..., None])[..., 0]


def _mv_t(M, t):
    """M^T t for stacked matrices (..., n, n) and vectors (..., n), M
    widened as in :func:`_mv`."""
    return (t[..., None, :] @ M.to(t.dtype))[..., 0, :]


def compress_factors(*factors, dtype=torch.bfloat16):
    """Store factor blocks (..., n, n) at reduced precision (JAX
    ``banded.compress_factors``, ``SolverConfig.factor_dtype="bf16"``): the
    sweeps stream the factors at every ADMM iteration, and the ADMM
    tolerances and the collision margin absorb the rounding.  Each result
    is a (..., n, n) view of a zero-filled (..., n, ld) tensor, ld the
    stride :func:`ops.cuda_build.bf16_row_stride` (n rounded up to 8
    elements, 16 bytes), which the sweep kernels' bulk copies need; the
    counterpart of JAX's ``pad_factors``, whose 128 lanes were the TPU DMA
    engine's rule.  Written once a factorization."""
    from ..ops.cuda_build import bf16_row_stride
    out = []
    for F_ in factors:
        n = F_.shape[-1]
        store = torch.zeros(F_.shape[:-1] + (bf16_row_stride(n),),
                            dtype=dtype, device=F_.device)
        view = store[..., :n]
        view.copy_(F_)
        out.append(view)
    return tuple(out)


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
    factors, or (B, K, 3, 3) and (B, K-1, 3, 3) per lane; b (..., K, 3, C)
    with C channel columns.  Returns (..., K, 3, C).

        y_k = Linv_k (b_k - E_k y_{k-1});  x_k = Linv_k^T (y_k - E_{k+1}^T x_{k+1})
    """
    K = Linv.shape[-3]
    m = 'ij' if Linv.dim() == 3 else '...ij'
    mt = 'ji' if Linv.dim() == 3 else '...ji'

    def mv(M, t):
        return torch.einsum(f'{m},...jc->...ic', M, t)

    def mv_t(M, t):
        return torch.einsum(f'{mt},...jc->...ic', M, t)

    y = [mv(Linv[..., 0, :, :], b[..., 0, :, :])]
    for k in range(1, K):
        y.append(mv(Linv[..., k, :, :],
                    b[..., k, :, :] - mv(Eb[..., k - 1, :, :], y[-1])))
    x = [None] * K
    x[K - 1] = mv_t(Linv[..., K - 1, :, :], y[K - 1])
    for k in range(K - 2, -1, -1):
        x[k] = mv_t(Linv[..., k, :, :],
                    y[k] - mv_t(Eb[..., k, :, :], x[k + 1]))
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
    """(..., K) scalars -> (..., K, n6, n6) with vals on the (sr, sc) slot
    diagonal."""
    out = torch.zeros(vals_k.shape + (n6, n6), dtype=vals_k.dtype,
                      device=vals_k.device)
    idx = torch.arange(n2, device=vals_k.device)
    out[..., sr * n2 + idx, sc * n2 + idx] = vals_k[..., None]
    return out


def assemble_skeleton(rho: RowVals, *, h: float, sigma, n_vehicles: int):
    """Collision-free diagonal blocks D (K, 6N, 6N), shared by every
    scenario for a batch-shared rho (else with the batch axes of the rho
    leaves), and the slot scalars they came from."""
    n2, n6 = 2 * n_vehicles, 6 * n_vehicles
    s = _tridiag_scalars(rho, h=h, sigma=sigma)
    D = (_slot_diag(n6, n2, 0, 0, s["aa"]) + _slot_diag(n6, n2, 1, 1, s["pp"])
         + _slot_diag(n6, n2, 2, 2, s["vv"])
         + _slot_diag(n6, n2, 0, 1, s["ap"]) + _slot_diag(n6, n2, 1, 0, s["ap"])
         + _slot_diag(n6, n2, 0, 2, s["av"]) + _slot_diag(n6, n2, 2, 0, s["av"])
         + _slot_diag(n6, n2, 1, 2, s["pv"])
         + _slot_diag(n6, n2, 2, 1, s["pv"]))
    return D, s


def collision_blocks(rho_col, eta, E, group=None) -> torch.Tensor:
    """Collision contributions to the p-p slot of D: G_k diag(rho_k) G_k^T
    with G_k = E (x) eta_k.  eta (..., K, P, 2), rho_col broadcastable to
    (..., K, P).  Returns (..., K, 2N, 2N), shifted so entry k adds onto D_k
    (last entry zero).  ``group``: the pairs are this rank's share, and the
    partial blocks are summed over the group (JAX's ``psum``)."""
    K, P = eta.shape[-3], eta.shape[-2]
    G = torch.einsum('np,...kpc->...kncp', E, eta)
    G = G.reshape(G.shape[:-3] + (-1, P))
    colM = all_reduce((G * rho_col[..., None, :]) @ G.mT, "sum", group)
    return torch.cat([colM[..., 1:, :, :], torch.zeros_like(colM[..., :1, :, :])],
                     dim=-3)


def assemble_D(rho: RowVals, eta, E, *, h: float, sigma, n_vehicles: int,
               group=None):
    """Diagonal blocks D (..., K, 6N, 6N) and slot-scalar off-diagonals
    C (K-1, 3, 3), or (B, K-1, 3, 3) for a per-lane rho; ``group`` as in
    :func:`collision_blocks`.  The plain version of
    ``ops.assemble_d.assemble_D_fused``, which the solver calls."""
    n2 = 2 * n_vehicles
    D0, s = assemble_skeleton(rho, h=h, sigma=sigma, n_vehicles=n_vehicles)
    colM = collision_blocks(rho.col, eta, E, group)
    D = D0.expand(colM.shape[:-3] + D0.shape[-3:]).clone()
    D[..., n2:2 * n2, n2:2 * n2] += colM
    return D, b_slot_mats(s)


def slot_dense(C, n2: int) -> torch.Tensor:
    """Slot scalars C (..., K-1, 3, 3) as the dense blocks C_k (x) I_n2,
    (..., K-1, 3 n2, 3 n2)."""
    eye = torch.eye(n2, dtype=C.dtype, device=C.device)
    return torch.einsum('...kst,ij->...ksitj', C, eye).reshape(
        C.shape[:-2] + (3 * n2, 3 * n2))


def assemble_blocks(rho: RowVals, eta, E, *, h: float, sigma,
                    n_vehicles: int, group=None):
    """Diagonal blocks D (..., K, 6N, 6N) and the dense off-diagonal blocks
    B_k = C_k (x) I_2N as (K-1, 6N, 6N), shared by every scenario for a
    batch-shared rho (the collision rows touch only D); ``group`` as in
    :func:`collision_blocks`.  D comes from ``ops.assemble_d`` (one kernel
    on the card, :func:`assemble_D` on the CPU and for a ``group``)."""
    from ..ops.assemble_d import assemble_D_fused
    D, C = assemble_D_fused(rho, eta, E, h=h, sigma=sigma,
                            n_vehicles=n_vehicles, group=group)
    return D, slot_dense(C, 2 * n_vehicles)


def slot_apply(C3, M):
    """(C (x) I) @ M for M (..., n, cols) and a shared (3, 3) C: rows of slot
    s are sum_t C[s, t] * (rows of slot t)."""
    n = M.shape[-2]
    M3 = M.reshape(M.shape[:-2] + (3, n // 3) + M.shape[-1:])
    return torch.einsum('st,...tcj->...scj', C3, M3).reshape(M.shape)


def slot_apply_vec(C3, w):
    """(C (x) I) w for a stacked vector w (..., n) and a shared (3, 3) C, or
    one C a lane (B, 3, 3) for w (B, n)."""
    n = w.shape[-1]
    w3 = w.reshape(w.shape[:-1] + (3, n // 3))
    m = 'st' if C3.dim() == 2 else '...st'
    return torch.einsum(f'{m},...tc->...sc', C3, w3).reshape(w.shape)


def bxbt(C3, X):
    """(C (x) I) X (C (x) I)^T for symmetric X via two slot recombinations."""
    return slot_apply(C3, torch.swapaxes(slot_apply(C3, X), -1, -2))


def _spd_inv(S):
    """Symmetric inverse of SPD S as Linv^T Linv (Cholesky, then a
    triangular solve)."""
    n = S.shape[-1]
    L = _cholesky(S)
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


# The NS-chain kernel's precision (``ops/ns_chain.py:PRECISIONS``) that
# serves each ``ns_precision`` of the solver (the JAX package's names).
# "default" runs the three-pass kernel, and off the kernel every name takes
# FP32 products: with a single TF32 pass the production path missed its 99%
# bar at N=40 on either route (ROADMAP, Decided).
NS_KERNEL_PRECISION = {"highest": "highest", "high": "high",
                       "default": "high"}


def factorize_X(D, C, *, ns_iters: int = 0, ns_anchor: int = 0,
                ns_precision: str = "highest"):
    """Block factorization storing the symmetric inverses X (..., K, n, n)
    of the Schur complements S_k = D_k - (C_k (x) I) X_{k-1} (C_k (x) I)^T.

    ``ns_iters = 0``: exact inverse at every step.  ``ns_iters > 0``:
    interior steps run that many Newton-Schulz iterations warm-started from
    X_{k-1}; the steps of :func:`ns_anchors` are exact.  ``ns_precision``
    is one of JAX's names (:data:`NS_KERNEL_PRECISION`), and each takes the
    products in FP32 (ROADMAP, Decided)."""
    if ns_precision not in NS_KERNEL_PRECISION:
        raise ValueError(f"ns_precision={ns_precision!r}: one of "
                         f"{tuple(NS_KERNEL_PRECISION)}")
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
    slot scalars C (K-1, 3, 3), or one set a lane (B, K-1, 3, 3) for
    X (B, K, n, n); b (..., K, n).

        w_k = X_k (b_k - B_k w_{k-1})
        x_{K-1} = w_{K-1};   x_k = w_k - X_k (B_{k+1}^T x_{k+1})
    """
    K = X.shape[-3]
    w = [_mv(X[..., 0, :, :], b[..., 0, :])]
    for k in range(1, K):
        w.append(_mv(X[..., k, :, :],
                     b[..., k, :] - slot_apply_vec(C[..., k - 1, :, :],
                                                   w[-1])))
    x = [None] * K
    x[K - 1] = w[K - 1]
    for k in range(K - 2, -1, -1):
        x[k] = w[k] - _mv(X[..., k, :, :],
                          slot_apply_vec(C[..., k, :, :].mT, x[k + 1]))
    return torch.stack(x, dim=-2)


def apply_M(xv: StateVars, rho: RowVals, eta, E, *, h: float, sigma):
    """Reference application of M = P + sigma I + A^T rho A (for tests)."""
    rAx = tree_map(lambda a, r: a * r, apply_A(xv, eta, E, h), rho)
    ATrAx = apply_AT(rAx, eta, E, h)
    Px = StateVars(a=2.0 * xv.a, p=torch.zeros_like(xv.p),
                   v=torch.zeros_like(xv.v))
    return tree_map(lambda p_, s_, at: p_ + sigma * s_ + at, Px, xv, ATrAx)


# ---------------------------------------------------------------------------
# Per-channel (row-wise) block assembly, for the active-set polish, where
# the rho pattern varies per (vehicle, axis) row, not just per k
# ---------------------------------------------------------------------------

def _slot_diag_chan(n6, n2, sr, sc, vals):
    """vals (..., K, n2) -> (..., K, n6, n6) with per-channel values on the
    (sr, sc) slot diagonal (channel order as :func:`to_stacked`'s:
    vehicle-major, then axis)."""
    out = torch.zeros(vals.shape[:-1] + (n6, n6), dtype=vals.dtype,
                      device=vals.device)
    idx = torch.arange(n2, device=vals.device)
    out[..., sr * n2 + idx, sc * n2 + idx] = vals
    return out


def _chan(leaf, n_vehicles):
    """(..., N, K', 2) full rho leaf -> (..., K', 2N) in stacked channel
    order."""
    t = torch.swapaxes(leaf, -3, -2)
    return t.reshape(t.shape[:-2] + (2 * n_vehicles,))


def assemble_blocks_rowwise(rho: RowVals, eta, E, *, h: float, sigma,
                            n_vehicles: int, group=None):
    """Like :func:`assemble_blocks`, but the jerk/acc/vbox/pbox rho may vary
    per (vehicle, axis) channel: full (..., N, K', 2) leaves.  The dynamics
    rho must still be per-k ((K, 1) leaves), as in the polish, where the
    dynamics rows are always active with per-k scaling.  Returns D and B,
    both (..., K(-1), 6N, 6N) with the batch axes of the leaves; ``group``
    as in :func:`collision_blocks`."""
    N = n_vehicles
    n2, n6, h2 = 2 * N, 6 * N, h * h
    rdp = _per_k(rho.dyn_p)                  # (K,) dynamics rho, per k
    rdv = _per_k(rho.dyn_v)
    rj = _chan(rho.jerk, N)                  # (..., K-1, 2N)
    ra = _chan(rho.acc, N)
    rv = _chan(rho.vbox, N)
    rp = _chan(rho.pbox, N)
    zero_k = torch.zeros(1, dtype=rdp.dtype, device=rdp.device)
    rdp_next = torch.cat([rdp[1:], zero_k])
    rdv_next = torch.cat([rdv[1:], zero_k])
    zrow = torch.zeros(rj.shape[:-2] + (1, n2), dtype=rj.dtype,
                       device=rj.device)
    rj_prev = torch.cat([zrow, rj], dim=-2)          # jerk row k-1
    rj_here = torch.cat([rj, zrow], dim=-2)          # jerk row k

    aa = (2.0 + sigma + (rdp * (0.25 * h2 * h2) + rdv * h2)[:, None]
          + ra + (rj_here + rj_prev) / h2)
    pp = (sigma + rdp + rdp_next)[:, None] + rp
    vv = (sigma + rdv + rdv_next + rdp_next * h2)[:, None] + rv
    ap = -0.5 * h2 * rdp
    av = -h * rdv
    pv = h * rdp_next

    D = (_slot_diag_chan(n6, n2, 0, 0, aa)
         + _slot_diag_chan(n6, n2, 1, 1, pp)
         + _slot_diag_chan(n6, n2, 2, 2, vv)
         + _slot_diag(n6, n2, 0, 1, ap) + _slot_diag(n6, n2, 1, 0, ap)
         + _slot_diag(n6, n2, 0, 2, av) + _slot_diag(n6, n2, 2, 0, av)
         + _slot_diag(n6, n2, 1, 2, pv) + _slot_diag(n6, n2, 2, 1, pv))
    D[..., n2:2 * n2, n2:2 * n2] += collision_blocks(rho.col, eta, E, group)

    # B_k: rows u_k, cols u_{k-1}; only the jerk (a, a) slot is per channel
    B = (_slot_diag_chan(n6, n2, 0, 0, -rj / h2)
         + _slot_diag(n6, n2, 0, 1, 0.5 * h2 * rdp[1:])
         + _slot_diag(n6, n2, 0, 2, 0.5 * h2 * h * rdp[1:] + h * rdv[1:])
         + _slot_diag(n6, n2, 1, 1, -rdp[1:])
         + _slot_diag(n6, n2, 1, 2, -h * rdp[1:])
         + _slot_diag(n6, n2, 2, 2, -rdv[1:]))
    return D, B


# ---------------------------------------------------------------------------
# Exact active-set polish (augmented Lagrangian on the banded factorization)
# ---------------------------------------------------------------------------

def polish_qp_state(lower: RowVals, upper: RowVals, eta, x: StateVars,
                    y: RowVals, E, *, h: float, n_vehicles: int,
                    rho_polish: float = 1e5, iters: int = 6,
                    eps_act: float = 1e-10, group=None) -> StateVars:
    """Refine the ADMM iterates of a batch (scenario axis first) to the
    exact KKT points of the QPs restricted to the active sets their duals
    identify (JAX ``banded.polish_qp_state``): the method of multipliers on
    min x'Px s.t. A_act x = b_act, each x-step solved exactly by the block
    Cholesky of one factorization a lane (active rows at ``rho_polish``,
    inactive rows dropped):

        x  <-  argmin x'Px + sum_act rho/2 (A_i x - b_i + y_i/rho)^2
        y  <-  y + rho (A_act x - b_act)

    A lane takes its polished point only where that violates no bound more
    than the ADMM iterate does (or by at most 1e-9, scaled rows); else it
    keeps ``x``.  The factorization and the sweeps are the plain
    :func:`factorize` and :func:`solve_factorized`, as JAX's are: no
    kernel.  ``group``: the collision rows are this rank's share of the
    pairs; the collision blocks, A^T and the violations reduce over the
    group, so the polished x is the same on every rank."""
    dtype = x.a.dtype
    N = n_vehicles
    K = x.a.shape[-2]
    nb = x.a.dim() - 3
    sigma = torch.tensor(1e-12, dtype=dtype, device=x.a.device)
    scaling = row_scaling_state(K, h, dtype=dtype, device=x.a.device)

    def box_mask(yv, lo, up):
        lo_act = (yv < -eps_act) & torch.isfinite(lo)
        up_act = (yv > eps_act) & torch.isfinite(up)
        b = torch.where(yv < 0, lo, up)
        # equality rows (terminal vbox/pbox) are always active
        m = lo_act | up_act | (lo == up)
        return m.to(dtype), torch.where(torch.isfinite(b), b,
                                        torch.zeros_like(b))

    boxes = {name: box_mask(getattr(y, name), getattr(lower, name),
                            getattr(upper, name))
             for name in ("jerk", "acc", "vbox", "pbox", "col")}
    ones = torch.ones_like
    mask = RowVals(dyn_p=ones(y.dyn_p), dyn_v=ones(y.dyn_v),
                   **{k: v[0] for k, v in boxes.items()})
    b_act = RowVals(dyn_p=lower.dyn_p, dyn_v=lower.dyn_v,
                    **{k: v[1] for k, v in boxes.items()})
    rho_p = torch.tensor(rho_polish, dtype=dtype, device=x.a.device)

    def box_rho(m, d):
        # inactive rows drop out entirely (rho 0, not the loose ADMM rho)
        return torch.where(m > 0, rho_p * d * d, torch.zeros_like(m))

    rho_row = RowVals(
        dyn_p=rho_p * scaling.dyn_p * scaling.dyn_p,
        dyn_v=rho_p * scaling.dyn_v * scaling.dyn_v,
        jerk=box_rho(mask.jerk, scaling.jerk),
        acc=box_rho(mask.acc, scaling.acc),
        vbox=box_rho(mask.vbox, scaling.vbox),
        pbox=box_rho(mask.pbox, scaling.pbox),
        col=box_rho(mask.col, scaling.col.expand(mask.col.shape)))
    D, B = assemble_blocks_rowwise(rho_row, eta, E, h=h, sigma=sigma,
                                   n_vehicles=N, group=group)
    L, Eb = factorize(D, B)
    del D, B

    def solve_x(yal):
        rzy = tree_map(lambda r, b, ya, m: (r * b - ya) * m, rho_row, b_act,
                       yal, mask)
        rhs = apply_AT(rzy, eta, E, h, group)
        return from_stacked(solve_factorized(L, Eb, to_stacked(rhs)), N)

    yal = tree_map(torch.zeros_like, mask)
    x_pol = x
    for _ in range(iters):
        x_pol = solve_x(yal)
        Ax = apply_A(x_pol, eta, E, h)
        yal = tree_map(lambda ya, r, a, b, m: (ya + r * (a - b)) * m,
                       yal, rho_row, Ax, b_act, mask)

    def viol(xv):
        # the worst scaled violation of any original bound
        Ax = apply_A(xv, eta, E, h)
        zero = torch.zeros((), dtype=dtype, device=x.a.device)
        v = tree_map(lambda a, lo, up, d: torch.clamp_min(torch.maximum(
            torch.where(torch.isfinite(lo), (lo - a) * d, zero),
            torch.where(torch.isfinite(up), (a - up) * d, zero)), 0.0),
            Ax, lower, upper, scaling)
        return _inf_norm(v, nb, group)

    ok = viol(x_pol) <= torch.clamp_min(viol(x), 1e-9)
    return tree_map(lambda a, b: torch.where(lane_mask(ok, a), a, b), x_pol,
                    x)


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
    raises for any other dtype, and computes its products at
    :data:`NS_KERNEL_PRECISION` of ``static.ns_precision``; on the CPU it
    is :func:`factorize_X`."""
    K = D.shape[-3]
    if (static.kernels and static.ns_iters > 0 and static.ns_anchor == 0
            and K >= 6):
        from ..ops.ns_chain import factorize_X_chain_batched
        return factorize_X_chain_batched(
            D, C, ns_iters=static.ns_iters,
            ns_precision=NS_KERNEL_PRECISION[static.ns_precision])
    return factorize_X(D, C, ns_iters=static.ns_iters,
                       ns_anchor=static.ns_anchor,
                       ns_precision=static.ns_precision)


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

    On the card the ADMM iterations of "grouped_X", "grouped_L" and
    "resident" run as the hand-written stages of ``ops/admm_steps.py``
    around the sweep kernel, and each interval of "channel" as one kernel
    launch, in float32; "channel" in float64 (the parity and CG phases'
    phase 1) replays the plain interval as a CUDA graph
    (``utils/graphs.graphed``), as "dense" does (:func:`interval_kind`).

    The gates are the JAX router's as they stand: its 12 MiB and 96 MiB are
    byte budgets of the TPU's VMEM, kept so that the port routes where JAX
    routes.  They count the working dtype's item size, also for bf16
    factor storage (``static.factor_dtype``), as JAX's do; bf16 then
    stores the factors of the grouped routes and of the dense pair
    (``resident``, ``dense``, ``fused_L``) in bf16 (:func:`compress_factors`),
    and those of ``channel`` and ``fused_X`` in the working dtype, as JAX
    does.  Adaptive rho routes as the shared rho does.

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
    if static.factor_dtype not in ("f32", "bf16"):
        raise ValueError(f"factor_dtype={static.factor_dtype!r}: 'f32' or "
                         "'bf16'")
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


SHARED_C_ROUTES = ("grouped_X", "grouped_L", "fused_X")
# the routes whose ADMM iterations run on the planes of ops/admm_steps.py
# (:func:`_interval_fn`)
ROW_STAGE_ROUTES = ("grouped_X", "grouped_L", "resident", "channel")
# the routes whose factors bf16 factor storage compresses (JAX
# ``banded.py:1306-1317``): not "channel", not "fused_X"
BF16_ROUTES = ("grouped_X", "grouped_L", "resident", "dense", "fused_L")


def _route_factors(route: str, rho_b: RowVals, eta, E, static: SolverStatic,
                   n_vehicles: int, h: float, sigma, rho_lane=None, C1=None,
                   group=None):
    """The factors of ``route`` for the lanes of ``eta``, as a tuple.

    A batch-shared rho gives the factors the kernels take, the X-form and
    L-only ones with their batch-shared slot scalars C last.  A per-lane
    rho ``rho_lane`` (B,) (adaptive rho) gives a tuple of per-lane tensors
    only.  The sweep kernels and the NS chain take batch-shared slot
    scalars, and C is linear in rho, so the routes of
    :data:`SHARED_C_ROUTES` factorize M / rho_lane, whose off-diagonal
    slot scalars are ``C1`` (those of rho = 1) for every lane: the grouped
    routes then solve (M / rho) x = b / rho, and the fused X route takes
    X = (its factors of M / rho) / rho with each lane's own C.

    With ``static.factor_dtype == "bf16"`` the factor blocks of the routes
    of :data:`BF16_ROUTES` come as :func:`compress_factors` stores them.
    ``group``: the pairs of ``eta`` are this rank's share (the collision
    blocks are summed over the group)."""
    factors = _route_factors_wide(route, rho_b, eta, E, static, n_vehicles,
                                  h, sigma, rho_lane, C1, group)
    if static.factor_dtype != "bf16" or route not in BF16_ROUTES:
        return factors
    if route in SHARED_C_ROUTES:
        return compress_factors(factors[0]) + factors[1:]
    return compress_factors(*factors)


def _route_factors_wide(route: str, rho_b: RowVals, eta, E,
                        static: SolverStatic, n_vehicles: int, h: float,
                        sigma, rho_lane=None, C1=None, group=None):
    """:func:`_route_factors` in the working dtype."""
    N = n_vehicles
    if route == "channel":
        with span("qp.assemble"):
            blocks = assemble_channel(rho_b, h=h, sigma=sigma)
        return factorize(*blocks)
    if route in SHARED_C_ROUTES:
        from ..ops.assemble_d import assemble_D_fused
        with span("qp.assemble"):
            D, C = assemble_D_fused(rho_b, eta, E, h=h, sigma=sigma,
                                    n_vehicles=N, group=group)
            if rho_lane is not None:
                scale = rho_lane.reshape(-1, 1, 1, 1)
                D = D / scale
        Cf = C if rho_lane is None else C1
        if route == "grouped_L":
            F_ = factorize_L(D, Cf)
        else:
            F_ = _factorize_X_routed(D, Cf, static)
        del D
        if rho_lane is None:
            return F_, C
        if route == "fused_X":
            return F_ / scale, C
        return (F_,)
    with span("qp.assemble"):
        blocks = assemble_blocks(rho_b, eta, E, h=h, sigma=sigma,
                                 n_vehicles=N, group=group)
    return factorize(*blocks)


def interval_kind(route: str, dtype, device, group=None) -> str:
    """How :func:`_interval_fn` runs a check interval of ``route`` for a
    state of ``dtype`` on ``device``:

    * "fused": one fused kernel an interval (``fused_X``, ``fused_L``);
    * "rows": the routes of :data:`ROW_STAGE_ROUTES` on the planes of
      ``ops/admm_steps.py``: a sweep route as three launches an iteration
      (the right-hand side, the route's sweep, the update), the channel
      route as one launch an interval; on the CPU their plain versions;
    * "graph": :func:`admm_iterations`, replayed as a CUDA graph on the
      card (``utils/graphs.graphed``): the dense route, and the channel
      route on the card in another dtype than float32 (its kernel is
      float32 only; the float64 phase 1 of the parity and CG phases);
    * "eager": :func:`admm_iterations` as it runs, for every other route
      when ``group`` shards the collision rows over its ranks: A^T sums
      them over the group between the stages, and a graph's capture would
      hold the group's collectives (only the routes without a kernel then
      run, as JAX's pair-sharded solver forces)."""
    if route in ("fused_X", "fused_L"):
        return "fused"
    if group is not None:
        return "eager"
    if route in ROW_STAGE_ROUTES and not (
            route == "channel" and torch.device(device).type == "cuda"
            and dtype != torch.float32):
        return "rows"
    return "graph"


def _interval_fn(route: str, factors: tuple, rho_b: RowVals, lower: RowVals,
                 upper: RowVals, eta, E, n_vehicles: int, step: dict,
                 C1=None, inv_rho=None, group=None):
    """The function (x, z, y) -> (x, z, y) that runs one check interval on
    ``route`` from the factors of :func:`_route_factors` (``C1`` and the
    per-lane ``inv_rho`` (B,) where those are of M / rho), in the way
    :func:`interval_kind` names."""
    N = n_vehicles
    kind = interval_kind(route, eta.dtype, eta.device, group)
    if route == "fused_X":
        from ..ops.admm_fused import admm_interval_fused_X
        Xf, C = factors
        return lambda x, z, y: admm_interval_fused_X(
            Xf, C, eta, E, lower, upper, x, z, y, rho_b, **step)
    if route == "fused_L":
        from ..ops.admm_fused import admm_interval_fused
        Linv, Eb = factors
        return lambda x, z, y: admm_interval_fused(
            Linv, Eb, eta, E, lower, upper, x, z, y, rho_b, **step)

    # the x-update of the route: b (B, K, 6N) -> M^{-1} b
    if route == "channel":
        L, Eb = factors

        def solve(sb):
            return solve_factorized_channel(
                L, Eb, sb.reshape(sb.shape[:-1] + (3, 2 * N))).reshape(
                    sb.shape)
    elif route in ("grouped_X", "grouped_L"):
        from ..ops.group_solve import (solve_factorized_grouped_L,
                                       solve_factorized_grouped_X)
        F_ = factors[0]
        C = factors[1] if C1 is None else C1
        kernel = (solve_factorized_grouped_X if route == "grouped_X"
                  else solve_factorized_grouped_L)

        def solve(sb):
            return kernel(F_, C, sb)
    elif route == "resident":
        from ..ops.banded_solve import solve_factorized_dense
        Linv, Eb = factors

        def solve(sb):
            return solve_factorized_dense(Linv, Eb, sb)
    else:
        Linv, Eb = factors

        def solve(sb):
            return solve_factorized(Linv, Eb, sb)

    if kind == "rows":
        from ..ops import admm_steps
        consts = admm_steps.row_consts(
            eta, E, lower, upper, rho_b, h=step["h"], sigma=step["sigma"],
            alpha=step["alpha"], lam=step["lam"])
        if route == "channel":
            return admm_steps.channel_interval(*factors, consts,
                                               step["n_iters"])
        return admm_steps.sweep_interval(solve, consts, step["n_iters"],
                                         inv_rho)

    def interval(x, z, y):
        return admm_iterations(
            x, z, y,
            solve if inv_rho is None
            else lambda sb: solve(sb * inv_rho[:, None, None]),
            eta, E, lower, upper, rho_b, **step, group=group)
    return graphed(interval) if kind == "graph" else interval


# OSQP's adaptive-rho rule (JAX ``banded.py:1432-1448``): after a check
# interval rho moves to clip(rho * sqrt(pr / dr)) when that ratio leaves
# (1/5, 5); y is not rescaled.
RHO_ADAPT_RATIO = 5.0
RHO_MIN, RHO_MAX = 1e-6, 1e6


def solve_qp_state(lower: RowVals, upper: RowVals, eta, x_init: StateVars,
                   params: SolverParams, E, *, h: float,
                   static: SolverStatic, n_vehicles: int,
                   y_init: RowVals | None = None,
                   col_enabled: bool = True, group=None) -> StateQPResult:
    """One ADMM solve in state space for a batch of scenarios.

    Every argument carries the scenario axis first: bounds and duals as
    (B, ...) RowVals, eta (B, K, P, 2), x_init (B, N, K, 2) StateVars.
    Collision rows are controlled through ``lower.col`` (-inf rows are
    disabled).  ``col_enabled=False`` marks the collision-free initial QP,
    whose x-updates run on the per-channel (K, 3, 3) factorization, shared
    by every lane unless rho adapts.

    The loop runs intervals of ``check_interval`` iterations, with the
    residuals checked after each, while ``iters < max_iter`` and the lane
    has not converged.  A lane that has stopped keeps its x, y, iteration
    count, residuals and ``converged`` flag while the others go on, as each
    lane of the vmapped JAX loop does; the host reads one flag per interval
    (does any lane go on?), and none when the budget is one interval.

    With ``static.adaptive_rho`` each lane carries its own rho, which
    starts at ``params.rho`` and adapts after each interval by OSQP's rule
    (:data:`RHO_ADAPT_RATIO`, y not rescaled); the lanes that go on and
    adapt get new factors (gathered, refactorized and scattered back; none
    after the last interval), and the host reads which lanes those are
    instead of the one flag.

    The fused routes keep the rho of :func:`rho_pattern_masks` on every
    collision row, as the JAX router does; the other routes give rows
    disabled by a -inf lower bound the loose rho.

    ``group`` (JAX's ``axis_name``): eta, the collision rows and their
    duals hold this rank's share of the pairs; the collision blocks, A^T
    and the residual norms are reduced over the group, so x is the same on
    every rank.  ``None`` runs as on one device.

    Under a ``torch.profiler`` its parts are the spans ``qp.rows`` (the
    rows and their rho), ``qp.factors`` (the set-up: ``qp.assemble`` and,
    on the NS-chain route, ``qp.anchors`` and ``qp.ns_chain``),
    ``qp.interval`` (building each check interval, and each run of one)
    and ``qp.residuals``.
    """
    dtype = x_init.a.dtype
    N = n_vehicles
    K = x_init.a.shape[-2]
    P = lower.col.shape[-1]
    nb = x_init.a.dim() - 3
    route = qp_route(static, n_vehicles=N, n_steps=K, dtype=dtype,
                     col_enabled=col_enabled)
    check, max_iter = int(params.check_interval), int(params.max_iter)
    dev = x_init.a.device
    step = dict(h=h, sigma=params.sigma, alpha=params.alpha,
                lam=params.col_penalty, n_iters=check)
    loose_col = route not in ("channel", "fused_X", "fused_L")

    def rho_rows(rho, lower_col):
        rho_b = rho_pattern_masks(scaling, static, rho, params.col_rho_boost,
                                  n_steps=K, n_pairs=P,
                                  col_enabled=col_enabled, dtype=dtype)
        if loose_col:
            # rows disabled by a -inf bound take the loose rho
            rho_b = rho_b._replace(col=torch.where(
                torch.isinf(lower_col), torch.full_like(lower_col, _LOOSE_RHO),
                rho_b.col))
        return rho_b

    def factors_of(rho_b, eta_, rho_lane=None, C1=None):
        with span("qp.factors"):
            return _route_factors(route, rho_b, eta_, E, static, N, h,
                                  params.sigma, rho_lane=rho_lane, C1=C1,
                                  group=group)

    adaptive = static.adaptive_rho
    with span("qp.rows"):
        scaling = row_scaling_state(K, h, dtype=dtype, device=dev)
        Ax0 = apply_A(x_init, eta, E, h)
        z = tree_map(torch.clamp, Ax0, lower, upper)
        y = tree_map(torch.zeros_like, z) if y_init is None else y_init
        x = x_init
        if not adaptive:
            rho_b = rho_rows(params.rho, lower.col)
        else:
            B = x_init.a.shape[0]
            rho_l = params.rho.to(dtype).expand(B).clone()
            C1 = (unit_slot_scalars(static, n_steps=K, h=h, dtype=dtype,
                                    device=dev)
                  if route in SHARED_C_ROUTES else None)
            rho_b = tree_map(torch.Tensor.contiguous,
                             rho_rows(rho_l, lower.col))
    if not adaptive:
        factors = factors_of(rho_b, eta)
        with span("qp.interval"):
            interval = _interval_fn(route, factors, rho_b, lower, upper, eta,
                                    E, N, step, group=group)
    else:
        factors = factors_of(rho_b, eta, rho_l, C1)
        scaled = route in ("grouped_X", "grouped_L")

        def interval_now():
            with span("qp.interval"):
                return _interval_fn(route, factors, rho_b, lower, upper, eta,
                                    E, N, step, C1=C1 if scaled else None,
                                    inv_rho=1.0 / rho_l if scaled else None,
                                    group=group)
        interval = interval_now()

    def residuals(x, z, y):
        with span("qp.residuals"):
            return _residuals(x, z, y, eta, E, h, scaling, params, nb, group)

    with span("qp.interval"):
        x, z, y = interval(x, z, y)
    prim, dual, done, scales = residuals(x, z, y)
    iters = torch.full(prim.shape, check, dtype=torch.int32, device=dev)
    active = ~done
    for _ in range(check, max_iter, check):
        if adaptive:
            # the relative residuals of the last interval, which every lane
            # that goes on ran
            pr, dr = (r / torch.clamp_min(sc, 1e-10)
                      for r, sc in zip((prim, dual), scales))
            ratio = torch.sqrt(pr / torch.clamp_min(dr, 1e-12))
            refac = active & ((ratio > RHO_ADAPT_RATIO)
                              | (ratio < 1.0 / RHO_ADAPT_RATIO))
            flags = host_read("qp", torch.stack([active, refac]))
            if not bool(flags[0].any()):
                break
            if bool(flags[1].any()):
                idx = torch.nonzero(flags[1]).squeeze(1)
                solve_qp_state.refactorized_lanes += idx.numel()
                idx = idx.to(dev)
                rho_l[idx] = torch.clamp(rho_l[idx] * ratio[idx], RHO_MIN,
                                         RHO_MAX)
                sub_b = rho_rows(rho_l[idx], lower.col[idx])
                sub = factors_of(sub_b, eta[idx], rho_l[idx], C1)
                for full, part in zip(tuple(rho_b) + tuple(factors),
                                      tuple(sub_b) + tuple(sub)):
                    full[idx] = part
                interval = interval_now()
        elif not bool(host_read("qp", active.any())):
            break
        with span("qp.interval"):
            new = interval(x, z, y)
        *res, scales = residuals(*new)

        def keep(n_, o_):
            return torch.where(lane_mask(active, n_), n_, o_)
        x, z, y = (tree_map(keep, n_, o_) for n_, o_ in zip(new, (x, z, y)))
        prim, dual, done = (keep(n_, o_) for n_, o_ in zip(
            res, (prim, dual, done)))
        iters = iters + check * active.to(torch.int32)
        active = active & ~done
    return StateQPResult(x=x, y=y, iters=iters, prim_res=prim, dual_res=dual,
                         converged=done)


# lanes refactorized after their rho adapted, summed over calls
solve_qp_state.refactorized_lanes = 0


def admm_iterations(x: StateVars, z: RowVals, y: RowVals, solve, eta, E,
                    lower: RowVals, upper: RowVals, rho: RowVals, *, h: float,
                    sigma, alpha, lam, n_iters: int, group=None):
    """``n_iters`` ADMM iterations from (x, z, y): the loop body of the JAX
    ``solve_qp_state`` (``admm_iter``).  ``solve`` maps a stacked right-hand
    side (..., K, 6N) to the solution of the normal equations.  Returns the
    new (x, z, y).  ``group``: A^T sums the sharded collision rows over
    it."""
    N = x.a.shape[-3]
    for _ in range(n_iters):
        rzy = tree_map(lambda zz, yy, rr: rr * zz - yy, z, y, rho)
        b_sv = apply_AT(rzy, eta, E, h, group)
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


def _residuals(x, z, y, eta, E, h, scaling, params, nb, group=None):
    """OSQP primal/dual residuals, the termination test and the scales of
    the two residuals (which make them relative), per scenario; the norms
    over the rows reduce over ``group`` where those are sharded (x and
    A^T y are the same on every rank)."""
    Ax = apply_A(x, eta, E, h)
    dAx = tree_map(lambda a, d_: a * d_, Ax, scaling)
    dz = tree_map(lambda a, d_: a * d_, z, scaling)
    prim = _inf_norm(tree_map(lambda a, b_: a - b_, dAx, dz), nb, group)
    ATy = apply_AT(y, eta, E, h, group)
    dual = _inf_norm(StateVars(a=2.0 * x.a + ATy.a, p=ATy.p, v=ATy.v), nb)
    prim_scale = torch.maximum(_inf_norm(dAx, nb, group),
                               _inf_norm(dz, nb, group))
    dual_scale = torch.maximum(2.0 * x.a.abs().flatten(nb).amax(-1),
                               _inf_norm(ATy, nb))
    eps_prim = params.eps_abs + params.eps_rel * prim_scale
    eps_dual = params.eps_abs + params.eps_rel * dual_scale
    done = (prim <= eps_prim) & (dual <= eps_dual)
    return prim, dual, done, (prim_scale, dual_scale)
