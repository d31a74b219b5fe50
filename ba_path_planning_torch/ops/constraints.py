"""Matrix-free constraint operators and bounds of the acceleration-space
QP, the CG method's (counterpart of ``ba_path_planning_tpu.ops.constraints``).

The QP's variables are the accelerations a (..., N, K, 2); its rows are five
blocks with closed-form prefix-sum structure, applied without a matrix:

    jerk (N, K-1, 2): (a[k+1] - a[k]) / h
    acc  (N, K, 2):   a[k]
    vel  (N, K, 2):   h sum_{j<=k} a[j]                (= v[k+1] - v0)
    pos  (N, K, 2):   sum_{j<=k} h^2 (k-j+0.5) a[j]    (= p[k+1] - p0 - (k+1) h v0)
    col  (K, P):      eta[k,p] . (p~_i[k] - p~_j[k]), p~ the zero-IC rollout

The offsets are folded into the bounds (:func:`static_bounds`): box rows for
k < K-1, terminal equality rows at k = K-1.  Every function broadcasts over
leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .rollout import (reverse_cumsum, rollout_positions_zero_ic,
                      rollout_positions_zero_ic_adjoint)


class ConstraintBlocks(NamedTuple):
    """Row-space vector of the stacked constraint operator, as blocks."""
    jerk: torch.Tensor   # (..., N, K-1, 2)
    acc: torch.Tensor    # (..., N, K, 2)
    vel: torch.Tensor    # (..., N, K, 2)
    pos: torch.Tensor    # (..., N, K, 2)
    col: torch.Tensor    # (..., K, P)


def apply_static(a: torch.Tensor, h: float):
    """The four static blocks applied to a (..., N, K, 2): (jerk, acc, vel,
    pos) row values."""
    jerk = (a[..., 1:, :] - a[..., :-1, :]) / h
    cs = torch.cumsum(a, dim=-2)
    vel = h * cs
    # pos row k = h^2 (s2[k] + 0.5 cs[k]), s2[k] = sum_{j<k} (k-j) a[j]
    s2 = torch.cumsum(cs - a, dim=-2)
    pos = (h * h) * (s2 + 0.5 * cs)
    return jerk, a, vel, pos


def apply_static_adjoint(jerk_y, acc_y, vel_y, pos_y, h: float):
    """Adjoint of :func:`apply_static`: the cotangent on a, (..., N, K, 2)."""
    yp = F.pad(jerk_y, (0, 0, 1, 1))
    out = (yp[..., :-1, :] - yp[..., 1:, :]) / h + acc_y
    out = out + h * reverse_cumsum(vel_y)
    # pos^T: out[m] = h^2 (rev-exclusive-cumsum(p1)[m] + 0.5 p1[m]),
    # p1 = rev-inclusive-cumsum(y)
    p1 = reverse_cumsum(pos_y)
    rp = reverse_cumsum(p1 - pos_y)
    return out + (h * h) * (rp + 0.5 * p1)


def pair_incidence(n_vehicles: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Signed incidence E (N, P): E[i, p] = +1, E[j, p] = -1 for pair
    p = (i < j), in ``triu_indices`` order."""
    ii, jj = np.triu_indices(n_vehicles, k=1)
    E = np.zeros((n_vehicles, len(ii)))
    E[ii, np.arange(len(ii))] = 1.0
    E[jj, np.arange(len(ii))] = -1.0
    return torch.as_tensor(E, dtype=dtype, device=device)


def apply_collision(a: torch.Tensor, eta: torch.Tensor, E: torch.Tensor,
                    h: float) -> torch.Tensor:
    """Collision rows (..., K, P) of a (..., N, K, 2); eta (..., K, P, 2),
    E (N, P).  Row (k, p) is eta[k,p] . (p~_i[k] - p~_j[k]) with p~ the
    zero-IC position rollout (row k = 0 is zero)."""
    ptilde = rollout_positions_zero_ic(a, h)
    dp = torch.einsum('np,...nkc->...kpc', E, ptilde)
    return torch.sum(eta * dp, dim=-1)


def apply_collision_adjoint(y: torch.Tensor, eta: torch.Tensor,
                            E: torch.Tensor, h: float) -> torch.Tensor:
    """Adjoint of :func:`apply_collision`: (..., K, P) -> (..., N, K, 2)."""
    g = torch.einsum('np,...kpc->...nkc', E, y[..., None] * eta)
    return rollout_positions_zero_ic_adjoint(g, h)


def apply_A(a: torch.Tensor, eta: torch.Tensor, E: torch.Tensor,
            h: float) -> ConstraintBlocks:
    jerk, acc, vel, pos = apply_static(a, h)
    return ConstraintBlocks(jerk=jerk, acc=acc, vel=vel, pos=pos,
                            col=apply_collision(a, eta, E, h))


def apply_AT(y: ConstraintBlocks, eta: torch.Tensor, E: torch.Tensor,
             h: float) -> torch.Tensor:
    return (apply_static_adjoint(y.jerk, y.acc, y.vel, y.pos, h)
            + apply_collision_adjoint(y.col, eta, E, h))


def static_bounds(p0, v0, pf, vf, *, n_vehicles: int, n_steps: int,
                  h: float, limits) -> tuple[dict, dict]:
    """Lower and upper bounds of the four static blocks, as dicts keyed
    jerk/acc/vel/pos; p0, v0, pf, vf (..., N, 2), ``limits`` the problem's
    ``Limits``."""
    N, K = n_vehicles, n_steps
    dt, dev = p0.dtype, p0.device
    batch = tuple(p0.shape[:-2])

    def full(shape, val):
        return torch.full(batch + shape, val, dtype=dt, device=dev)

    is_term = (torch.arange(K, device=dev) == K - 1).reshape(K, 1)
    # velocity row k is v[k+1] - v0: a box for k < K-1, equality at K-1
    v0b = v0[..., :, None, :]
    term_v = (vf - v0)[..., :, None, :].expand(batch + (N, K, 2))
    l_vel = torch.where(is_term, term_v, (limits.vel_min - v0b).expand(
        batch + (N, K, 2)))
    u_vel = torch.where(is_term, term_v, (limits.vel_max - v0b).expand(
        batch + (N, K, 2)))
    # position row k is p[k+1] - off, off = p0 + (k+1) h v0
    k1 = torch.arange(1, K + 1, dtype=dt, device=dev).reshape(K, 1)
    off = p0[..., :, None, :] + h * k1 * v0[..., :, None, :]
    pos_min = torch.as_tensor(limits.pos_min, dtype=dt, device=dev)
    pos_max = torch.as_tensor(limits.pos_max, dtype=dt, device=dev)
    term_p = pf[..., :, None, :] - off
    l_pos = torch.where(is_term, term_p, pos_min - off)
    u_pos = torch.where(is_term, term_p, pos_max - off)
    lower = dict(jerk=full((N, K - 1, 2), limits.jerk_min),
                 acc=full((N, K, 2), limits.acc_min), vel=l_vel, pos=l_pos)
    upper = dict(jerk=full((N, K - 1, 2), limits.jerk_max),
                 acc=full((N, K, 2), limits.acc_max), vel=u_vel, pos=u_pos)
    return lower, upper
