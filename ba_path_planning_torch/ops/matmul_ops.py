"""The constraint operators of ``ops/constraints.py`` as dense (K, K)
matrix products along the K axis, ``SolverConfig.operator_impl="matmul"``
(counterpart of ``ba_path_planning_tpu.ops.matmul_ops``).  The matrices come
from :class:`~ba_path_planning_torch.models.double_integrator.DoubleIntegrator2D`
in float64, built once per (K, h) and cast to the operand's dtype and
device."""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from ..models.double_integrator import DoubleIntegrator2D


@lru_cache(maxsize=32)
def _mats_np(K: int, h: float):
    """L (cumulative sum), S (position rows), W (zero-IC rollout)."""
    model = DoubleIntegrator2D(n_steps=K, time_step=h)
    return (model.velocity_matrix() / h, model.position_matrix(),
            model.rollout_position_matrix())


def _mats(K: int, h: float, like: torch.Tensor):
    return tuple(torch.as_tensor(m, dtype=like.dtype, device=like.device)
                 for m in _mats_np(K, float(h)))


def _k_apply(M, x):
    """(K, K) matrix applied along the K axis of (..., K, 2) tensors."""
    return torch.einsum('kl,...lc->...kc', M, x)


def _kt_apply(M, y):
    """Its transpose along the K axis."""
    return torch.einsum('lk,...lc->...kc', M, y)


def apply_static_matmul(a: torch.Tensor, h: float):
    """Matmul form of ``constraints.apply_static``: (jerk, acc, vel, pos)."""
    L, S, _ = _mats(a.shape[-2], h, a)
    jerk = (a[..., 1:, :] - a[..., :-1, :]) / h
    return jerk, a, h * _k_apply(L, a), _k_apply(S, a)


def apply_static_adjoint_matmul(jerk_y, acc_y, vel_y, pos_y, h: float):
    """Matmul form of ``constraints.apply_static_adjoint``."""
    L, S, _ = _mats(acc_y.shape[-2], h, acc_y)
    yp = F.pad(jerk_y, (0, 0, 1, 1))
    out = (yp[..., :-1, :] - yp[..., 1:, :]) / h + acc_y
    return out + h * _kt_apply(L, vel_y) + _kt_apply(S, pos_y)


def apply_collision_matmul(a, eta, E, h: float) -> torch.Tensor:
    """Matmul form of ``constraints.apply_collision``."""
    _, _, W = _mats(a.shape[-2], h, a)
    dp = torch.einsum('np,...nkc->...kpc', E, _k_apply(W, a))
    return torch.sum(eta * dp, dim=-1)


def apply_collision_adjoint_matmul(y, eta, E, h: float) -> torch.Tensor:
    """Matmul form of ``constraints.apply_collision_adjoint``."""
    _, _, W = _mats(y.shape[-2], h, y)
    g = torch.einsum('np,...kpc->...nkc', E, y[..., None] * eta)
    return _kt_apply(W, g)
