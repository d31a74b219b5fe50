"""Double-integrator vehicle model: the dense operator matrices, the
closed-form terminal state, the exact goal projection and the reachability
screen (counterpart of ``ba_path_planning_tpu.models.double_integrator``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.profiling import host_write


@dataclass(frozen=True)
class DoubleIntegrator2D:
    """2-axis double integrator with timestep ``time_step`` over ``n_steps``."""
    n_steps: int
    time_step: float

    # ---- dense operator forms (K x K float64 arrays), for the CG method's
    # preconditioner and the matmul operators

    def velocity_matrix(self) -> np.ndarray:
        """L with velocity row k = h * sum_{j<=k} a[j]."""
        K = self.n_steps
        return self.time_step * np.tril(np.ones((K, K)))

    def position_matrix(self) -> np.ndarray:
        """S with position row k = sum_{j<=k} h^2 (k - j + 0.5) a[j]."""
        K, h = self.n_steps, self.time_step
        k, j = np.indices((K, K))
        return np.where(j <= k, h * h * (k - j + 0.5), 0.0)

    def rollout_position_matrix(self) -> np.ndarray:
        """W with p~[k] = sum_{j<k} h^2 (k - j - 0.5) a[j] (zero row 0)."""
        K, h = self.n_steps, self.time_step
        k, j = np.indices((K, K))
        return np.where(j < k, h * h * (k - j - 0.5), 0.0)

    def jerk_matrix(self) -> np.ndarray:
        """First-difference operator scaled by 1/h, (K-1) x K."""
        K, h = self.n_steps, self.time_step
        J = np.zeros((K - 1, K))
        J[np.arange(K - 1), np.arange(K - 1)] = -1.0 / h
        J[np.arange(K - 1), np.arange(1, K)] = 1.0 / h
        return J

    def terminal_state(self, positions, velocities, accelerations):
        """(p[K], v[K]) one step past the last rollout index.
        Inputs are (..., K, 2) rollout tensors."""
        h = self.time_step
        pK = (positions[..., -1, :] + h * velocities[..., -1, :]
              + 0.5 * h * h * accelerations[..., -1, :])
        vK = velocities[..., -1, :] + h * accelerations[..., -1, :]
        return pK, vK

    def goal_projection(self, accelerations, p0, v0, pf, vf):
        """Least-norm acceleration correction that makes p[K] = pf and
        v[K] = vf exactly: da = G^T (G G^T)^{-1} r with G = [c1; c2],
        c1[j] = h, c2[j] = h^2 (K - j - 0.5), and r the terminal residual.
        The constant 2x2 inverse is formed in float64 on the host.

        accelerations (..., K, 2); p0/v0/pf/vf (..., 2)."""
        K, h = self.n_steps, self.time_step
        a = accelerations
        c2_np = (h * h) * (K - np.arange(K) - 0.5)
        g11 = K * h * h
        g12 = float(h * c2_np.sum())
        g22 = float((c2_np * c2_np).sum())
        det = g11 * g22 - g12 * g12
        i11, i12, i22 = g22 / det, -g12 / det, g11 / det
        c2 = host_write("scp", c2_np, dtype=a.dtype, device=a.device)

        vK = v0 + h * torch.sum(a, dim=-2)
        pK = p0 + (K * h) * v0 + torch.sum(c2[:, None] * a, dim=-2)
        r_v = vf - vK
        r_p = pf - pK
        alpha = i11 * r_v + i12 * r_p
        beta = i12 * r_v + i22 * r_p
        return a + h * alpha[..., None, :] + c2[:, None] * beta[..., None, :]

    def max_displacement(self, vel_max: float, acc_max: float) -> float:
        """Upper bound on the reachable per-axis displacement from rest to
        rest over the horizon, a cheap pre-feasibility screen.  The velocity
        and acceleration limits are per-axis boxes, so the reachable set is a
        square of this half-width, not a disc."""
        T = self.n_steps * self.time_step
        # accelerate/decelerate triangle capped by vel_max
        t_ramp = vel_max / acc_max
        if T <= 2 * t_ramp:
            return 0.25 * acc_max * T * T
        return vel_max * (T - t_ramp)

    def reachable(self, p0, pf, vel_max: float, acc_max: float):
        """Per vehicle: is every axis of |pf - p0| within
        :meth:`max_displacement`?  p0/pf (..., 2) tensors (the result is a
        bool tensor on their device) or arrays (a numpy bool array)."""
        bound = self.max_displacement(vel_max, acc_max)
        if isinstance(p0, torch.Tensor) or isinstance(pf, torch.Tensor):
            dev = (p0 if isinstance(p0, torch.Tensor) else pf).device
            d = (torch.as_tensor(pf, device=dev)
                 - torch.as_tensor(p0, device=dev)).abs().amax(-1)
        else:
            d = np.max(np.abs(np.asarray(pf) - np.asarray(p0)), axis=-1)
        return d <= bound
