"""Double-integrator vehicle model: closed-form terminal state and the
exact goal projection (counterpart of
``ba_path_planning_tpu.models.double_integrator``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DoubleIntegrator2D:
    """2-axis double integrator with timestep ``time_step`` over ``n_steps``."""
    n_steps: int
    time_step: float

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
        c2 = torch.as_tensor(c2_np, dtype=a.dtype, device=a.device)

        vK = v0 + h * torch.sum(a, dim=-2)
        pK = p0 + (K * h) * v0 + torch.sum(c2[:, None] * a, dim=-2)
        r_v = vf - vK
        r_p = pf - pK
        alpha = i11 * r_v + i12 * r_p
        beta = i12 * r_v + i22 * r_p
        return a + h * alpha[..., None, :] + c2[:, None] * beta[..., None, :]
