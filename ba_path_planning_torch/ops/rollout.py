"""Double-integrator dynamics rollout as two prefix sums.

    v[k] = v0 + h * sum_{j<k} a[j]
    p[k] = p0 + k h v0 + h^2 (s2[k] - 0.5 s1[k])

with s1 the exclusive and s2 the inclusive prefix sum of s1 (the identity
of ``ba_path_planning_tpu.ops.rollout``).  Accelerations are
``(..., K, 2)``; every leading axis broadcasts.
"""

from __future__ import annotations

import torch


def rollout(accelerations: torch.Tensor, initial_positions: torch.Tensor,
            initial_velocities: torch.Tensor,
            h: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions and velocities (..., K, 2) at k = 0..K-1 (k = 0 is the
    initial state)."""
    K = accelerations.shape[-2]
    s1 = torch.cumsum(accelerations, dim=-2) - accelerations
    s2 = torch.cumsum(s1, dim=-2)
    k_idx = torch.arange(K, dtype=accelerations.dtype,
                         device=accelerations.device).reshape(K, 1)
    p0 = initial_positions[..., None, :]
    v0 = initial_velocities[..., None, :]
    velocities = v0 + h * s1
    positions = p0 + h * k_idx * v0 + (h * h) * (s2 - 0.5 * s1)
    return positions, velocities
