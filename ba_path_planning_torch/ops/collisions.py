"""Collision linearization and feasibility checks (counterpart of
``ba_path_planning_tpu.ops.collisions``).

One half-space row per (timestep k, pair i<j), pairs in ``triu_indices``
order.  A degenerate pair (distance < 1e-6) gets the direction
(cos angle, sin angle).  The JAX package draws that angle from a threefry
fold-in, which PyTorch cannot reproduce; here :func:`linearize` takes the
angles as a tensor, and :func:`degenerate_angles` draws them on the main
path from a counter-based hash of (seed, scenario id, SCP iteration, pair id,
k).  A lane's draws therefore do not depend on which other lanes share its
batch, so compaction cannot change them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

DEGENERATE_EPS = 1e-6
FEAS_SLACK = 0.01

_M32 = 0xFFFFFFFF


class PairIndex(NamedTuple):
    """Pair bookkeeping for N vehicles."""
    i_idx: torch.Tensor   # (P,) int64, first vehicle of each pair
    j_idx: torch.Tensor   # (P,) int64, second vehicle
    E: torch.Tensor       # (N, P) signed incidence


def make_pair_index(n_vehicles: int, dtype=torch.float32,
                    device=None) -> PairIndex:
    ii, jj = np.triu_indices(n_vehicles, k=1)
    P = len(ii)
    E = np.zeros((n_vehicles, P))
    E[ii, np.arange(P)] = 1.0
    E[jj, np.arange(P)] = -1.0
    return PairIndex(i_idx=torch.as_tensor(ii, dtype=torch.int64,
                                           device=device),
                     j_idx=torch.as_tensor(jj, dtype=torch.int64,
                                           device=device),
                     E=torch.as_tensor(E, dtype=dtype, device=device))


def pairwise_diffs(positions: torch.Tensor, pairs: PairIndex) -> torch.Tensor:
    """(..., N, K, 2) positions -> (..., K, P, 2) differences p_i - p_j."""
    pi = torch.index_select(positions, -3, pairs.i_idx)
    pj = torch.index_select(positions, -3, pairs.j_idx)
    return torch.swapaxes(pi - pj, -3, -2)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer on int64 tensors holding values < 2^32.
    The multiplier is below 2^31, so no product leaves the int64 range."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def degenerate_angles(seed: int, lane_ids: torch.Tensor, it: torch.Tensor,
                      pairs: PairIndex, n_steps: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Uniform angles in [0, 2 pi) of shape (B, K, P), one per (lane, k,
    pair), hashed from (seed, lane id, SCP iteration, pair id, k).

    lane_ids, it: (B,) integer tensors (the scenario id and the lane's
    global SCP iteration).  The pair id is ``i * 65536 + j`` like the JAX
    fold-in, so the draw is a function of the pair, not of its position."""
    dev = lane_ids.device
    h = _mix32(torch.tensor(seed & _M32, dtype=torch.int64, device=dev))
    h = _mix32(h ^ (lane_ids.to(torch.int64) & _M32))
    h = _mix32(h ^ (it.to(torch.int64) & _M32))
    pair_id = pairs.i_idx * 65536 + pairs.j_idx
    h = _mix32(h[:, None] ^ pair_id[None, :])                   # (B, P)
    k = torch.arange(n_steps, dtype=torch.int64, device=dev)
    h = _mix32(h[:, None, :] ^ k[None, :, None])                # (B, K, P)
    return (h >> 8).to(dtype) * (2.0 * math.pi / 2.0 ** 24)


def linearize(prev_positions: torch.Tensor, pairs: PairIndex,
              angle: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Linearization directions eta (..., K, P, 2) and distances (..., K, P)
    about the previous iterate (..., N, K, 2).  Degenerate pairs take the
    direction of ``angle`` (..., K, P) and distance 1."""
    diff = pairwise_diffs(prev_positions, pairs)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    degen = dist < DEGENERATE_EPS
    eta_rand = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    safe_dist = torch.where(degen, torch.ones_like(dist), dist)
    eta = torch.where(degen[..., None], eta_rand.to(diff.dtype),
                      diff / safe_dist[..., None])
    return eta, safe_dist


def check_feasible(positions: torch.Tensor, pairs: PairIndex,
                   min_distance: float) -> torch.Tensor:
    """True iff every pairwise distance is >= R - 0.01 at every timestep:
    (..., N, K, 2) -> bool (...)."""
    diff = pairwise_diffs(positions, pairs)
    dist2 = torch.sum(diff * diff, dim=-1)
    thresh = min_distance - FEAS_SLACK
    return torch.all((dist2 >= thresh * thresh).flatten(-2), dim=-1)


def min_pairwise_distance(positions: torch.Tensor,
                          pairs: PairIndex) -> torch.Tensor:
    """Minimum pairwise distance over all timesteps: (..., N, K, 2) -> (...)."""
    diff = pairwise_diffs(positions, pairs)
    dist2 = torch.sum(diff * diff, dim=-1)
    return torch.sqrt(torch.amin(dist2, dim=(-2, -1)))
