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

from ..utils.dist import all_reduce
from ..utils.profiling import host_write

DEGENERATE_EPS = 1e-6
FEAS_SLACK = 0.01

_M32 = 0xFFFFFFFF


class PairIndex(NamedTuple):
    """Pair bookkeeping for N vehicles: the dense all-pair index, every
    pair valid (``valid`` is None, as the JAX index's default)."""
    i_idx: torch.Tensor   # (P,) int64, first vehicle of each pair
    j_idx: torch.Tensor   # (P,) int64, second vehicle
    E: torch.Tensor       # (N, P) signed incidence

    @property
    def valid(self) -> None:
        return None


class PaddedPairIndex(NamedTuple):
    """A pair index with a ``valid`` mask (the JAX ``PairIndex`` with
    ``valid`` set): the pair-sharded path (``parallel/pair_sharded.py``)
    pads P up to a multiple of the shard count and marks the pad pairs
    invalid; their E columns are zero (no force contribution), their
    collision bounds -inf (inert rows), and the feasibility checks skip
    them.  Every function that takes a PairIndex takes this."""
    i_idx: torch.Tensor   # (P,) int64
    j_idx: torch.Tensor   # (P,) int64
    E: torch.Tensor       # (N, P)
    valid: torch.Tensor   # (P,) bool


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
    h = _mix32(host_write("scp", seed & _M32, dtype=torch.int64, device=dev))
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


def collision_lower_bounds(eta: torch.Tensor, dist: torch.Tensor,
                           prev_positions: torch.Tensor, p0: torch.Tensor,
                           v0: torch.Tensor, pairs: PairIndex, *, h: float,
                           min_distance) -> torch.Tensor:
    """Right-hand side of each collision row of the acceleration-space QP
    (the CG method), (..., K, P):

        l[k,p] = R + (eta . dprev - dist) - eta . (p0_i - p0_j)
                 - k h eta . (v0_i - v0_j)

    eta, dist (..., K, P(, 2)); prev_positions (..., N, K, 2); p0, v0
    (..., N, 2).  The upper bounds are +inf."""
    dprev = pairwise_diffs(prev_positions, pairs)
    lin_term = torch.sum(eta * dprev, dim=-1) - dist
    dp0 = (torch.index_select(p0, -2, pairs.i_idx)
           - torch.index_select(p0, -2, pairs.j_idx))
    dv0 = (torch.index_select(v0, -2, pairs.i_idx)
           - torch.index_select(v0, -2, pairs.j_idx))
    pos_contrib = torch.sum(eta * dp0[..., None, :, :], dim=-1)
    vel_contrib = torch.sum(eta * dv0[..., None, :, :], dim=-1)
    K = eta.shape[-3]
    k_idx = torch.arange(K, dtype=eta.dtype, device=eta.device).reshape(K, 1)
    return min_distance + lin_term - pos_contrib - h * k_idx * vel_contrib


def _dist2(positions, pairs: PairIndex):
    """Squared pairwise distances (..., K, P), +inf at invalid pairs."""
    diff = pairwise_diffs(positions, pairs)
    dist2 = torch.sum(diff * diff, dim=-1)
    if pairs.valid is not None:
        dist2 = torch.where(pairs.valid, dist2,
                            torch.full_like(dist2, float("inf")))
    return dist2


def check_feasible(positions: torch.Tensor, pairs: PairIndex,
                   min_distance: float, group=None) -> torch.Tensor:
    """True iff every pairwise distance is >= R - 0.01 at every timestep:
    (..., N, K, 2) -> bool (...).  Pad pairs (``pairs.valid``) are skipped;
    ``group``: the pairs are this rank's share, and the answer is the AND
    over the group (JAX's ``pmin`` over a pair-sharded axis)."""
    thresh = min_distance - FEAS_SLACK
    ok = torch.all((_dist2(positions, pairs) >= thresh * thresh)
                   .flatten(-2), dim=-1)
    return all_reduce(ok, "min", group)


def min_pairwise_distance(positions: torch.Tensor, pairs: PairIndex,
                          group=None) -> torch.Tensor:
    """Minimum pairwise distance over all timesteps: (..., N, K, 2) -> (...),
    pad pairs skipped, the minimum over ``group`` where the pairs are
    sharded."""
    out = torch.amin(_dist2(positions, pairs), dim=(-2, -1))
    return torch.sqrt(all_reduce(out, "min", group))
