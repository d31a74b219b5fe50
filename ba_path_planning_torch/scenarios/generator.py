"""Randomized scenario generation on a ``torch.Generator`` (counterpart of
``ba_path_planning_tpu.scenarios.generator``).

Same layout and sampling distribution as the JAX package:

  * 20x20 box; 4 corner circles of radius 2.5 centred at (3.5, 3.5) ...
    (16.5, 16.5); a central diamond, the square of side 6 rotated 45 degrees
    about (10, 10);
  * initial positions: a uniform point on the border of a uniformly chosen
    circle;
  * final positions: with probability 0.9 a uniform point on the diamond
    border (uniform edge, uniform t), else a circle-border point;
  * rejection: a candidate is accepted iff it is >= min_distance from every
    point already accepted into its own set; a scenario gives up after
    ``max_attempts`` candidates per set.

The whole batch runs the rejection loop in lockstep on the host, one
candidate per scenario and attempt; the draws come from one
``torch.Generator``, so a seed fixes the batch.  They are not the JAX
package's bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import resolve_device

BOX_SIZE = 20.0
CIRCLE_RADIUS = 2.5
DIAMOND_SIDE = 6.0
DIAMOND_CENTER = (10.0, 10.0)
CIRCLE_CENTERS = np.array([[3.5, 3.5], [16.5, 3.5], [3.5, 16.5],
                           [16.5, 16.5]])
DIAMOND_SIZE = DIAMOND_SIDE / np.sqrt(2.0)
DIAMOND_VERTICES = np.array([
    [DIAMOND_CENTER[0], DIAMOND_CENTER[1] + DIAMOND_SIZE],
    [DIAMOND_CENTER[0] + DIAMOND_SIZE, DIAMOND_CENTER[1]],
    [DIAMOND_CENTER[0], DIAMOND_CENTER[1] - DIAMOND_SIZE],
    [DIAMOND_CENTER[0] - DIAMOND_SIZE, DIAMOND_CENTER[1]],
])
DIAMOND_FINAL_PROB = 0.9


class Scenario(NamedTuple):
    initial: torch.Tensor   # (B, N, 2)
    final: torch.Tensor     # (B, N, 2)
    ok: torch.Tensor        # (B,) bool: False if rejection sampling gave up


def _circle_points(gen: torch.Generator, B: int) -> torch.Tensor:
    which = torch.randint(0, 4, (B,), generator=gen)
    angle = torch.rand(B, generator=gen, dtype=torch.float64) * (2.0 * math.pi)
    centers = torch.as_tensor(CIRCLE_CENTERS)[which]
    return centers + CIRCLE_RADIUS * torch.stack(
        [torch.cos(angle), torch.sin(angle)], dim=-1)


def _diamond_points(gen: torch.Generator, B: int) -> torch.Tensor:
    edge = torch.randint(0, 4, (B,), generator=gen)
    t = torch.rand(B, generator=gen, dtype=torch.float64)
    verts = torch.as_tensor(DIAMOND_VERTICES)
    v1, v2 = verts[edge], verts[(edge + 1) % 4]
    return v1 + t[:, None] * (v2 - v1)


def _final_points(gen: torch.Generator, B: int) -> torch.Tensor:
    on_diamond = torch.rand(B, generator=gen,
                            dtype=torch.float64) < DIAMOND_FINAL_PROB
    return torch.where(on_diamond[:, None], _diamond_points(gen, B),
                       _circle_points(gen, B))


def _fill_positions(gen: torch.Generator, sample_fn, B: int, n_vehicles: int,
                    min_distance: float, max_attempts: int):
    """Sequential rejection fill of one position set per scenario."""
    N = n_vehicles
    pts = torch.full((B, N, 2), 1e6, dtype=torch.float64)
    count = torch.zeros(B, dtype=torch.int64)
    attempts = torch.zeros(B, dtype=torch.int64)
    rows = torch.arange(B)
    slot = torch.arange(N)
    while True:
        active = (count < N) & (attempts < max_attempts)
        if not bool(active.any()):
            break
        cand = sample_fn(gen, B)
        d2 = torch.sum((pts - cand[:, None, :]) ** 2, dim=-1)
        d2 = torch.where(slot[None, :] < count[:, None], d2,
                         torch.full_like(d2, math.inf))
        accept = (torch.amin(d2, dim=-1) >= min_distance * min_distance) \
            & active
        pts[rows[accept], count[accept]] = cand[accept]
        count = count + accept.to(torch.int64)
        attempts = attempts + active.to(torch.int64)
    return pts, count >= N


def generate_scenario_batch(seed: int, batch: int, *, n_vehicles: int,
                            min_distance: float = 0.4,
                            max_attempts: int = 1000, dtype=torch.float32,
                            device=None) -> Scenario:
    """(B, N, 2) initial and final positions from one seed, drawn on the
    host and moved to ``device`` (None: the card)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    init, ok_i = _fill_positions(gen, _circle_points, batch, n_vehicles,
                                 min_distance, max_attempts)
    final, ok_f = _fill_positions(gen, _final_points, batch, n_vehicles,
                                  min_distance, max_attempts)
    return Scenario(initial=init.to(dtype=dtype, device=device),
                    final=final.to(dtype=dtype, device=device),
                    ok=(ok_i & ok_f).to(device))
