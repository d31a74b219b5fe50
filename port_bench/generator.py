"""Scenario generator of the benchmark: a frozen copy of the port's
``scenarios/generator.py`` draw (``generate_scenario_batch``), so that a
seed gives the same scenarios whatever later changes the program makes.

A 20 x 20 m box; four circles of radius 2.5 m centred at (3.5, 3.5) ...
(16.5, 16.5), and a diamond, the square of side 6 m turned 45 degrees about
(10, 10).  Start positions are uniform on the border of a uniformly chosen
circle; goals are uniform on the diamond's border with probability 0.9,
else on a circle's.  A candidate joins its set when it is at least
``min_distance`` from every point already in it; a scenario gives up after
``max_attempts`` candidates a set.  The batch draws in lockstep on the host
from one ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CIRCLE_RADIUS = 2.5
CIRCLE_CENTERS = np.array([[3.5, 3.5], [16.5, 3.5], [3.5, 16.5],
                           [16.5, 16.5]])
_D = 6.0 / np.sqrt(2.0)
DIAMOND_VERTICES = np.array([[10.0, 10.0 + _D], [10.0 + _D, 10.0],
                             [10.0, 10.0 - _D], [10.0 - _D, 10.0]])
DIAMOND_FINAL_PROB = 0.9


def _circle_points(gen, B):
    which = torch.randint(0, 4, (B,), generator=gen)
    angle = torch.rand(B, generator=gen, dtype=torch.float64) * (2.0 * math.pi)
    centers = torch.as_tensor(CIRCLE_CENTERS)[which]
    return centers + CIRCLE_RADIUS * torch.stack(
        [torch.cos(angle), torch.sin(angle)], dim=-1)


def _diamond_points(gen, B):
    edge = torch.randint(0, 4, (B,), generator=gen)
    t = torch.rand(B, generator=gen, dtype=torch.float64)
    verts = torch.as_tensor(DIAMOND_VERTICES)
    v1, v2 = verts[edge], verts[(edge + 1) % 4]
    return v1 + t[:, None] * (v2 - v1)


def _final_points(gen, B):
    on_diamond = torch.rand(B, generator=gen,
                            dtype=torch.float64) < DIAMOND_FINAL_PROB
    return torch.where(on_diamond[:, None], _diamond_points(gen, B),
                       _circle_points(gen, B))


def _fill(gen, sample_fn, B, N, min_distance, max_attempts):
    """The lockstep rejection fill of one position set a scenario.  Every
    attempt draws a candidate for all B scenarios, as the program's
    generator does, so the draws are its draws; only the scenarios still
    filling are tested, which spares the work of those that are done."""
    pts = torch.full((B, N, 2), 1e6, dtype=torch.float64)
    count = torch.zeros(B, dtype=torch.int64)
    attempts = torch.zeros(B, dtype=torch.int64)
    slot = torch.arange(N)
    while True:
        rows = torch.nonzero((count < N) & (attempts < max_attempts))[:, 0]
        if rows.numel() == 0:
            break
        cand = sample_fn(gen, B)[rows]
        d2 = torch.sum((pts[rows] - cand[:, None, :]) ** 2, dim=-1)
        d2 = torch.where(slot[None, :] < count[rows, None], d2,
                         torch.full_like(d2, math.inf))
        hit = torch.amin(d2, dim=-1) >= min_distance * min_distance
        acc = rows[hit]
        pts[acc, count[acc]] = cand[hit]
        count[acc] += 1
        attempts[rows] += 1
    return pts, count >= N


def scenario_batch(seed: int, batch: int, n_vehicles: int,
                   min_distance: float, max_attempts: int = 1000):
    """(initial (B, N, 2), final (B, N, 2), ok (B,)) float64 on the host;
    ``ok`` is False where a set gave up."""
    gen = torch.Generator().manual_seed(int(seed))
    init, ok_i = _fill(gen, _circle_points, batch, n_vehicles, min_distance,
                       max_attempts)
    final, ok_f = _fill(gen, _final_points, batch, n_vehicles, min_distance,
                        max_attempts)
    return init, final, ok_i & ok_f
