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
package's bits: the same seed gives other scenarios than JAX's PRNG does.

The reference-compatible helpers follow: :func:`generate_positions`,
:func:`minimum_distance`, :func:`print_distance_analysis` and
:func:`visualize_scenario`.
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


def generate_scenario(seed: int, *, n_vehicles: int,
                      min_distance: float = 0.4, max_attempts: int = 1000,
                      dtype=torch.float32, device=None) -> Scenario:
    """One scenario from one seed, without the batch axis: (N, 2) initial
    and final positions and a 0-d ``ok``.  The draws are those of
    :func:`generate_scenario_batch` with batch 1, not the JAX package's for
    the same seed."""
    sc = generate_scenario_batch(seed, 1, n_vehicles=n_vehicles,
                                 min_distance=min_distance,
                                 max_attempts=max_attempts, dtype=dtype,
                                 device=device)
    return Scenario(*(t[0] for t in sc))


# ---------------------------------------------------------------------------
# Reference-compatible functional API (path_planning.generate_positions)
# ---------------------------------------------------------------------------

def generate_positions(n_vehicles, min_distance=0.4, max_attempts=1000,
                       seed=None):
    """Drop-in for the reference ``generate_positions``: ``(initial (N, 2),
    final (N, 2))`` float32 numpy arrays, drawn on the host; ValueError when
    rejection sampling gives up.

    ``seed=None`` draws a fresh seed from numpy's global RNG (repeated calls
    differ, like the reference's unseeded stdlib random); pass an int for
    exact reproducibility.  A seed gives other positions than the JAX
    package's ``generate_positions`` with the same seed (``torch.Generator``
    draws, not JAX's PRNG).
    """
    if seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    sc = generate_scenario(seed, n_vehicles=n_vehicles,
                           min_distance=float(min_distance),
                           max_attempts=int(max_attempts), device="cpu")
    if not bool(sc.ok):
        raise ValueError("Could not generate enough positions.")
    return sc.initial.numpy(), sc.final.numpy()


# ---------------------------------------------------------------------------
# Scenario analysis
# ---------------------------------------------------------------------------

def visualize_scenario(initial_positions, final_positions, min_distance=0.4,
                       save_path=None, show=False):
    """Drop-in for the reference ``visualize_scenario``; delegates to the
    viz layer (matplotlib)."""
    from ..viz.plots import plot_scenario
    return plot_scenario(initial_positions, final_positions,
                         min_distance=min_distance, save_path=save_path,
                         show=show)


def minimum_distance(positions: np.ndarray) -> tuple[float, tuple[int, int]]:
    """Min pairwise distance and the closest pair."""
    pos = np.asarray(positions)
    n = len(pos)
    if n < 2:
        return float("inf"), (-1, -1)
    diff = pos[:, None, :] - pos[None, :, :]
    d = np.linalg.norm(diff, axis=-1)
    d[np.arange(n), np.arange(n)] = np.inf
    idx = np.unravel_index(np.argmin(d), d.shape)
    return float(d[idx]), (int(idx[0]), int(idx[1]))


def print_distance_analysis(initial_positions, final_positions):
    """Console summary: global min spacing and longest displacement."""
    init_min, _ = minimum_distance(initial_positions)
    final_min, _ = minimum_distance(final_positions)
    global_min = min(init_min, final_min)
    displacements = np.linalg.norm(
        np.asarray(final_positions) - np.asarray(initial_positions), axis=1)
    longest_path = float(displacements.max())
    longest_vehicle = int(displacements.argmax())
    print("\n" + "=" * 40)
    print("DISTANCE SUMMARY")
    print("=" * 40)
    print(f"Global minimum distance: {global_min:.3f} m")
    print(f"Longest path traveled:  {longest_path:.3f} m "
          f"(Vehicle {longest_vehicle})")
    print("=" * 40 + "\n")
    return dict(global_min_distance=global_min, longest_path=longest_path,
                longest_vehicle=longest_vehicle)
