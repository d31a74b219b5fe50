"""``plot-collisions``: collision-analysis plot over a solved scenario batch
(counterpart of ``ba_path_planning_tpu.viz.plot_collisions``: the same flags,
defaults and figure).

    python -m ba_path_planning_torch.viz.plot_collisions --trials 32

Solves a seeded batch of scenarios on the card and draws the collision
picture the solver enforces:

* per-timestep minimum pairwise distance (median and min/max band across
  the batch) against the safety radius R and the checker's R - 0.01 line;
* a histogram of each scenario's closest approach, split by solver status.

The scenarios are the port's ``torch.Generator`` draws, not the JAX CLI's
for the same seed.  Matplotlib is imported inside the plotting function.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def collision_profile(positions, pairs=None):
    """(B, N, K, 2) trajectories -> (B, K) minimum pairwise distance per
    step, a tensor on the positions' device and in their dtype."""
    import torch

    from ..ops.collisions import make_pair_index, pairwise_diffs

    positions = torch.as_tensor(positions)
    if pairs is None:
        pairs = make_pair_index(positions.shape[-3], dtype=positions.dtype,
                                device=positions.device)
    d = pairwise_diffs(positions, pairs)             # (B, K, P, 2)
    return torch.amin(torch.linalg.vector_norm(d, dim=-1), dim=-1)


def plot_collision_analysis(profiles, min_distance, feasible, time_step,
                            out_path, title=None):
    """Render the two-panel collision analysis of numpy ``profiles``
    (B, K) to ``out_path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    profiles = np.asarray(profiles)
    B, K = profiles.shape
    t = np.arange(K) * time_step
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))

    med = np.median(profiles, axis=0)
    ax1.fill_between(t, profiles.min(axis=0), profiles.max(axis=0),
                     alpha=0.25, color="tab:blue", label="min-max band")
    ax1.plot(t, med, color="tab:blue", lw=1.8, label="median")
    ax1.axhline(min_distance, color="tab:red", lw=1.2, label="R (safety)")
    ax1.axhline(min_distance - 0.01, color="tab:red", lw=0.8, ls="--",
                label="R - 0.01 (checker tol)")
    ax1.set_xlabel("time [s]")
    ax1.set_ylabel("min pairwise distance [m]")
    ax1.set_title(f"Closest pair over time ({B} scenarios)")
    ax1.legend(fontsize=8)
    ax1.grid(alpha=0.3)

    closest = profiles.min(axis=1)
    bins = np.linspace(min(closest.min(), min_distance - 0.05),
                       closest.max(), 30)
    feas = np.asarray(feasible, dtype=bool)
    ax2.hist(closest[feas], bins=bins, alpha=0.7, color="tab:green",
             label=f"collision-free ({int(feas.sum())})")
    if (~feas).any():
        ax2.hist(closest[~feas], bins=bins, alpha=0.7, color="tab:orange",
                 label=f"violating ({int((~feas).sum())})")
    ax2.axvline(min_distance, color="tab:red", lw=1.2)
    ax2.axvline(min_distance - 0.01, color="tab:red", lw=0.8, ls="--")
    ax2.set_xlabel("closest approach over horizon [m]")
    ax2.set_ylabel("scenarios")
    ax2.set_title("Closest-approach distribution")
    ax2.legend(fontsize=8)
    ax2.grid(alpha=0.3)

    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)
    plt.close(fig)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-vehicles", type=int, default=10)
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--min-distance", type=float, default=0.8)
    ap.add_argument("--time-horizon", type=float, default=10.0)
    ap.add_argument("--time-step", type=float, default=0.2)
    ap.add_argument("--max-iterations", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-path", type=str, default="collision_analysis.png")
    return ap


def analyse(args, device=None):
    """Solve ``args.trials`` seeded scenarios with the production solver on
    ``device`` (None: the card), in float32: ``solve_compacted`` in chunks
    of min(B, 128) where they divide B, else the uncompacted ``solve``.
    Returns (problem, result, profiles (B, K) tensor on the device)."""
    import torch

    from ..parallel.mesh import ShardedSCPSolver
    from ..scenarios import generate_scenario_batch
    from ..utils.config import ProblemConfig, SolverConfig

    problem = ProblemConfig(n_vehicles=args.n_vehicles,
                            time_horizon=args.time_horizon,
                            time_step=args.time_step,
                            min_distance=args.min_distance,
                            max_iterations=args.max_iterations,
                            stop_mode="feasible")
    B = max(args.trials, 1)
    sh = ShardedSCPSolver(problem, SolverConfig.production(problem=problem),
                          dtype=torch.float32, device=device)
    sc = generate_scenario_batch(args.seed, B, n_vehicles=args.n_vehicles,
                                 min_distance=args.min_distance,
                                 device=sh.engine.device)
    v0 = torch.zeros_like(sc.initial)
    chunk = min(B, 128)
    out = (sh.solve_compacted(sc.initial, v0, sc.final, v0, chunk=chunk)
           if B % chunk == 0 else sh.solve(sc.initial, v0, sc.final, v0))
    return problem, out, collision_profile(out.positions)


def main(argv=None, *, device=None) -> int:
    """The CLI; ``device`` (None: the card) is for callers in Python."""
    args = build_parser().parse_args(argv)

    import torch

    from ..utils.config import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: main(..., device='cpu') runs on "
                           "the CPU")
    problem, out, profiles = analyse(args, device)
    profiles = profiles.cpu().numpy()
    feas = out.feasible_final.cpu().numpy()
    print(f"{int(feas.sum())}/{len(feas)} collision-free; global closest "
          f"approach {profiles.min():.3f} m (R = {args.min_distance})")
    plot_collision_analysis(profiles, args.min_distance, feas,
                            args.time_step, args.out_path,
                            title=f"N={args.n_vehicles}, "
                                  f"K={problem.n_steps}, R="
                                  f"{args.min_distance}")
    print(f"Saved plot: {args.out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
