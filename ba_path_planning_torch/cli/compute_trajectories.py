"""Single-scenario demo CLI of the PyTorch port: the reference's
``compute-trajectories`` console script (counterpart of
``ba_path_planning_tpu.cli.compute_trajectories``, the same flags):
construct a planner, generate a random scenario, solve, visualize.

    python -m ba_path_planning_torch.cli.compute_trajectories \\
        --n-vehicles 10 --time-horizon 10 --seed 3 --no-viz

The planner is the reference-compatible ``SCP`` class on its L-only sweep
kernel route (``group_solve_l``), on the card unless ``main`` is given
another ``device``.  ``--no-viz`` runs without matplotlib.  The scenario for
a seed is drawn by ``torch.Generator``, not JAX's PRNG, so it differs from
the JAX CLI's for the same seed.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None, help="YAML config file")
    p.add_argument("--n-vehicles", type=int, default=10)
    p.add_argument("--time-horizon", type=float, default=100.0)
    p.add_argument("--time-step", type=float, default=0.2)
    p.add_argument("--min-distance", type=float, default=0.8)
    p.add_argument("--space-dims", type=float, nargs=4,
                   default=[0.0, 0.0, 20.0, 20.0],
                   metavar=("XMIN", "YMIN", "XMAX", "YMAX"))
    p.add_argument("--max-iterations", type=int, default=15)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--trajectories-out", type=str, default="trajectories.pdf")
    p.add_argument("--snapshots-out", type=str, default=None)
    p.add_argument("--show", action="store_true",
                   help="open matplotlib windows")
    p.add_argument("--no-viz", action="store_true")
    return p


def main(argv=None, *, device=None) -> int:
    """The CLI; ``device`` (None: the card) is for callers in Python."""
    args = build_parser().parse_args(argv)

    import torch

    from ..scenarios import generate_positions, print_distance_analysis
    from ..solvers.scp import REFERENCE_SOLVER, SCP
    from ..utils.config import load_yaml, problem_from_dict, resolve_device

    # the solve below reports its failures and returns 1; a missing card is
    # not one of them
    device = resolve_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: main(..., device='cpu') runs on "
                           "the CPU")

    if args.config:
        cfg = problem_from_dict(load_yaml(args.config))
        n, T, h, R = (cfg.n_vehicles, cfg.time_horizon, cfg.time_step,
                      cfg.min_distance)
        space = list(cfg.space_dims)
        max_iters = cfg.max_iterations
    else:
        n, T, h, R = (args.n_vehicles, args.time_horizon, args.time_step,
                      args.min_distance)
        space = list(args.space_dims)
        max_iters = args.max_iterations

    print("--- WOW Fleet Trajectory Computation (PyTorch engine) ---")
    planner = SCP(n_vehicles=n, time_horizon=T, time_step=h, min_distance=R,
                  space_dims=space, solver=REFERENCE_SOLVER.replace(
                      kernels=True), device=device)

    try:
        init_pos, final_pos = generate_positions(n, R, seed=args.seed)
    except ValueError as e:
        print(f"Scenario generation failed: {e}")
        return 1
    print_distance_analysis(init_pos, final_pos)

    planner.set_initial_states(init_pos)
    planner.set_final_states(final_pos)

    try:
        planner.generate_trajectories(max_iterations=max_iters,
                                      seed=args.seed or 0)
    except Exception as e:  # mirror the reference's catch-and-print
        print(f"Trajectory generation failed: {e}")
        return 1

    res = planner.result
    print(f"Status: {int(res.status)} | SCP iterations: {int(res.iterations)}"
          f" | collision-free: {bool(res.feasible_final)}")

    if not args.no_viz:
        planner.visualize_trajectories(show_animation=args.show,
                                       save_path=args.trajectories_out)
        if args.snapshots_out or args.show:
            planner.visualize_time_snapshots(num_snapshots=5,
                                             save_path=args.snapshots_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
