"""Standalone scenario tool CLI of the PyTorch port: the reference's
``position-generator`` console script (counterpart of
``ba_path_planning_tpu.cli.position_generator``, the same flags): generate
a random scenario on the host, print the distance analysis, plot the
layout.  A seed gives other positions than the JAX CLI's.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-vehicles", type=int, default=20)
    p.add_argument("--min-distance", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", type=str, default=None,
                   help="save the scenario plot to this path")
    p.add_argument("--show", action="store_true")
    p.add_argument("--no-viz", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..scenarios import generate_positions, print_distance_analysis

    try:
        init_pos, final_pos = generate_positions(
            args.n_vehicles, min_distance=args.min_distance, seed=args.seed)
        print("Generated positions successfully!")
        print_distance_analysis(init_pos, final_pos)
        if not args.no_viz:
            from ..viz.plots import plot_scenario
            plot_scenario(init_pos, final_pos, min_distance=args.min_distance,
                          save_path=args.out, show=args.show)
    except Exception as e:
        print(f"Error: {e}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
