"""Plots of the port (copies of the JAX package's viz modules).

Matplotlib is imported inside the plotting functions only.
"""

from .boxplot import make_boxplot, load_rows_from_dir, group_times_by_N
from .plots import (plot_trajectories, plot_time_snapshots, plot_scenario,
                    quadrant_colors)

__all__ = ["make_boxplot", "load_rows_from_dir", "group_times_by_N",
           "plot_trajectories", "plot_time_snapshots", "plot_scenario",
           "quadrant_colors"]
